"""The port's serving wire front-end (``ServingServer``, both transport
cores, and ``ServingClient``) against offline ``generate`` and the JAX
package's wire.

The contract pinned here, on the JAX serving tests' tiny LM (vocab 17,
seq 32, d_model 16, 2 heads, 2 layers, f32), one numpy weight set in both
packages:

 - a streamed request's chunks and final row equal ``generate``'s;
   backpressure, a bad request and an unknown id come back typed (the
   wire cases of ``tests/test_serving.py``);
 - cancel by opcode and mid-stream on the same socket, a client that
   dies mid-stream or after submitting, a half frame, a wedged engine's
   typed ``"stall"`` frame, drain over the wire and an enqueue pipelined
   behind a stream end as the JAX server's do, with every slot and
   handle entry reclaimed (the wire legs of
   ``tests/test_serving_resilience.py``; the port has one codec);
 - tenant, priority and quota ride the ``'q'`` frame, and a client that
   dies while its request is swapped out is reclaimed (the wire leg of
   ``tests/test_serving_qos.py``);
 - across the packages: a JAX ``ServingClient`` submits, streams,
   cancels and probes ``load()`` against a port ``ServingServer``, and a
   port client against a JAX server, with equal rows and the same typed
   rejections.

Every wire test runs once per core (the ``server_core`` fixture here, over
the port's server; ``tests/conftest.py``'s fixture rebinds the JAX one).
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import distkeras_tpu.serving as jserving
import distkeras_tpu_torch.serving as pserving
from distkeras_tpu_torch import networking
from distkeras_tpu_torch.serving import (Draining, EngineDead, QueueFull,
                                         QuotaExceeded, ServingClient,
                                         ServingEngine, ServingServer,
                                         TenantPolicy)
from test_torch_serving_fastpath import both

torch.set_num_threads(1)

VOCAB = 17
PROMPT = np.array([3, 4, 5, 6], np.int32)
OTHER = np.array([7, 8, 9], np.int32)


@pytest.fixture(params=["threaded", "event"])
def server_core(request, monkeypatch):
    """Run a wire test once per transport core of the PORT's
    ``ServingServer``: the fixture rebinds the constructor's default, so
    explicit ``server_core=`` arguments still win."""
    core = request.param
    orig = pserving.ServingServer.__init__

    def _init(self, *args, **kw):
        kw.setdefault("server_core", core)
        orig(self, *args, **kw)

    monkeypatch.setattr(pserving.ServingServer, "__init__", _init)
    return core


@pytest.fixture(scope="module")
def models():
    return both()


@pytest.fixture(scope="module")
def fitted(models):
    return models[1]


def _want(fitted, prompt, steps, max_len=24, **kw):
    """The port's ``generate`` row of one request (``seed`` as its
    key)."""
    seed = kw.pop("seed", None)
    if seed is not None:
        kw["rng"] = seed
    return fitted.generate(prompt[None], steps, max_len=max_len,
                           **kw).numpy()[0]


def _hard_close(sock):
    """RST (SO_LINGER=0): the signature of a killed client process."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
    sock.close()


def _wedge(engine):
    """Wedge an engine's decode step on an event (released by the
    returned callable; always call it in teardown)."""
    ev = threading.Event()
    engine._decode_once = lambda: ev.wait(120.0)
    return ev.set


def _wait_for(pred, timeout=10.0, interval=0.005):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(interval)
    return True


def _assert_slots_reclaimed(engine):
    assert _wait_for(lambda: sorted(engine._free)
                     == list(range(engine.num_slots)))
    assert not engine._active.any()
    assert all(h is None for h in engine._handles)


def _stream_row(client, rid):
    final = None
    for _, done in client.stream(rid):
        if done is not None:
            final = done
    return final


# ---------------------------------------------------------------------------
# the wire cases of tests/test_serving.py
# ---------------------------------------------------------------------------

def test_wire_server_roundtrip_and_streaming(fitted, server_core):
    with ServingServer(ServingEngine(fitted, num_slots=2, max_len=24)) as srv:
        with ServingClient(*srv.addr) as c:
            rid = c.submit(PROMPT, 6, temperature=0.7, top_k=5, seed=11)
            chunks, final = [], None
            for tokens, done in c.stream(rid):
                chunks.append(tokens)
                if done is not None:
                    final = done
            want = _want(fitted, PROMPT, 6, temperature=0.7, top_k=5,
                         seed=11)
            np.testing.assert_array_equal(final["row"], want)
            np.testing.assert_array_equal(np.concatenate(chunks),
                                          want[len(PROMPT):])
            assert final["finish"] == "length"
            np.testing.assert_array_equal(c.generate(PROMPT, 6),
                                          _want(fitted, PROMPT, 6))


def test_wire_server_backpressure_reply(fitted, server_core):
    eng = ServingEngine(fitted, num_slots=1, max_len=24, queue_capacity=1)
    with ServingServer(eng) as srv:
        with ServingClient(*srv.addr) as c:
            with pytest.raises(QueueFull):
                for _ in range(200):
                    c.submit(PROMPT, 12)
    assert eng.stats["requests_rejected"] >= 1


def test_wire_server_bad_request_reply(fitted, server_core):
    with ServingServer(ServingEngine(fitted, num_slots=1, max_len=16)) as srv:
        with ServingClient(*srv.addr) as c:
            with pytest.raises(ValueError, match="max_len"):
                c.submit(np.arange(12, dtype=np.int32) % VOCAB, 12)
            with pytest.raises(ValueError, match="unknown id"):
                list(c.stream(999))


# ---------------------------------------------------------------------------
# the wire legs of tests/test_serving_resilience.py
# ---------------------------------------------------------------------------

def test_cancel_wire_opcode_and_finish_reason(fitted, server_core):
    with ServingServer(ServingEngine(fitted, num_slots=1, max_len=24),
                       poll_s=0.01) as srv:
        with ServingClient(*srv.addr) as c:
            rid = c.submit(PROMPT, 16)
            assert c.cancel(rid) is True
            final = _stream_row(c, rid)
            assert final["finish"] == "cancel"
            assert final["row"].shape == (len(PROMPT) + 16,)
            assert c.cancel(999) is False  # unknown id: not cancelled
    assert srv.engine.stats["requests_cancelled"] == 1


def test_midstream_cancel_same_socket(fitted, server_core):
    """A cancel sent on the same socket mid-stream is consumed between
    chunk frames (unacked); the final frame carries the reason."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    with ServingServer(eng, poll_s=0.01) as srv:
        with ServingClient(*srv.addr) as c:
            rid = c.submit(PROMPT, 16)
            gen = c.stream(rid)
            next(gen)
            c.cancel(rid, await_ack=False)
            final = None
            for _, done in gen:
                if done is not None:
                    final = done
            assert final["finish"] in ("cancel", "length")
        _assert_slots_reclaimed(eng)


def test_client_disconnect_mid_stream_reclaims_slot(fitted, server_core):
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    with ServingServer(eng, poll_s=0.01) as srv:
        c = ServingClient(*srv.addr)
        rid = c.submit(PROMPT, 16)
        gen = c.stream(rid)
        next(gen)           # one chunk, then the client dies
        _hard_close(c.sock)
        assert _wait_for(lambda: eng.stats["requests_cancelled"] >= 1)
        assert _wait_for(lambda: not eng._active.any())
        assert srv.disconnect_cancels >= 1
        assert _wait_for(lambda: srv.live_connections == 0)
        with ServingClient(*srv.addr) as c2:
            np.testing.assert_array_equal(c2.generate(OTHER, 10),
                                          _want(fitted, OTHER, 10))
        _assert_slots_reclaimed(eng)
        with srv._hlock:
            assert rid not in srv._handles and rid not in srv._owner


def test_submit_then_die_reclaims_ownership(fitted, server_core):
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    with ServingServer(eng, poll_s=0.01) as srv:
        doomed = ServingClient(*srv.addr)
        doomed.submit(PROMPT, 16)
        with ServingClient(*srv.addr) as healthy:
            rid = healthy.submit(OTHER, 10, temperature=0.6, seed=5)
            _hard_close(doomed.sock)
            np.testing.assert_array_equal(
                _stream_row(healthy, rid)["row"],
                _want(fitted, OTHER, 10, temperature=0.6, seed=5))
        assert _wait_for(lambda: eng.stats["requests_cancelled"] >= 1)
        _assert_slots_reclaimed(eng)
        assert _wait_for(lambda: not srv._handles and not srv._owner)


def test_half_frame_disconnect_sheds_connection(fitted, server_core):
    """Half a request frame then RST (through the port's one codec): the
    connection is shed, nothing reaches the engine, which keeps
    serving."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    with ServingServer(eng) as srv:
        raw = networking.connect(*srv.addr)
        frame = networking.encode_message(
            {"prompt": PROMPT, "num_steps": 8})
        networking.send_opcode(raw, networking.SERVING_OP_ENQUEUE)
        raw.sendall(bytes(frame)[:len(frame) // 2])
        _hard_close(raw)
        assert _wait_for(
            lambda: srv.disconnects + srv.protocol_errors >= 1)
        assert _wait_for(lambda: srv.live_connections == 0)
        assert eng.stats["requests_submitted"] == 0
        with ServingClient(*srv.addr) as c:
            np.testing.assert_array_equal(c.generate(PROMPT, 6),
                                          _want(fitted, PROMPT, 6))


def test_stalled_engine_sends_typed_error_frame(fitted, server_core):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    release = _wedge(eng)
    try:
        with ServingServer(eng, poll_s=0.02, stream_timeout_s=0.3) as srv:
            with ServingClient(*srv.addr) as c:
                rid = c.submit(PROMPT, 8)
                t0 = time.monotonic()
                with pytest.raises(EngineDead, match="stall|progress"):
                    for _ in c.stream(rid):
                        pass
                assert time.monotonic() - t0 < 5.0
                assert c.cancel(rid) in (True, False)
            release()  # unwedge before the server stops the engine
    finally:
        release()


def test_drain_over_the_wire_is_typed(fitted, server_core):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    with ServingServer(eng) as srv:
        with ServingClient(*srv.addr) as c:
            np.testing.assert_array_equal(c.generate(PROMPT, 4),
                                          _want(fitted, PROMPT, 4))
            assert eng.drain(timeout=60.0) is True
            with pytest.raises(Draining):
                c.submit(PROMPT, 4)


def test_pipelined_enqueue_mid_stream_keeps_connection(fitted, server_core):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    with ServingServer(eng, poll_s=0.01) as srv:
        with ServingClient(*srv.addr) as c:
            rid = c.submit(PROMPT, 8)
            networking.send_opcode(c.sock, networking.SERVING_OP_STREAM)
            networking.send_data(c.sock, {"id": rid})
            networking.send_opcode(c.sock, networking.SERVING_OP_ENQUEUE)
            networking.send_data(c.sock, {"prompt": OTHER, "num_steps": 4})
            final = None
            while final is None:
                reply = networking.recv_data(c.sock)
                assert not reply.get("error"), reply
                if reply["done"]:
                    final = reply
            assert final["finish"] == "length"
            np.testing.assert_array_equal(
                np.array(final["row"], np.int32), _want(fitted, PROMPT, 8))
            ack = networking.recv_data(c.sock)
            assert ack.get("ok") and "id" in ack
            np.testing.assert_array_equal(
                _stream_row(c, int(ack["id"]))["row"],
                _want(fitted, OTHER, 4))
        assert eng.stats["requests_cancelled"] == 0


# ---------------------------------------------------------------------------
# the wire leg of tests/test_serving_qos.py
# ---------------------------------------------------------------------------

QOS_GREEDY = dict(prompt=np.array([3, 4, 5, 6], np.int32), num_steps=8)
QOS_BULK = dict(prompt=np.arange(1, 7, dtype=np.int32), num_steps=18,
                temperature=0.8, seed=7)


def test_wire_tenant_priority_quota_and_disconnect(fitted, server_core):
    eng = ServingEngine(fitted, paged=True, num_slots=2, max_len=32,
                        block_size=4, kv_blocks=30, tenants=[
                            TenantPolicy("bulk", tier="batch"),
                            TenantPolicy("live", tier="interactive"),
                            TenantPolicy("metered", rate=0.001, burst=1.0)])
    with ServingServer(eng) as srv:
        with ServingClient(*srv.addr) as c:
            rid = c.submit(tenant="live", priority=3, **QOS_GREEDY)
            h = srv._handles[rid]
            assert (h.tenant, h.priority) == ("live", 3)
            np.testing.assert_array_equal(
                _stream_row(c, rid)["row"],
                _want(fitted, QOS_GREEDY["prompt"], 8, max_len=32))
            rid_m = c.submit(tenant="metered", **QOS_GREEDY)
            with pytest.raises(QuotaExceeded):
                c.submit(tenant="metered", **QOS_GREEDY)
            assert eng.stats["tenants"]["metered"]["quota_refused"] == 1
            assert _wait_for(lambda: srv._handles[rid_m].finish is not None,
                             timeout=60.0)
        # disconnect while suspended: the dead client's swapped-out
        # request is cancelled, its record dropped, no block leaked.  The
        # decode is paced while the preempt is armed, and the resume held
        # back while the client dies (a free slot would resume the request
        # within one iteration on this fast engine; timing only, never
        # token values)
        c2 = ServingClient(*srv.addr)
        orig_decode = eng._decode_once
        orig_resume = eng._resume_suspended

        def paced_decode():
            time.sleep(0.02)
            return orig_decode()

        eng._decode_once = paced_decode
        eng._resume_suspended = lambda rec: False
        try:
            rid2 = c2.submit(tenant="bulk", **QOS_BULK)
            h2 = srv._handles[rid2]
            assert _wait_for(lambda: len(h2.tokens) >= 2, timeout=60.0)
            assert eng.preempt(h2)
            assert _wait_for(lambda: rid2 in eng._suspended, timeout=60.0)
            c2.close()
            assert _wait_for(lambda: h2.finish is not None, timeout=60.0)
        finally:
            eng._decode_once = orig_decode
            eng._resume_suspended = orig_resume
        assert h2.finish == "cancel"
        assert _wait_for(lambda: not eng._suspended, timeout=60.0)
        assert eng.kv_blocks_in_use == 0
        assert srv.disconnect_cancels == 1


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _client_session(client_mod, addr, errors):
    """One client session against a server of the other package: stream a
    sampled and a greedy row, cancel one request mid-queue, probe the
    load, and collect the typed rejections (bad request, unknown id,
    backpressure).  Returns what it saw."""
    out = {}
    with client_mod.ServingClient(*addr) as c:
        rid = c.submit(PROMPT, 6)
        out["greedy"] = _stream_row(c, rid)
        rid = c.submit(OTHER, 5, temperature=0.7, top_k=5, seed=11)
        out["sampled"] = _stream_row(c, rid)
        rid = c.submit(PROMPT, 16)
        out["cancelled"] = c.cancel(rid)
        out["cancel_final"] = _stream_row(c, rid)
        out["load"] = c.load()
        for what, call in (
                ("bad_request", lambda: c.submit(
                    np.arange(20, dtype=np.int32) % VOCAB, 12)),
                ("unknown_id", lambda: list(c.stream(999)))):
            try:
                call()
            except Exception as e:  # collected and compared below
                errors[what] = type(e).__name__
    return out


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_wire_interop_rows_cancel_load_and_typed_rejections(
        models, direction, server_core):
    """A JAX client against a port server and a port client against a JAX
    server: greedy rows equal on both packages, sampled rows equal the
    serving package's ``generate``, cancels and the load probe work, and
    rejections come back as the same typed exceptions."""
    jf, pf = models
    if direction == "jax_client_port_server":
        client_mod, eng = jserving, pserving.ServingEngine(
            pf, num_slots=2, max_len=24)
        server = pserving.ServingServer(eng, poll_s=0.01)
    else:
        client_mod, eng = pserving, jserving.ServingEngine(
            jf, num_slots=2, max_len=24)
        server = jserving.ServingServer(eng, poll_s=0.01,
                                        server_core=server_core)
    errors = {}
    with server as srv:
        seen = _client_session(client_mod, srv.addr, errors)
    greedy = np.asarray(jf.generate(PROMPT[None], 6, max_len=24))[0]
    np.testing.assert_array_equal(seen["greedy"]["row"], greedy)
    np.testing.assert_array_equal(seen["greedy"]["row"],
                                  _want(pf, PROMPT, 6))
    assert seen["greedy"]["finish"] == "length"
    if direction == "jax_client_port_server":
        np.testing.assert_array_equal(
            seen["sampled"]["row"],
            _want(pf, OTHER, 5, temperature=0.7, top_k=5, seed=11))
    assert seen["cancelled"] is True
    assert seen["cancel_final"]["finish"] in ("cancel", "length")
    assert seen["cancel_final"]["row"].shape == (len(PROMPT) + 16,)
    ref_load = jserving.ServingEngine(jf, num_slots=2, max_len=24).load()
    assert set(seen["load"]) == set(ref_load)
    assert seen["load"]["slots_total"] == 2
    assert errors == {"bad_request": "ValueError",
                      "unknown_id": "ValueError"}
    assert eng.stats["requests_completed"] == 3   # cancels included


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_wire_interop_backpressure_and_draining_typed(models, direction):
    """Backpressure and draining cross the packages as the same typed
    exceptions."""
    jf, pf = models
    if direction == "jax_client_port_server":
        client_mod = jserving
        eng = pserving.ServingEngine(pf, num_slots=1, max_len=24,
                                     queue_capacity=1)
        server = pserving.ServingServer(eng, poll_s=0.01)
    else:
        client_mod = pserving
        eng = jserving.ServingEngine(jf, num_slots=1, max_len=24,
                                     queue_capacity=1)
        server = jserving.ServingServer(eng, poll_s=0.01)
    with server as srv:
        with client_mod.ServingClient(*srv.addr) as c:
            with pytest.raises(client_mod.QueueFull):
                for _ in range(200):
                    c.submit(PROMPT, 12)
            assert eng.drain(timeout=60.0) is True
            with pytest.raises(client_mod.Draining):
                c.submit(PROMPT, 4)
    assert eng.stats["requests_rejected"] >= 1
