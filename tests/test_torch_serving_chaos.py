"""The serving chaos matrix over the port's wire front-end: the
``ChaosProxy`` (the port's copy, serving protocol) and client deaths
against dense, speculative and paged engines behind the port's
``ServingServer``, once per transport core.

The contract pinned here (the chaos legs of
``tests/test_serving_resilience.py`` on the port): for every scripted
fault at an exact (connection, opcode) point — a reset at the enqueue, a
torn enqueue frame, a stream cut after two chunks, a delay — the affected
request's slot (and, paged, its blocks; speculative, its draft rows) is
reclaimed, no handle or handle-table entry leaks, and an unaffected
concurrent request stays bit-identical to ``generate``; a client that
dies mid-chunked-prefill or stalls past its deadline is reclaimed too.
The supervisor legs wait for the supervisors' slice (ROADMAP queue A
item 4).
"""

import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.networking import ChaosFault, ChaosProxy
from distkeras_tpu_torch.serving import (QueueFull, ServingClient,
                                         ServingEngine, ServingServer)
from test_torch_serving_wire import (OTHER, PROMPT, VOCAB,  # noqa: F401
                                     _assert_slots_reclaimed, _hard_close,
                                     _stream_row, _wait_for, _want, models,
                                     server_core)

torch.set_num_threads(1)

LONG_PROMPT = (np.arange(1, 13, dtype=np.int32) * 3) % VOCAB  # 12 tokens


@pytest.fixture(scope="module")
def fitted(models):
    return models[1]


def _spec_engine(fitted, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 24)
    return ServingEngine(fitted, spec_draft=fitted, spec_len=3, **kw)


def _paged_engine(fitted, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 24)
    kw.setdefault("block_size", 4)
    return ServingEngine(fitted, paged=True, **kw)


def _assert_no_block_leaks(eng):
    assert eng.kv_blocks_in_use == 0, (
        f"leaked {eng.kv_blocks_in_use} blocks")
    assert eng._pool.check_conservation()
    assert not eng._plans


def _assert_server_clean(srv, eng):
    assert _wait_for(lambda: not eng._active.any())
    assert _wait_for(lambda: srv.live_connections == 0)
    _assert_slots_reclaimed(eng)
    assert _wait_for(lambda: not srv._handles and not srv._owner)


def test_disconnect_mid_chunked_prefill_reclaims(fitted, server_core):
    """A client that dies while its request is mid-chunked-prefill: the
    disconnect reclamation cancels it, the scheduler aborts the prefill
    and frees the slot; no handle or slot leaks."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24, prefill_chunk=4)
    started, release = threading.Event(), threading.Event()
    orig = eng._advance_chunk

    def gated(slot):
        started.set()
        release.wait(10.0)  # hold the prefill mid-flight
        orig(slot)

    eng._advance_chunk = gated
    try:
        with ServingServer(eng) as srv:
            c = ServingClient(*srv.addr)
            c.submit(LONG_PROMPT, 4)
            assert started.wait(10.0)
            _hard_close(c.sock)  # RST while the prefill is gated
            assert _wait_for(lambda: srv.disconnect_cancels >= 1)
            release.set()
            assert _wait_for(lambda: eng.stats["requests_cancelled"] >= 1)
            assert _wait_for(lambda: not eng._prefilling
                             and sorted(eng._free) == [0])
    finally:
        release.set()
    assert all(h is None for h in eng._handles)
    assert not srv._handles and not srv._owner


def test_chaos_proxy_serving_clean_relay(fitted, server_core):
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    with ServingServer(eng, poll_s=0.01) as srv:
        with ChaosProxy(*srv.addr, protocol="serving") as px:
            with ServingClient(*px.addr) as c:
                np.testing.assert_array_equal(
                    c.generate(PROMPT, 8, temperature=0.6, seed=3),
                    _want(fitted, PROMPT, 8, temperature=0.6, seed=3))


def _faulted_beside_healthy(eng, fitted, fault, want_other, kw_other):
    """Run one faulted request through the proxy beside a healthy one
    straight at the server; returns the faulted outcome."""
    with ServingServer(eng, poll_s=0.01) as srv:
        with ChaosProxy(*srv.addr, protocol="serving",
                        faults=[fault]) as px:
            faulted = ServingClient(*px.addr)
            healthy = ServingClient(*srv.addr)  # bypasses the proxy
            rid_h = healthy.submit(OTHER, 10, **kw_other)
            row, outcome = None, None
            try:
                row = faulted.generate(PROMPT, 16)
                outcome = "completed"
            except (ConnectionError, OSError, ValueError, QueueFull):
                outcome = "faulted"
            assert px.injected == [(0, fault.op_index, fault.action)]
            np.testing.assert_array_equal(_stream_row(healthy, rid_h)["row"],
                                          want_other)
            faulted.close()
            healthy.close()
        _assert_server_clean(srv, eng)
    return outcome, row


@pytest.mark.parametrize("fault", [
    ChaosFault(0, 0, "reset"),        # request dropped + RST at 'q'
    ChaosFault(0, 0, "tear"),         # half the enqueue frame, then RST
    ChaosFault(0, 1, "cut_stream", 2),  # RST mid-stream after 2 chunks
    ChaosFault(0, 0, "delay", 0.05),  # delayed but successful
])
def test_chaos_matrix_slot_reclaimed_others_bit_identical(fitted, fault,
                                                          server_core):
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    kw = dict(temperature=0.6, seed=5)
    outcome, row = _faulted_beside_healthy(
        eng, fitted, fault, _want(fitted, OTHER, 10, **kw), kw)
    if fault.action == "delay":
        assert outcome == "completed"
        np.testing.assert_array_equal(row, _want(fitted, PROMPT, 16))
    else:
        assert outcome == "faulted"


def test_chaos_client_stall_reclaims_via_deadline(fitted, server_core):
    """A client that submits and never streams cannot pin a slot past the
    request deadline; its late stream tells it why."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24,
                        default_deadline_s=0.3)
    # pace the decode (timing only, never token values): this engine runs
    # the stalled request's 16 steps well inside its deadline otherwise
    orig_decode = eng._decode_once

    def paced_decode():
        time.sleep(0.04)
        return orig_decode()

    eng._decode_once = paced_decode
    with ServingServer(eng, poll_s=0.01) as srv:
        stalled = ServingClient(*srv.addr)
        rid = stalled.submit(PROMPT, 16)
        with ServingClient(*srv.addr) as c:
            np.testing.assert_array_equal(
                c.generate(OTHER, 6, deadline_s=30.0),
                _want(fitted, OTHER, 6))
        assert eng.stats["requests_expired"] >= 1
        _assert_slots_reclaimed(eng)
        final = _stream_row(stalled, rid)
        assert final["finish"] == "deadline"
        assert final["row"].shape == (len(PROMPT) + 16,)
        stalled.close()


def test_disconnect_mid_round_reclaims_speculating_slot(fitted, server_core):
    eng = _spec_engine(fitted)
    with ServingServer(eng, poll_s=0.01) as srv:
        c = ServingClient(*srv.addr)
        rid = c.submit(PROMPT, 16)
        gen = c.stream(rid)
        next(gen)
        _hard_close(c.sock)
        assert _wait_for(lambda: eng.stats["requests_cancelled"] >= 1)
        assert _wait_for(lambda: not eng._active.any())
        assert srv.disconnect_cancels >= 1
        with ServingClient(*srv.addr) as c2:
            np.testing.assert_array_equal(c2.generate(OTHER, 10),
                                          _want(fitted, OTHER, 10))
        _assert_slots_reclaimed(eng)
        with srv._hlock:
            assert rid not in srv._handles and rid not in srv._owner


@pytest.mark.parametrize("fault", [
    ChaosFault(0, 0, "reset"),
    ChaosFault(0, 1, "cut_stream", 2),
])
def test_chaos_matrix_under_speculation(fitted, fault, server_core):
    outcome, _ = _faulted_beside_healthy(
        _spec_engine(fitted), fitted, fault, _want(fitted, OTHER, 10), {})
    assert outcome == "faulted"


def test_paged_disconnect_and_drain_zero_block_leaks(fitted, server_core):
    eng = _paged_engine(fitted)
    with ServingServer(eng, poll_s=0.01) as srv:
        c = ServingClient(*srv.addr)
        rid = c.submit(PROMPT, 16)
        gen = c.stream(rid)
        next(gen)
        _hard_close(c.sock)
        assert _wait_for(lambda: eng.stats["requests_cancelled"] >= 1)
        assert _wait_for(lambda: not eng._active.any())
        with ServingClient(*srv.addr) as c2:
            np.testing.assert_array_equal(c2.generate(OTHER, 10),
                                          _want(fitted, OTHER, 10))
        _assert_slots_reclaimed(eng)
        assert _wait_for(lambda: eng.kv_blocks_in_use == 0)
        _assert_no_block_leaks(eng)
        with srv._hlock:
            assert rid not in srv._handles
    eng = _paged_engine(fitted)
    h = eng.submit(PROMPT, 6)
    assert eng.drain(timeout=30.0)
    assert h.finish == "length"
    _assert_no_block_leaks(eng)


@pytest.mark.parametrize("fault", [
    ChaosFault(0, 0, "reset"),
    ChaosFault(0, 1, "cut_stream", 2),
])
def test_paged_chaos_matrix_survivors_bit_identical(fitted, fault,
                                                    server_core):
    eng = _paged_engine(fitted)
    kw = dict(temperature=0.6, seed=5)
    outcome, _ = _faulted_beside_healthy(
        eng, fitted, fault, _want(fitted, OTHER, 10, **kw), kw)
    assert outcome == "faulted"
    assert _wait_for(lambda: eng.kv_blocks_in_use == 0)
    _assert_no_block_leaks(eng)
