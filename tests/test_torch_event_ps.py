"""The cases of tests/test_event_ps.py on the port's event-driven PS core:
drain coalescing correctness and ordering rules, the live server's drain
groupings (an apply gate wedges the loop mid-drain; the port's
``ChaosProxy`` delays a commit into a later drain), the server-core knobs
through the trainers, and the ``FrameParser`` over PS commit frames.
Where the JAX file sleeps to let commits reach the server's socket
buffers, these cases rely on loopback delivery being done when
``sendall`` returns and wait only for states.

The JAX file's description follows.

The contract under test (docs/host_ps.md, "Event loop + coalescing"):

 - DOWNPOUR (and every commute-by-sum rule): a coalesced drain is
   BIT-equal to the same commits applied sequentially — dense commits keep
   per-commit arithmetic, and runs of sparse commits merge into one
   scatter-add whose STABLE index sort preserves every coordinate's
   arrival-order accumulation.
 - ADAG: same bit-equality (its 1/num_workers scale is clock-independent).
 - DynSGD: staleness is stamped at ENQUEUE (the ``_arrival`` field the
   event server sets at parse time), so commits coalesced into one drain
   do not count each other as staleness; without a stamp the sequential
   seed-era semantics hold bit for bit (the regression pin).
 - Mixed dense + top-k commits in one drain apply in arrival order.

Protocol-level tests drive the real event server with scripted interleaves
(an apply gate to wedge the loop mid-drain, ChaosProxy ``delay`` to push a
commit into a later drain) so the drain groupings are deterministic.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.networking import (ChaosFault, ChaosProxy,
                                            SparseDelta)
from distkeras_tpu_torch.parameter_servers import (
    ADAGParameterServer, DeltaParameterServer, DynSGDParameterServer,
    SocketParameterServer, ThreadedSocketParameterServer,
    make_socket_server)

torch.set_num_threads(1)

SHAPES = [(48,), (4, 8), (), (16,)]
TOTAL = sum(int(np.prod(s, dtype=np.int64)) for s in SHAPES)


def _blob():
    return {"model": "{}",
            "weights": [np.zeros(s, np.float32) for s in SHAPES]}


def _dense_msg(rng, clock=0):
    return {"delta": [rng.standard_normal(s).astype(np.float32)
                      for s in SHAPES],
            "worker_id": 0, "clock": clock}


def _sparse_msg(rng, k=12, clock=0, sort=True):
    idx = rng.choice(TOTAL, size=k, replace=False).astype(np.int32)
    if sort:
        idx = np.sort(idx)
    vals = rng.standard_normal(k).astype(np.float32)
    return {"delta": SparseDelta(idx, vals, TOTAL),
            "worker_id": 0, "clock": clock}


def _sequential_twin(make_ps, msgs):
    """The reference result: the same messages applied one at a time."""
    ps = make_ps()
    for m in msgs:
        ps.handle_commit(dict(m))
    return ps


# ---------------------------------------------------------------------------
# apply_drain unit level: bit-equality + ordering rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", ["dense", "sparse", "mixed"])
def test_downpour_coalesced_drain_bit_equal_sequential(mix):
    """DOWNPOUR: one coalesced drain == the same commits applied
    sequentially, bit for bit — dense, sparse (merged into ONE
    scatter-add), and interleaved."""
    rng = np.random.default_rng(0)
    if mix == "dense":
        msgs = [_dense_msg(rng) for _ in range(5)]
    elif mix == "sparse":
        msgs = [_sparse_msg(rng, k) for k in (3, 17, 9, 1)]
    else:
        msgs = [_dense_msg(rng), _sparse_msg(rng, 11), _sparse_msg(rng, 5),
                _dense_msg(rng), _sparse_msg(rng, 7)]
    a = DeltaParameterServer(_blob())
    clock = a.apply_drain([dict(m) for m in msgs])
    b = _sequential_twin(lambda: DeltaParameterServer(_blob()), msgs)
    assert clock == b.num_updates == len(msgs)
    for wa, wb in zip(a.center, b.center):
        np.testing.assert_array_equal(wa, wb)


def test_sparse_run_overlapping_indices_accumulate_in_arrival_order():
    """The stable-merge property: sparse commits hitting the SAME
    coordinates (some sent unsorted) coalesce into one scatter-add whose
    per-coordinate accumulation order is arrival order — bit-equal to the
    sequential applies even where float addition order matters."""
    rng = np.random.default_rng(1)
    # adversarial values: exercise the non-associativity of float addition
    # so any order change would show up as a bit difference
    msgs = []
    for i in range(6):
        idx = np.array([0, 1, 2, 5, TOTAL - 1], np.int32)
        vals = (rng.standard_normal(5) * 10.0 ** rng.integers(-6, 6, 5)
                ).astype(np.float32)
        if i % 2:
            order = rng.permutation(5)
            idx, vals = idx[order], vals[order]  # unsorted sender
        msgs.append({"delta": SparseDelta(idx, vals, TOTAL),
                     "worker_id": 0, "clock": 0})
    a = DeltaParameterServer(_blob())
    a.apply_drain([dict(m) for m in msgs])
    b = _sequential_twin(lambda: DeltaParameterServer(_blob()), msgs)
    for wa, wb in zip(a.center, b.center):
        np.testing.assert_array_equal(wa, wb)


def test_adag_coalesced_drain_bit_equal_sequential():
    rng = np.random.default_rng(2)
    msgs = [_dense_msg(rng), _sparse_msg(rng, 13), _sparse_msg(rng, 4)]
    a = ADAGParameterServer(_blob(), num_workers=4)
    a.apply_drain([dict(m) for m in msgs])
    b = _sequential_twin(lambda: ADAGParameterServer(_blob(), 4), msgs)
    for wa, wb in zip(a.center, b.center):
        np.testing.assert_array_equal(wa, wb)


def test_dynsgd_arrival_stamp_prices_staleness_at_enqueue():
    """The documented DynSGD ordering rule: each commit's staleness comes
    from its ``_arrival`` stamp, so drain-mates don't inflate each other's
    staleness.  Hand-computed: scale_i = 1/(max(arrival_i - clock_i,0)+1),
    applied in arrival order."""
    ps = DynSGDParameterServer(_blob())
    d = [np.full(s, 8.0, np.float32) for s in SHAPES]
    msgs = [
        {"delta": [x.copy() for x in d], "clock": 0, "_arrival": 0},  # 1/1
        {"delta": [x.copy() for x in d], "clock": 0, "_arrival": 1},  # 1/2
        {"delta": [x.copy() for x in d], "clock": 0, "_arrival": 1},  # 1/2
        {"delta": [x.copy() for x in d], "clock": 3, "_arrival": 3},  # 1/1
    ]
    ps.apply_drain(msgs)
    assert ps.num_updates == 4
    for w, s in zip(ps.center, SHAPES):
        np.testing.assert_array_equal(w, np.full(s, 8.0 + 4.0 + 4.0 + 8.0))


def test_dynsgd_without_stamp_keeps_sequential_semantics():
    """Regression pin: direct sequential applies (no ``_arrival``) price
    staleness from the live clock — the seed-era behavior, bit for bit."""
    ps = DynSGDParameterServer(_blob())
    d = [np.full(s, 8.0, np.float32) for s in SHAPES]
    ps.handle_commit({"delta": [x.copy() for x in d], "clock": 0})  # 1/1
    ps.handle_commit({"delta": [x.copy() for x in d], "clock": 0})  # 1/2
    ps.handle_commit({"delta": [x.copy() for x in d], "clock": 0})  # 1/3
    for w, s in zip(ps.center, SHAPES):
        np.testing.assert_allclose(
            w, np.full(s, 8.0 + 4.0 + 8.0 / 3.0), rtol=1e-6)


def test_mixed_dense_and_topk_commits_in_one_drain():
    """Satellite: a drain holding dense AND top-k commits applies them in
    arrival order — dense commits split the sparse runs, and the result is
    bit-equal to sequential applies."""
    rng = np.random.default_rng(3)
    msgs = [_sparse_msg(rng, 9), _dense_msg(rng), _sparse_msg(rng, 9),
            _sparse_msg(rng, 9, sort=False), _dense_msg(rng)]
    a = DeltaParameterServer(_blob())
    a.apply_drain([dict(m) for m in msgs])
    b = _sequential_twin(lambda: DeltaParameterServer(_blob()), msgs)
    for wa, wb in zip(a.center, b.center):
        np.testing.assert_array_equal(wa, wb)


# ---------------------------------------------------------------------------
# the live event server: scripted drain groupings
# ---------------------------------------------------------------------------

class _GatedPS(DeltaParameterServer):
    """First apply blocks on a gate — wedges the I/O loop mid-drain so the
    test controls exactly which commits pile up for the next drain."""

    def __init__(self, blob, gate):
        super().__init__(blob)
        self._gate = gate
        self._applied = 0

    def _apply(self, msg):
        if self._applied == 0:
            self._gate.wait(10.0)
        self._applied += 1
        super()._apply(msg)


class _GatedDynSGDPS(DynSGDParameterServer):
    def __init__(self, blob, gate):
        super().__init__(blob)
        self._gate = gate
        self._applied = 0

    def _apply(self, msg):
        if self._applied == 0:
            self._gate.wait(10.0)
        self._applied += 1
        super()._apply(msg)


def _send_commit(port, delta, clock=0):
    sock = networking.connect("127.0.0.1", port)
    networking.send_opcode(sock, b"c")
    networking.send_data(sock, {"delta": delta, "worker_id": 0,
                                "clock": clock})
    return sock


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.01)
    assert pred()


def test_event_server_coalesces_commits_that_arrive_mid_apply():
    """Commits landing while an apply is in flight are merged into ONE
    drain: wedge the first apply, send three more commits, release — the
    three apply as one batch (``coalesce_stats`` proves it) and the center
    equals the sum of all four."""
    gate = threading.Event()
    ps = _GatedPS(_blob(), gate)
    server = SocketParameterServer(ps)
    server.start()
    socks = []
    try:
        d = [np.ones(s, np.float32) for s in SHAPES]
        socks.append(_send_commit(server.port, d))
        _wait(lambda: ps._lock.locked())  # the loop is wedged in apply 1
        for _ in range(3):
            socks.append(_send_commit(server.port, d))
        gate.set()
        _wait(lambda: ps.num_updates == 4)
        for w, s in zip(ps.center, SHAPES):
            np.testing.assert_array_equal(w, np.full(s, 4.0))
        stats = server.coalesce_stats
        assert stats["commits_applied"] == 4
        assert stats["max_drain"] >= 2       # the merge really happened
        assert stats["coalesced_drains"] >= 1
    finally:
        gate.set()
        for s in socks:
            s.close()
        server.stop()


def test_dynsgd_drain_groupings_under_chaos_delay():
    """The satellite's scripted interleave: commit A wedges the apply;
    B1/B2 arrive mid-apply and coalesce into drain 2 (both stamped at
    arrival clock 1 → staleness 1 → scale 1/2 — drain-mates do NOT count
    each other); commit C rides a ChaosProxy ``delay`` long enough to land
    in its own later drain (arrival clock 3 → staleness 3 → scale 1/4).
    Final center = A + (B1+B2)/2 + C/4, exact in powers of two."""
    gate = threading.Event()
    ps = _GatedDynSGDPS(_blob(), gate)
    server = SocketParameterServer(ps)
    server.start()
    proxy = ChaosProxy("127.0.0.1", server.port,
                       faults=[ChaosFault(0, 0, "delay", 1.2)])
    socks = []
    try:
        d = [np.full(s, 8.0, np.float32) for s in SHAPES]
        socks.append(_send_commit(server.port, d))         # A: scale 1
        _wait(lambda: ps._lock.locked())
        # C through the proxy now: its 1.2 s delay outlasts the gate
        sock_c = networking.connect(proxy.host, proxy.port)
        networking.send_opcode(sock_c, b"c")
        networking.send_data(sock_c, {"delta": d, "worker_id": 0,
                                      "clock": 0})
        socks.append(sock_c)
        socks.append(_send_commit(server.port, d))         # B1
        socks.append(_send_commit(server.port, d))         # B2
        gate.set()                                         # drain 2: B1+B2
        _wait(lambda: ps.num_updates == 4, timeout=10.0)   # drain 3: C
        expected = 8.0 + 4.0 + 4.0 + 2.0
        for w, s in zip(ps.center, SHAPES):
            np.testing.assert_array_equal(w, np.full(s, expected))
        assert proxy.injected == [(0, 0, "delay")]
        assert server.coalesce_stats["max_drain"] >= 2
    finally:
        gate.set()
        for s in socks:
            s.close()
        proxy.stop()
        server.stop()


def test_coalesce_false_applies_one_commit_per_batch():
    """``coalesce=False`` keeps the event loop but degrades every drain to
    per-commit batches — the sequential semantics knob."""
    gate = threading.Event()
    ps = _GatedPS(_blob(), gate)
    server = SocketParameterServer(ps, coalesce=False)
    server.start()
    socks = []
    try:
        d = [np.ones(s, np.float32) for s in SHAPES]
        socks.append(_send_commit(server.port, d))
        _wait(lambda: ps._lock.locked())
        for _ in range(3):
            socks.append(_send_commit(server.port, d))
        gate.set()
        _wait(lambda: ps.num_updates == 4)
        stats = server.coalesce_stats
        assert stats["commits_applied"] == 4
        assert stats["max_drain"] == 1
        assert stats["coalesced_drains"] == 0
    finally:
        gate.set()
        for s in socks:
            s.close()
        server.stop()


def test_shared_drain_snapshot_keeps_u_reply_clock_advancing():
    """Two workers' 'u' commits coalesced into one drain share one
    snapshot; each connection's reply clock still strictly advances across
    its own round trips (the duplicate-reply discard baseline)."""
    ps = DeltaParameterServer(_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        socks = [networking.connect("127.0.0.1", server.port)
                 for _ in range(2)]
        d = [np.ones(s, np.float32) for s in SHAPES]
        last = [0, 0]
        for round_ in range(3):
            for s in socks:
                networking.send_opcode(s, b"u")
                networking.send_data(s, {"delta": d, "worker_id": 0,
                                         "clock": 0})
            for i, s in enumerate(socks):
                msg = networking.recv_data(s)
                assert msg["clock"] > last[i]
                last[i] = msg["clock"]
        assert ps.num_updates == 6
        for s in socks:
            networking.send_opcode(s, b"q")
            s.close()
    finally:
        server.stop()


def test_apply_error_drops_connection_but_loop_survives():
    """A hostile commit (mis-declared sparse length) costs its own
    connection, not the server: the loop logs and keeps serving."""
    ps = DeltaParameterServer(_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        bad = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(bad, b"c")
        networking.send_data(bad, {
            "delta": SparseDelta(np.array([0], np.int32),
                                 np.array([1.0], np.float32), TOTAL + 7),
            "worker_id": 0, "clock": 0})
        bad.settimeout(5.0)
        try:
            got = bad.recv(1)
        except (ConnectionError, OSError):
            got = b""
        assert got == b""  # the server hung up on the offender
        bad.close()
        ok = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(ok, b"u")
        networking.send_data(ok, {"delta": [np.ones(s, np.float32)
                                            for s in SHAPES],
                                  "worker_id": 1, "clock": 0})
        msg = networking.recv_data(ok)
        assert msg["clock"] == 1  # nothing of the hostile commit applied
        ok.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# knob plumbing: ps_core / coalesce / apply_kernel through the trainers
# ---------------------------------------------------------------------------

def _tiny_training(**kw):
    from distkeras_tpu_torch import ADAG, Dataset, Dense, Sequential

    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 96)]
    model = Sequential([Dense(8, activation="relu"),
                        Dense(3, activation="softmax")],
                       input_shape=(6,), compute_dtype="float32",
                       device="cpu")
    t = ADAG(model, num_workers=1, parallelism_factor=2, batch_size=8,
             num_epoch=1, communication_window=2, learning_rate=0.05,
             execution="host_ps", device="cpu", **kw)
    t.train(Dataset({"features": x, "label": y}))
    return t


@pytest.mark.parametrize("core", ["event", "threaded"])
def test_trainer_ps_core_knob_end_to_end(core):
    t = _tiny_training(ps_core=core)
    assert len(t.history) > 0
    stats = t.ps_coalesce_stats
    if core == "event":
        assert stats is not None and stats["commits_applied"] > 0
    else:
        assert stats is None  # the threaded core has no drains


def test_trainer_apply_kernel_auto_end_to_end():
    t = _tiny_training(apply_kernel="auto")
    assert len(t.history) > 0
    # nothing native is built for the port: 'auto' is the numpy path
    assert t._ps_server.ps._kernel is None


def test_trainer_knob_validation():
    from distkeras_tpu_torch import ADAG
    from test_torch_host_ps import make_model
    kw = dict(num_workers=2, label_col="label_encoded", device="cpu")
    with pytest.raises(ValueError, match="ps_core"):
        ADAG(make_model(), execution="host_ps", ps_core="nope", **kw)
    with pytest.raises(ValueError, match="apply_kernel"):
        ADAG(make_model(), execution="host_ps", apply_kernel="nope", **kw)
    with pytest.raises(ValueError, match="ps_core/coalesce/apply_kernel"):
        ADAG(make_model(), ps_core="threaded",  # SPMD: no server
             label_col="label_encoded", device="cpu")
    with pytest.raises(RuntimeError, match="queue A item 8"):
        ADAG(make_model(), execution="host_ps", apply_kernel="native", **kw)
    t = ADAG(make_model(), execution="host_ps", **kw)
    assert t.ps_core == "event" and t.coalesce and t.apply_kernel is None


def test_make_socket_server_selects_core():
    ps = DeltaParameterServer(_blob())
    assert isinstance(make_socket_server(ps), SocketParameterServer)
    assert isinstance(make_socket_server(ps, ps_core="threaded"),
                      ThreadedSocketParameterServer)
    with pytest.raises(ValueError, match="ps_core"):
        make_socket_server(ps, ps_core="green")


# ---------------------------------------------------------------------------
# FrameParser: the event loop's incremental receive path
# ---------------------------------------------------------------------------

def _frame_stream(msgs, ops=None):
    """A wire byte stream of framed commits interleaved with frameless ops."""
    out = bytearray()
    ops = ops or ["u"] * len(msgs)
    for op, m in zip(ops, msgs):
        out += op.encode()
        out += networking.encode_message(m)
    return bytes(out)


def _drain_parser(p):
    return list(p.messages())


def _copy_msg(m):
    if m is None:
        return None
    out = dict(m)
    d = out.get("delta")
    if isinstance(d, SparseDelta):
        out["delta"] = SparseDelta(np.array(d.indices), np.array(d.values),
                                   d.length, getattr(d, "scale", None))
    elif d is not None:
        out["delta"] = [np.array(a) for a in d]
    return out


def _assert_msgs_equal(got, want_ops, want_msgs):
    assert [op for op, _ in got] == [o.encode() for o in want_ops]
    framed = [m for _, m in got if m is not None]
    assert len(framed) == len(want_msgs)
    for g, w in zip(framed, want_msgs):
        gd, wd = g["delta"], w["delta"]
        if isinstance(wd, SparseDelta):
            assert isinstance(gd, SparseDelta)
            np.testing.assert_array_equal(np.asarray(gd.indices),
                                          np.asarray(wd.indices))
            np.testing.assert_array_equal(np.asarray(gd.values),
                                          np.asarray(wd.values))
            assert gd.length == wd.length
        else:
            for a, b in zip(gd, wd):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_frameparser_whole_stream_one_feed():
    rng = np.random.default_rng(0)
    msgs = [_dense_msg(rng) for _ in range(3)]
    stream = _frame_stream(msgs)
    p = networking.FrameParser()
    p.feed(stream)
    _assert_msgs_equal(_drain_parser(p), ["u"] * 3, msgs)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_frameparser_chunked_fuzz_equals_one_feed(chunk):
    """Any chunking of the byte stream — down to one byte at a time —
    yields exactly the messages of a single whole-stream feed (the parser
    may be drained between any two feeds)."""
    rng = np.random.default_rng(1)
    msgs = [_dense_msg(rng), _sparse_msg(rng), _dense_msg(rng)]
    stream = _frame_stream(msgs, ops=["u", "c", "u"])
    p = networking.FrameParser()
    got = []
    for off in range(0, len(stream), chunk):
        p.feed(stream[off:off + chunk])
        # Snapshot at drain time: decoded arrays are views into the frame
        # buffer, which the parser recycles once the caller consumed them.
        got.extend((op, _copy_msg(m)) for op, m in _drain_parser(p))
    _assert_msgs_equal(got, ["u", "c", "u"], msgs)


def test_frameparser_frameless_ops_interleaved():
    rng = np.random.default_rng(2)
    m = _dense_msg(rng)
    stream = b"p" + b"h" + b"u" + networking.encode_message(m) + b"q"
    p = networking.FrameParser()
    p.feed(stream)
    got = _drain_parser(p)
    assert [op for op, _ in got] == [b"p", b"h", b"u", b"q"]
    assert got[0][1] is None and got[3][1] is None


def test_frameparser_direct_fill_writable_advance():
    """The big-frame path: once the torn frame's header has arrived the
    parser exposes the preallocated tail for recv_into-style direct
    filling, and the filled frame decodes identically."""
    rng = np.random.default_rng(3)
    m = {"delta": [rng.standard_normal(40_000).astype(np.float32)],
         "worker_id": 0, "clock": 0}
    stream = b"u" + networking.encode_message(m)
    p = networking.FrameParser()
    assert p.writable() is None
    p.feed(stream[:4096])  # header lands, payload torn
    assert _drain_parser(p) == []
    w = p.writable()
    assert w is not None and len(w) == len(stream) - 4096
    w[:] = stream[4096:]
    p.advance(len(w))
    _assert_msgs_equal(_drain_parser(p), ["u"], [m])
    assert p.writable() is None


def test_frameparser_recycles_retired_frame_buffer():
    """Steady-state same-size torn frames reassemble into the SAME buffer
    (no per-frame allocate-and-zero) — the recycle contract assumes the
    caller consumed the previous frame's views before feeding more."""
    rng = np.random.default_rng(4)
    p = networking.FrameParser()
    buf_ids = []
    for _ in range(3):
        m = {"delta": [rng.standard_normal(10_000).astype(np.float32)],
             "worker_id": 0, "clock": 0}
        stream = b"u" + networking.encode_message(m)
        p.feed(stream[:1024])
        assert _drain_parser(p) == []
        w = p.writable()
        w[:] = stream[1024:]
        p.advance(len(w))
        got = _drain_parser(p)
        _assert_msgs_equal(got, ["u"], [m])
        buf_ids.append(id(w.obj))
    assert buf_ids[1] == buf_ids[2]  # second torn frame reuses the first's


def test_frameparser_bad_magic_raises():
    p = networking.FrameParser()
    p.feed(b"u" + b"XXXX" + b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        _drain_parser(p)


def test_frameparser_oversized_header_raises():
    import struct
    p = networking.FrameParser()
    bad = b"u" + networking.MAGIC + struct.pack("<I", 1 << 30)
    p.feed(bad)
    with pytest.raises(ValueError, match="[Hh]eader"):
        _drain_parser(p)


def test_frameparser_buffer_length_lie_raises():
    """A frame whose u64 buffer prefix disagrees with the header's
    dtype×shape is rejected (the desync guard recv_data applies)."""
    rng = np.random.default_rng(5)
    m = _dense_msg(rng)
    frame = bytearray(networking.encode_message(m))
    # corrupt the first payload-buffer length prefix
    (hlen,) = networking._U32.unpack_from(frame, 4)
    off = 8 + hlen
    networking._U64.pack_into(frame, off, 7)
    p = networking.FrameParser()
    p.feed(b"u" + bytes(frame))
    with pytest.raises(ValueError):
        _drain_parser(p)
