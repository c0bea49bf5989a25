"""The cases of tests/test_host_ps_overlap.py on the port: the combined
``'u'`` (commit+pull) opcode, the per-connection receive-buffer pool,
connect retry-with-backoff, and the ``comm_overlap`` double-buffered
window loop — ONE transport round trip per communication window, counted
by a test double on the opcode stream, sparse top-k commits included."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import (ADAG, AEASGD, DOWNPOUR, EAMSGD, DynSGD,
                                 networking)
from distkeras_tpu_torch.parameter_servers import (DeltaParameterServer,
                                                   SocketParameterServer)
from distkeras_tpu_torch.workers import DOWNPOURWorker

from test_torch_host_ps import make_dataset, make_model

torch.set_num_threads(1)


def _tiny_blob(n=3):
    return {"model": make_model().to_json(),
            "weights": [np.zeros((n,), np.float32)]}


def _worker(port, **kw):
    return DOWNPOURWorker(_tiny_blob(), "sgd", "mse", "127.0.0.1", port,
                          device="cpu", **kw)


def _accuracy(fitted, ds, rows=256):
    preds = fitted.predict(ds["features"][:rows])
    return float(np.mean(np.argmax(preds, axis=1) == ds["label"][:rows]))


# ---------------------------------------------------------------------------
# the 'u' opcode — atomic commit+pull in one round trip
# ---------------------------------------------------------------------------

def test_update_opcode_atomic_commit_plus_pull():
    """'u' applies the delta and replies with the center *including* that
    commit plus the advanced clock — one round trip, one lock acquisition."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(sock, b"u")
        networking.send_data(sock, {"delta": [np.ones(3, np.float32)],
                                    "worker_id": 0, "clock": 0})
        msg = networking.recv_data(sock)
        assert msg["clock"] == 1
        np.testing.assert_array_equal(msg["weights"][0], np.ones(3))
        sock.close()
    finally:
        server.stop()


@pytest.mark.parametrize("wire_dtype", ["bfloat16", "int8", "topk"])
def test_update_opcode_wire_dtypes_roundtrip(wire_dtype):
    """The compressed-commit paths (bf16 cast / int8 codes+scales / a
    density-1.0 sparse top-k commit) ride the 'u' opcode: the PS decodes at
    the transport boundary, applies, and the reply center equals old
    center + the as-applied delta."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        kw = ({"wire_topk": 1.0} if wire_dtype == "topk" else {})
        wk = _worker(server.port, wire_dtype=wire_dtype, **kw)
        wk.connect()
        center0 = [np.array(w) for w in wk.pull()]
        delta = [np.full(w.shape, 0.25, np.float32) for w in center0]
        applied, center = wk.update(delta, 0)
        assert wk._last_clock == 1
        for c0, c, a in zip(center0, center, applied):
            np.testing.assert_allclose(c, c0 + a, atol=1e-6)
            np.testing.assert_allclose(a, 0.25, atol=1e-2)
        # PS center stays f32 regardless of the wire dtype
        assert all(w.dtype == np.float32 for w in ps.center)
        wk.disconnect()
    finally:
        server.stop()


def test_update_torn_frame_drops_connection_server_survives():
    """A 'u' followed by a corrupt frame drops THAT connection (same
    torn-frame policy as 'c'); the server keeps serving other workers and
    the center is untouched."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        bad = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(bad, b"u")
        bad.sendall(b"XXXX" + b"\x00" * 32)  # bad magic → ValueError → drop
        bad.settimeout(5.0)
        try:
            got = bad.recv(1)
        except (ConnectionError, OSError):
            got = b""
        assert got == b""  # server hung up on us
        bad.close()

        good = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(good, b"u")
        networking.send_data(good, {"delta": [np.ones(3, np.float32)],
                                    "worker_id": 1, "clock": 0})
        msg = networking.recv_data(good)
        assert msg["clock"] == 1  # the torn frame applied nothing
        good.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# receive-buffer pool
# ---------------------------------------------------------------------------

def test_buffer_pool_reuses_buffers_across_same_shape_pulls():
    pool = networking.BufferPool()
    a, b = socket.socketpair()
    msg = {"weights": [np.arange(64, dtype=np.float32).reshape(8, 8),
                       np.ones((5,), np.float32)], "clock": 2}
    try:
        for _ in range(3):
            t = threading.Thread(target=networking.send_data, args=(a, msg))
            t.start()
            out = networking.recv_data(b, pool=pool)
            t.join(timeout=10)
            assert not t.is_alive()
            np.testing.assert_array_equal(out["weights"][0],
                                          msg["weights"][0])
            np.testing.assert_array_equal(out["weights"][1],
                                          msg["weights"][1])
            assert out["clock"] == 2
        # same payload size every time → ONE allocation, then reuse
        assert pool.misses == 1 and pool.hits == 2
        # pooled decode is zero-copy: the arrays view the pooled buffer
        assert not out["weights"][0].flags["OWNDATA"]
    finally:
        a.close()
        b.close()


def test_buffer_pool_python_payload_decode():
    payload = b"".join(len(x).to_bytes(8, "little") + x
                       for x in (b"abc", b"", b"0123456789"))
    py = [bytes(v) for v in networking._decode_payload_py(payload)]
    assert py == [b"abc", b"", b"0123456789"]
    assert networking._native is None  # the port's one codec
    with pytest.raises(ValueError, match="Truncated"):
        networking._decode_payload_py(payload[:-3])


def test_pooled_recv_rejects_mismatched_buffer_length():
    """The pooled path still validates each u64 prefix against the header's
    dtype*shape — a lying frame raises instead of decoding garbage."""
    good = networking.encode_message({"w": np.zeros((4,), np.float32)})
    tampered = bytearray(good)
    off = len(good) - 16 - 8
    tampered[off:off + 8] = (8).to_bytes(8, "little")  # wrong (real is 16)
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(tampered))
        with pytest.raises(ValueError,
                           match="expects|declares|Truncated"):
            networking.recv_data(b, pool=networking.BufferPool())
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# connect retry-with-backoff
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_connect_retries_until_ps_is_up(monkeypatch):
    """A worker that dials before the PS listens retries instead of dying
    on the first ConnectionRefusedError: the listener opens only after the
    worker's first refused dial."""
    port = _free_port()
    wk = _worker(port)
    refused = threading.Event()
    real_connect = networking.connect

    def watched(host, p, *a, **kw):
        try:
            return real_connect(host, p, *a, **kw)
        except ConnectionRefusedError:
            refused.set()
            raise

    monkeypatch.setattr(networking, "connect", watched)
    accepted = []

    def listen_late():
        if not refused.wait(10.0):
            return
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        srv.settimeout(10.0)
        try:
            conn, _ = srv.accept()
            accepted.append(conn)
        except socket.timeout:
            pass
        srv.close()

    t = threading.Thread(target=listen_late)
    t.start()
    try:
        wk.connect(attempts=60, backoff=0.05)
    finally:
        t.join(timeout=15)
    assert not t.is_alive()
    assert refused.is_set() and wk._sock is not None and accepted
    wk._sock.close()
    for c in accepted:
        c.close()


def test_connect_retry_is_bounded():
    wk = _worker(_free_port())
    t0 = time.perf_counter()
    with pytest.raises(ConnectionError, match="refused 2"):
        wk.connect(attempts=2, backoff=0.01)
    assert time.perf_counter() - t0 < 5.0


# ---------------------------------------------------------------------------
# comm_overlap — the knob and the 1-RTT-per-window acceptance criterion
# ---------------------------------------------------------------------------

def test_comm_overlap_knob_defaults_and_validation():
    m = make_model()
    kw = dict(num_workers=2, label_col="label_encoded", device="cpu")
    assert DOWNPOUR(m, execution="host_ps", **kw).comm_overlap is True
    assert ADAG(m, execution="host_ps", **kw).comm_overlap is True
    assert DynSGD(m, execution="host_ps", **kw).comm_overlap is True
    assert AEASGD(m, execution="host_ps", **kw).comm_overlap is False
    assert EAMSGD(m, execution="host_ps", **kw).comm_overlap is False
    assert AEASGD(m, execution="host_ps", comm_overlap=True,
                  **kw).comm_overlap is True
    assert DOWNPOUR(m, execution="host_ps", comm_overlap=False,
                    **kw).comm_overlap is False
    # the SPMD engine has no wire: an explicit setting there is refused
    with pytest.raises(ValueError, match="comm_overlap"):
        DOWNPOUR(m, comm_overlap=True, device="cpu",
                 label_col="label_encoded")


class _OpcodeRecorder:
    """Counting test double over the worker→PS opcode stream."""

    def __init__(self):
        self.ops = []
        self._orig = networking.send_opcode
        self._lock = threading.Lock()

    def __enter__(self):
        def recording(sock, op):
            with self._lock:
                self.ops.append(op)
            self._orig(sock, op)
        networking.send_opcode = recording
        return self

    def __exit__(self, *exc):
        networking.send_opcode = self._orig

    def count(self, op: bytes) -> int:
        return self.ops.count(op)


def test_overlap_exactly_one_roundtrip_per_window():
    """With comm_overlap on, every communication window costs exactly ONE
    transport round trip — the opcode stream is one initial pull then
    only 'u' frames (no 'c'/'p' pairs), and the worker counters agree."""
    ds = make_dataset(n=1024)
    t = DOWNPOUR(make_model(), num_workers=2, batch_size=32, num_epoch=2,
                 communication_window=4, learning_rate=0.02,
                 label_col="label_encoded", execution="host_ps",
                 device="cpu")
    assert t.comm_overlap
    with _OpcodeRecorder() as rec:
        t.train(ds)
    # 1024 rows / 2 workers = 512 each; window*batch = 128 → 4 windows per
    # epoch per worker × 2 epochs × 2 workers = 16 windows total
    windows = 16
    assert rec.count(b"u") == windows
    assert rec.count(b"c") == 0
    assert rec.count(b"p") == 2  # one initial pull per worker
    assert rec.count(b"q") == 2
    for w in t._ps_workers:
        assert w._commits == windows // 2
        # transport ops = initial pull + one 'u' per window — nothing else
        assert w.transport_ops == 1 + w._commits
        # every reply after the first landed in the reusable pool buffer
        assert w._pool.misses == 1
        assert w._pool.hits == w._commits


def test_serial_path_pays_two_ops_per_window():
    """The overlap-off path keeps the reference 'c'+'p' pair (the
    comparison baseline: 2 round trips a window)."""
    ds = make_dataset(n=1024)
    t = DOWNPOUR(make_model(), num_workers=2, batch_size=32, num_epoch=2,
                 communication_window=4, learning_rate=0.02,
                 label_col="label_encoded", execution="host_ps",
                 comm_overlap=False, device="cpu")
    with _OpcodeRecorder() as rec:
        t.train(ds)
    windows = 16
    assert rec.count(b"u") == 0
    assert rec.count(b"c") == windows
    assert rec.count(b"p") == 2 + windows  # initial + re-pull per window
    for w in t._ps_workers:
        assert w.transport_ops == 1 + 2 * w._commits


@pytest.mark.parametrize("cls,overlap,kw", [
    # the complement of each algorithm's default, so both overlap modes
    # stay covered for every algorithm (test_torch_host_ps.py runs the
    # defaults: delta family ON, elastic family OFF)
    (DOWNPOUR, False, {"communication_window": 4, "learning_rate": 0.02}),
    (ADAG, False, {"communication_window": 4, "learning_rate": 0.1}),
    (DynSGD, False, {"communication_window": 4, "learning_rate": 0.05}),
    (AEASGD, True, {"communication_window": 8, "rho": 1.0,
                    "learning_rate": 0.05}),
    (EAMSGD, True, {"communication_window": 8, "rho": 1.0,
                    "learning_rate": 0.05, "momentum": 0.9}),
])
def test_host_ps_training_learns_overlap_complement(cls, overlap, kw):
    ds = make_dataset()
    t = cls(make_model(), num_workers=2, batch_size=32, num_epoch=2,
            label_col="label_encoded", execution="host_ps",
            comm_overlap=overlap, device="cpu", **kw)
    fitted = t.train(ds)
    hist = t.get_history()
    assert len(hist) > 0
    assert np.mean(hist[-5:]) < np.mean(hist[:5])
    assert _accuracy(fitted, ds) > 0.6


def test_overlap_topk_wire_compression_refused():
    """The JAX file's overlap + top-k leg (the name is the one the test had
    while top-k was refused): device selection rides the same pipelined
    'u' stream (exactly one round trip per window) and the error-feedback
    rebase still learns."""
    ds = make_dataset(n=1024)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=2,
             communication_window=4, label_col="label_encoded",
             learning_rate=0.1, execution="host_ps", wire_dtype="topk",
             wire_topk=0.1, comm_overlap=True, device="cpu")
    with _OpcodeRecorder() as rec:
        fitted = t.train(ds)
    windows = 16  # 1024 rows / 2 workers, window*batch=128, 2 epochs
    assert rec.count(b"u") == windows and rec.count(b"c") == 0
    assert rec.count(b"p") == 2
    assert _accuracy(fitted, ds) > 0.6


def test_overlap_int8_wire_compression_learns():
    """Overlap composes with int8 error-feedback compression: the rebase
    uses the as-applied delta, so the quantization error still telescopes."""
    ds = make_dataset()
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=2,
             communication_window=4, label_col="label_encoded",
             learning_rate=0.1, execution="host_ps", wire_dtype="int8",
             comm_overlap=True, device="cpu")
    fitted = t.train(ds)
    assert _accuracy(fitted, ds) > 0.6
