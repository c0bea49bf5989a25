"""The cases of tests/test_topk_wire.py on the port: sparse top-k delta
compression across the host-PS stack (``wire_dtype="topk"``) — the
device selection (``torch.topk`` inside the window program, here on the
CPU), the sparse wire node, the scatter-add apply, sharded index
bisection, and the acceptance observables: commit bytes ≤ 5% of dense at
density 0.01 (byte-counting socket double), exactly one 'u' round trip
per window, and an MNIST-shaped MLP converging to the same loss band as
dense under DOWNPOUR and ADAG at ``ps_shards`` 1 and 3.  bf16 codes are
CPU ``torch.bfloat16`` tensors (no ``ml_dtypes``)."""

import threading

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import (ADAG, DOWNPOUR, Dataset, Dense,
                                 OneHotTransformer, Sequential, networking)
from distkeras_tpu_torch.core.model import serialize_model
from distkeras_tpu_torch.parameter_servers import (DeltaParameterServer,
                                                   SocketParameterServer,
                                                   _scatter_add)
from distkeras_tpu_torch.workers import DOWNPOURWorker, topk_select

from test_torch_host_ps import make_model
from test_torch_host_ps_overlap import _OpcodeRecorder

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# fixtures: an MNIST-shaped MLP workload (784-dim inputs, 10 classes)
# ---------------------------------------------------------------------------

def make_mnist_like(n=768, d=784, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0.0, 1.0, (classes, d)) * (rng.random((classes, d))
                                                    > 0.5)
    labels = rng.integers(0, classes, n)
    x = np.clip(protos[labels] + 0.25 * rng.standard_normal((n, d)),
                0.0, 1.0).astype(np.float32)
    ds = Dataset({"features": x, "label": labels.astype(np.int64)})
    return OneHotTransformer(classes, input_col="label",
                             output_col="label_encoded").transform(ds)


def make_mlp():
    return Sequential([Dense(64, activation="relu"),
                       Dense(10, activation="softmax")],
                      input_shape=(784,), compute_dtype="float32",
                      device="cpu")


def _mlp_blob():
    return serialize_model(make_mlp())


def _worker(blob, port=1, **kw):
    return DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", port,
                          device="cpu", **kw)


class _WireBytesRecorder:
    """Byte-counting socket double over the worker→PS stream: every frame
    ``send_data`` ships is re-encoded through the public codec and counted
    against the opcode that preceded it on that socket."""

    def __init__(self):
        self.bytes_by_op: dict = {}
        self.frames_by_op: dict = {}
        self._last_op: dict = {}
        self._lock = threading.Lock()

    def __enter__(self):
        self._orig_op = networking.send_opcode
        self._orig_data = networking.send_data

        def rec_op(sock, op):
            with self._lock:
                self._last_op[id(sock)] = op
            self._orig_op(sock, op)

        def rec_data(sock, obj, pool=None):
            blob = networking.encode_message(obj)
            with self._lock:
                op = self._last_op.get(id(sock), b"?")
                self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) \
                    + len(blob) + 1
                self.frames_by_op[op] = self.frames_by_op.get(op, 0) + 1
            sock.sendall(blob)

        networking.send_opcode = rec_op
        networking.send_data = rec_data
        return self

    def __exit__(self, *exc):
        networking.send_opcode = self._orig_op
        networking.send_data = self._orig_data


def _flat(weights):
    return np.concatenate([np.asarray(w, np.float32).reshape(-1)
                           for w in weights])


# ---------------------------------------------------------------------------
# selection semantics
# ---------------------------------------------------------------------------

def test_topk_commit_is_sparse_with_error_feedback():
    """A host-path topk commit ships a SparseDelta of exactly k = ⌈density·n⌉
    coordinates, and eff == densify(applied) + residual exactly — the unsent
    mass telescopes into the next commit (EF-SGD)."""
    blob = _mlp_blob()
    wk = _worker(blob, wire_dtype="topk", wire_topk=0.01)
    sent = []
    wk._sock = object()
    orig_op, orig_send = networking.send_opcode, networking.send_data
    networking.send_opcode = lambda s, op: None
    networking.send_data = lambda s, msg, pool=None: sent.append(msg)
    try:
        rng = np.random.default_rng(1)
        d1 = [rng.standard_normal(np.shape(w)).astype(np.float32) * 0.01
              for w in blob["weights"]]
        a1 = wk.commit(d1, 0)
        total = sum(int(np.prod(np.shape(w))) for w in blob["weights"])
        k = int(np.ceil(0.01 * total))
        sp = sent[0]["delta"]
        assert isinstance(sp, networking.SparseDelta)
        assert sp.nnz == k and sp.length == total
        assert sp.indices.dtype == np.int32
        assert np.all(np.diff(sp.indices) > 0)  # sorted, unique
        np.testing.assert_allclose(_flat(d1), _flat(a1) + wk._residual_flat,
                                   atol=1e-7)
        # selection is by magnitude: every selected value dominates every
        # residual (unselected) coordinate
        assert np.min(np.abs(sp.f32_values())) >= \
            np.max(np.abs(wk._residual_flat)) - 1e-7
        assert wk.commit_bytes == 8 * k  # int32 indices + f32 values
        # second window: the residual mass rides into the next commit
        d2 = [rng.standard_normal(np.shape(w)).astype(np.float32) * 0.01
              for w in blob["weights"]]
        r1 = wk._residual_flat.copy()
        a2 = wk.commit(d2, 0)
        np.testing.assert_allclose(_flat(d2) + r1,
                                   _flat(a2) + wk._residual_flat, atol=1e-7)
    finally:
        networking.send_opcode, networking.send_data = orig_op, orig_send


@pytest.mark.parametrize("code", [None, "bfloat16", "int8"])
def test_device_selection_matches_host_delta(code):
    """The device pass (selection inside the window program, run here on
    the CPU) agrees with the host reference: only k codes + int32 indices
    come back, densify(selected) + residual reproduces the full window
    delta, and the selected magnitudes dominate the residual."""
    blob = _mlp_blob()
    wk = _worker(blob, wire_dtype="topk", wire_topk=0.01, batch_size=16,
                 wire_topk_dtype=code)
    wk._ensure_model()
    params = wk._params
    base = _flat(wk._params_to_weights())
    rng = np.random.default_rng(0)
    xw = torch.from_numpy(rng.standard_normal((4, 16, 784)).astype(
        np.float32))
    yw = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (4, 16))])
    mw = np.ones((4, 16), np.float32)
    params, _, packed = wk._run_topk_window(
        params, wk._tx.init(list(params.values())), xw, yw, mw,
        wk._generator(0))
    assert packed.dtype == torch.uint8  # one packed copy a window
    sp, loss = wk._fetch_sparse(packed)
    assert np.isfinite(loss)
    assert sp.nnz == wk._wire_k and sp.indices.dtype == np.int32
    assert np.all(np.diff(sp.indices) > 0)
    after = _flat(wk._params_to_weights())
    res = wk._residual_dev.numpy()
    np.testing.assert_allclose(after - base, sp.to_dense() + res, atol=1e-5)
    assert np.min(np.abs(sp.f32_values())) >= np.max(np.abs(res)) - 1e-5
    if code == "bfloat16":
        assert isinstance(sp.values, torch.Tensor)
        assert sp.values.dtype == torch.bfloat16 and sp.scale is None
    elif code == "int8":
        assert sp.values.dtype == np.int8 and sp.scale is not None


@pytest.mark.parametrize("code", ["bfloat16", "int8"])
def test_topk_value_coding_error_goes_to_residual(code):
    """bf16/int8-coded values on top of the sparse node: the coding error
    lands in the residual (eff == applied + residual still holds exactly),
    and the wire values really are the coded dtype."""
    rng = np.random.default_rng(2)
    eff = rng.standard_normal(500).astype(np.float32) * 0.01
    idx, wire, applied, scale, res = topk_select(eff, 50, code)
    if code == "int8":
        assert wire.dtype == np.int8 and scale is not None
        np.testing.assert_allclose(applied, wire.astype(np.float32) * scale,
                                   rtol=1e-6)
    else:
        assert isinstance(wire, torch.Tensor)
        assert wire.dtype == torch.bfloat16 and scale is None
    dense = np.zeros_like(eff)
    dense[idx] = applied
    np.testing.assert_allclose(eff, dense + res, atol=1e-7)
    # coded values decode identically through the wire node
    sp = networking.SparseDelta(idx, wire, eff.size, scale)
    np.testing.assert_allclose(sp.f32_values(), applied, rtol=1e-6)
    back = networking.decode_message(networking.encode_message(
        {"delta": sp}))["delta"]
    np.testing.assert_array_equal(back.f32_values(), applied)


def test_update_opcode_topk_roundtrip():
    """A density-1.0 topk 'u' commit is the dense commit, bit for bit at the
    apply: the reply center equals center0 + delta and the PS stays f32."""
    blob = _mlp_blob()
    ps = DeltaParameterServer(blob)
    server = SocketParameterServer(ps)
    server.start()
    try:
        wk = _worker(blob, server.port, wire_dtype="topk", wire_topk=1.0)
        wk.connect()
        center0 = [np.array(w) for w in wk.pull()]
        delta = [np.full(np.shape(w), 0.25, np.float32) for w in center0]
        applied, center = wk.update(delta, 0)
        assert wk._last_clock == 1
        for c0, c, a in zip(center0, center, applied):
            np.testing.assert_allclose(np.asarray(c), c0 + a, atol=1e-6)
            np.testing.assert_allclose(a, 0.25, atol=1e-6)
        assert all(w.dtype == np.float32 for w in ps.center)
        wk.disconnect()
    finally:
        server.stop()


def test_scatter_add_matches_dense_apply():
    """PS-side O(k) scatter-add == dense apply of the densified delta, for
    every rule scale, across tensor boundaries and row splits."""
    rng = np.random.default_rng(3)
    shapes = [(16, 32), (32,), (32, 4), (4,), ()]
    center_a = [np.asarray(rng.standard_normal(s), np.float32)
                for s in shapes]
    center_b = [c.copy() for c in center_a]
    total = sum(int(np.prod(s)) for s in shapes)
    idx = np.sort(rng.choice(total, 37, replace=False)).astype(np.int32)
    vals = rng.standard_normal(37).astype(np.float32)
    sp = networking.SparseDelta(idx, vals, total)
    _scatter_add(center_a, sp, 0.5)
    dense = sp.to_dense() * 0.5
    off = 0
    for c in center_b:
        c += dense[off:off + c.size].reshape(c.shape)
        off += c.size
    for a, b in zip(center_a, center_b):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# acceptance: bytes, round trips, convergence
# ---------------------------------------------------------------------------

def _one_commit_bytes(**wire_kw):
    blob = _mlp_blob()
    ps = DeltaParameterServer(blob)
    server = SocketParameterServer(ps)
    server.start()
    try:
        wk = _worker(blob, server.port, **wire_kw)
        wk.connect()
        rng = np.random.default_rng(0)
        delta = [rng.standard_normal(np.shape(w)).astype(np.float32) * 0.01
                 for w in blob["weights"]]
        with _WireBytesRecorder() as rec:
            wk.update(delta, 0)
        wk.disconnect()
        return rec.bytes_by_op[b"u"]
    finally:
        server.stop()


def test_topk_commit_bytes_at_most_5pct_of_dense():
    """At wire_topk=0.01 the measured per-window commit bytes
    (byte-counting socket double) are ≤ 5% of the dense commit."""
    dense = _one_commit_bytes()
    topk = _one_commit_bytes(wire_dtype="topk", wire_topk=0.01)
    assert topk <= 0.05 * dense, (topk, dense)
    # bf16- and int8-coded values squeeze the sparse payload further still
    topk16 = _one_commit_bytes(wire_dtype="topk", wire_topk=0.01,
                               wire_topk_dtype="bfloat16")
    topk8 = _one_commit_bytes(wire_dtype="topk", wire_topk=0.01,
                              wire_topk_dtype="int8")
    assert topk8 < topk16 < topk


def test_topk_overlap_one_rtt_per_window_and_byte_win():
    """End to end, topk keeps the pipelined transport contract — exactly one
    'u' round trip per communication window, zero 'c'/'p' pairs — while the
    measured commit ('u') bytes stay ≤ 5% of the same run dense."""
    ds = make_mnist_like(n=512)

    def run(**kw):
        t = DOWNPOUR(make_mlp(), num_workers=2, batch_size=32, num_epoch=2,
                     communication_window=4, learning_rate=0.05,
                     label_col="label_encoded", execution="host_ps",
                     device="cpu", **kw)
        with _OpcodeRecorder() as ops, _WireBytesRecorder() as wire:
            t.train(ds)
        return t, ops, wire

    t, ops, wire = run(wire_dtype="topk", wire_topk=0.01)
    # 512 rows / 2 workers = 256 each; window*batch = 128 → 2 windows per
    # epoch per worker × 2 epochs × 2 workers = 8 windows
    windows = 8
    assert ops.count(b"u") == windows
    assert ops.count(b"c") == 0
    assert ops.count(b"p") == 2  # one initial pull per worker
    for w in t._ps_workers:
        assert w.transport_ops == 1 + w._commits
        assert w._residual_dev is not None  # the device selection ran
    _, _, dense_wire = run()
    topk_per = wire.bytes_by_op[b"u"] / wire.frames_by_op[b"u"]
    dense_per = dense_wire.bytes_by_op[b"u"] / dense_wire.frames_by_op[b"u"]
    assert topk_per <= 0.05 * dense_per, (topk_per, dense_per)


_DENSE_BAND = {}


def _center_ce(fitted, ds):
    p = np.asarray(fitted.predict(ds["features"]))
    picked = p[np.arange(len(p)), np.asarray(ds["label"])]
    return float(-np.mean(np.log(np.clip(picked, 1e-9, 1.0))))


def _mlp_run(cls, lr, ds, **kw):
    t = cls(make_mlp(), num_workers=2, batch_size=32, num_epoch=3,
            communication_window=4, learning_rate=lr,
            label_col="label_encoded", execution="host_ps", device="cpu",
            **kw)
    fitted = t.train(ds)
    preds = np.argmax(np.asarray(fitted.predict(ds["features"])), axis=1)
    acc = float(np.mean(preds == np.asarray(ds["label"])))
    return _center_ce(fitted, ds), acc


@pytest.mark.parametrize("cls,lr,shards", [
    (DOWNPOUR, 0.05, 1),
    (DOWNPOUR, 0.05, 3),
    (ADAG, 0.1, 1),
    (ADAG, 0.1, 3),
])
def test_topk_mnist_mlp_converges_to_dense_loss_band(cls, lr, shards):
    """The MNIST-shaped MLP at wire_topk=0.01 converges to the same loss
    band as dense under DOWNPOUR and ADAG at ps_shards ∈ {1, 3}
    (fitted-center cross-entropy within 0.15 of dense; accuracy within
    0.02 of dense and above 0.9)."""
    ds = make_mnist_like()
    key = (cls.__name__, lr)
    if key not in _DENSE_BAND:
        _DENSE_BAND[key] = _mlp_run(cls, lr, ds)
    dense_ce, dense_acc = _DENSE_BAND[key]
    ce, acc = _mlp_run(cls, lr, ds, wire_dtype="topk", wire_topk=0.01,
                       ps_shards=shards)
    assert ce <= dense_ce + 0.15, (ce, dense_ce)
    assert acc >= dense_acc - 0.02 and acc > 0.9, (acc, dense_acc)


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def test_wire_topk_validation():
    m = make_model()
    kw = dict(num_workers=2, label_col="label_encoded",
              execution="host_ps", device="cpu")
    t = ADAG(m, wire_dtype="topk", wire_topk=0.05, **kw)
    assert t.wire_dtype == "topk" and t.wire_topk == 0.05
    with pytest.raises(ValueError, match="wire_topk"):
        ADAG(m, wire_dtype="topk", wire_topk=0.0, **kw)
    with pytest.raises(ValueError, match="wire_topk"):
        ADAG(m, wire_dtype="topk", wire_topk=1.5, **kw)
    with pytest.raises(ValueError, match="wire_topk_dtype"):
        ADAG(m, wire_dtype="topk", wire_topk_dtype="float64", **kw)
    with pytest.raises(ValueError, match="wire_topk_dtype"):
        ADAG(m, wire_dtype="int8", wire_topk_dtype="int8", **kw)
    # worker-level eager validation too
    blob = _mlp_blob()
    with pytest.raises(ValueError, match="wire_topk"):
        _worker(blob, wire_dtype="topk", wire_topk=2.0)
    wk = _worker(blob, wire_dtype="topk", wire_topk=0.01)
    assert wk._topk_density == 0.01 and wk.wire_dtype is None
    # the flat layout is indexed with int32 (a broadcast view: no memory)
    big = {"model": blob["model"],
           "weights": [np.broadcast_to(np.float32(0), (2 ** 31,))]}
    with pytest.raises(ValueError, match="int32"):
        _worker(big, wire_dtype="topk")._ensure_topk()
