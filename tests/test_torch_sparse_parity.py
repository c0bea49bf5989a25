"""Sharding, top-k and row-sparse commits between the two packages, on the
CPU.

 - **The plan and the host selection, bit for bit.**  ``make_shard_plan``
   and ``split_sparse`` over random shape lists and N = 1-5, and
   ``topk_select`` (indices, wire bytes, applied values, residual) for
   each code on tie-free inputs.
 - **The device selection.**  The port's window with its ``torch.topk``
   pass (run on the CPU) against the JAX ``_run_topk_window`` from the
   same weights and windows: the selections agree wherever the k-th
   magnitude gap exceeds the f32 noise (a margin of the larger of
   1e-5·max|delta| and 4 ulps of the largest weight), the shared values
   agree within that margin (bf16 within one bf16 step, int8 codes within
   one code), and each side's ``after − base == densify(selected) +
   residual`` holds within the margin.
 - **Interop.**  A port worker (sharded top-k with each code, sharded
   row-sparse, sharded bf16) into a JAX ``ShardedServerGroup`` and a JAX
   worker into a port group: the centers and per-shard clocks equal those
   of a same-package run, bit for bit.
 - **Checkpoints.**  A JAX-written sharded npz checkpoint resumes in the
   port and a port-written one in the JAX package (center and clock
   vector bit for bit); the port trains on from the JAX checkpoint within
   rtol 1e-5, atol 1e-6 of the JAX package doing the same.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as port
from distkeras_tpu import ps_sharding as jsh
from distkeras_tpu import workers as jworkers
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu_torch import ps_sharding as psh
from distkeras_tpu_torch import workers as pworkers
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.core.model import load_jax_weights

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _bytes(values) -> bytes:
    """The wire bytes of a value array (a bf16 torch tensor as int16)."""
    if isinstance(values, torch.Tensor):
        return values.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(values).tobytes()


def _mlp_blob(d=16, hidden=32, classes=4, seed=0):
    model = JaxSequential([jl.Dense(hidden, activation="relu"),
                           jl.Dense(classes, activation="softmax")],
                          input_shape=(d,), compute_dtype="float32")
    shapes = [w.shape for w in
              model.get_weights(model.init(jax.random.PRNGKey(0)))]
    rng = np.random.default_rng(seed)
    return {"model": model.to_json(),
            "weights": [(0.3 * rng.standard_normal(s)).astype(np.float32)
                        for s in shapes]}


def _mlp_rows(n=64, d=16, classes=4, seed=1):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (classes, d))
    labels = rng.integers(0, classes, n)
    x = (protos[labels] + 0.3 * rng.standard_normal((n, d))).astype(
        np.float32)
    return {"features": x, "label": np.eye(classes, dtype=np.float32)[labels]}


# ---------------------------------------------------------------------------
# the plan and the host selection, bit for bit
# ---------------------------------------------------------------------------

def _random_shapes(rng):
    shapes = []
    for _ in range(int(rng.integers(1, 9))):
        ndim = int(rng.integers(0, 4))
        shapes.append(tuple(int(d) for d in rng.integers(1, 41, ndim)))
    dtypes = [rng.choice([np.float32, np.float16, np.int8])
              for _ in shapes]
    return shapes, dtypes


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 5])
def test_shard_plan_and_split_sparse_match_jax(num_shards):
    rng = np.random.default_rng(num_shards)
    for _ in range(12):
        shapes, dtypes = _random_shapes(rng)
        jplan = jsh.make_shard_plan(shapes, dtypes, num_shards)
        pplan = psh.make_shard_plan(shapes, dtypes, num_shards)
        assert ([[tuple(s) for s in a] for a in pplan.assignments]
                == [[tuple(s) for s in a] for a in jplan.assignments])
        assert pplan.shard_bytes() == jplan.shard_bytes()
        total = pplan.flat_elements()
        assert total == jplan.flat_elements()
        assert pplan.shard_elements() == jplan.shard_elements()
        k = int(rng.integers(1, total + 1))
        idx = np.sort(rng.choice(total, k, replace=False)).astype(np.int32)
        vals = rng.standard_normal(k).astype(np.float32)
        np.testing.assert_array_equal(pplan.shard_of_flat(idx),
                                      jplan.shard_of_flat(idx))
        for (pi, pv), (ji, jv) in zip(pplan.split_sparse(idx, vals),
                                      jplan.split_sparse(idx, vals)):
            assert pi.dtype == ji.dtype == np.int32
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pv, jv)
        bf = pplan.split_sparse(idx, torch.from_numpy(vals)
                                .to(torch.bfloat16))
        jbf = jplan.split_sparse(idx, vals.astype(ml_dtypes.bfloat16))
        for (_, pv), (_, jv) in zip(bf, jbf):
            assert _bytes(pv) == _bytes(jv)


def _tie_free(rng, n=600):
    """Distinct magnitudes: a shuffled ladder of well-separated values."""
    mags = np.linspace(1e-3, 1.0, n).astype(np.float32)
    return (rng.permutation(mags)
            * rng.choice([-1.0, 1.0], n)).astype(np.float32)


@pytest.mark.parametrize("code", [None, "bfloat16", "int8"])
def test_topk_select_matches_jax(code):
    rng = np.random.default_rng(9)
    for k in (1, 7, 60, 600):
        eff = _tie_free(rng)
        pi, pw, pa, ps_, pr = pworkers.topk_select(eff.copy(), k, code)
        ji, jw, ja, js, jr = jworkers.topk_select(eff.copy(), k, code)
        np.testing.assert_array_equal(pi, ji)
        assert pi.dtype == ji.dtype == np.int32
        assert _bytes(pw) == _bytes(jw)
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pr, jr)
        assert ps_ == js


# ---------------------------------------------------------------------------
# the device selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", [None, "bfloat16", "int8"])
def test_device_selection_agrees_with_jax(code):
    """One top-k window of the 784→64→10 MLP from the same weights and
    rows in both packages (the port's on the CPU)."""
    blob = _mlp_blob(d=784, hidden=64, classes=10, seed=2)
    kw = dict(wire_dtype="topk", wire_topk=0.01, wire_topk_dtype=code,
              batch_size=16, learning_rate=0.1)
    jw = jworkers.DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", 1, **kw)
    pw = pworkers.DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", 1,
                                 device="cpu", **kw)
    rng = np.random.default_rng(3)
    xw = rng.uniform(0, 1, (4, 16, 784)).astype(np.float32)
    yw = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (4, 16))]
    mw = np.ones((4, 16), np.float32)
    base = np.concatenate([w.reshape(-1) for w in blob["weights"]])

    jw._ensure_model()
    params = jax.tree_util.tree_map(jax.numpy.array, jw._params0)
    params, _, _, codes, idx, scale = jw._run_topk_window(
        params, jw._tx.init(params), xw, yw, mw, jax.random.PRNGKey(0))
    jsp = jw._fetch_sparse(codes, idx, scale)
    j_after = np.concatenate([np.asarray(w).reshape(-1)
                              for w in jw._params_to_weights(params)])
    j_res = np.asarray(jw._residual_dev)

    pw._ensure_model()
    p = pw._params
    _, _, packed = pw._run_topk_window(
        p, pw._tx.init(list(p.values())), torch.from_numpy(xw),
        torch.from_numpy(yw), mw, pw._generator(0))
    psp, _ = pw._fetch_sparse(packed)
    p_after = np.concatenate([w.reshape(-1)
                              for w in pw._params_to_weights()])
    p_res = pw._residual_dev.numpy()

    j_delta, p_delta = j_after - base, p_after - base
    # the f32 noise between the packages' windows: a few ulps of the
    # weights (the deltas are differences of weights), or 1e-5·max|delta|
    margin = max(1e-5 * float(np.max(np.abs(j_delta))),
                 4 * float(np.spacing(np.max(np.abs(base)))))
    np.testing.assert_allclose(p_delta, j_delta, rtol=0, atol=margin)
    # each side's identity
    np.testing.assert_allclose(j_delta, jsp.to_dense() + j_res, atol=margin)
    np.testing.assert_allclose(p_delta, psp.to_dense() + p_res, atol=margin)
    # the selections agree wherever the k-th magnitude gap exceeds noise
    k = pw._wire_k
    assert psp.nnz == jsp.nnz == k
    mag = np.abs(j_delta)
    thr = np.sort(mag)[-k]
    j_sel = np.zeros(mag.size, bool)
    j_sel[np.asarray(jsp.indices)] = True
    p_sel = np.zeros(mag.size, bool)
    p_sel[psp.indices] = True
    sure_in, sure_out = mag > thr + margin, mag < thr - margin
    assert j_sel[sure_in].all() and p_sel[sure_in].all()
    assert not j_sel[sure_out].any() and not p_sel[sure_out].any()
    assert (j_sel == p_sel).mean() > 0.99
    # the values the two selections share
    both = np.intersect1d(np.asarray(jsp.indices), psp.indices)
    jv = dict(zip(np.asarray(jsp.indices), jsp.f32_values()))
    pv = dict(zip(psp.indices, psp.f32_values()))
    jb = np.array([jv[i] for i in both])
    pb = np.array([pv[i] for i in both])
    if code == "int8":
        assert psp.scale == pytest.approx(jsp.scale, rel=1e-5)
        np.testing.assert_allclose(pb, jb, atol=1.01 * jsp.scale + margin)
    elif code == "bfloat16":
        np.testing.assert_allclose(pb, jb, rtol=2 ** -7, atol=margin)
    else:
        np.testing.assert_allclose(pb, jb, rtol=0, atol=margin)


# ---------------------------------------------------------------------------
# interop: port workers into JAX groups and back
# ---------------------------------------------------------------------------

V, EMB = 64, 8


def _click_blob():
    model = JaxSequential([jl.Embedding(V, EMB), jl.Flatten(),
                           jl.Dense(4, activation="softmax")],
                          input_shape=(1,), compute_dtype="float32")
    params = model.init(jax.random.PRNGKey(1))
    return {"model": model.to_json(),
            "weights": [np.asarray(w, np.float32)
                        for w in model.get_weights(params)]}


def _click_rows(n=64):
    rng = np.random.default_rng(2)
    items = rng.integers(0, V, n).astype(np.int32).reshape(-1, 1)
    mapping = np.random.default_rng(0).integers(0, 4, V)
    return {"features": items,
            "label": np.eye(4, dtype=np.float32)[mapping[items[:, 0]]]}


INTEROP = {
    "topk-f32-3": (3, dict(wire_dtype="topk", wire_topk=0.05)),
    "topk-bf16-3": (3, dict(wire_dtype="topk", wire_topk=0.05,
                            wire_topk_dtype="bfloat16")),
    "topk-int8-2": (2, dict(wire_dtype="topk", wire_topk=0.05,
                            wire_topk_dtype="int8")),
    "rowsparse-3": (3, dict(row_sparse_tables=[0], comm_overlap=False)),
    "bf16-2": (2, dict(wire_dtype="bfloat16")),
}


#: one compiled JAX worker per interop configuration: later JAX workers
#: of that configuration share its jitted programs (share_compiled_state)
_JAX_COMPILED = {}


def _interop_run(group_pkg, worker_pkgs, shards, kw):
    """Run one worker of each package in ``worker_pkgs`` (each into its
    own ``group_pkg`` group); returns [(center, clocks, history)]."""
    rows = kw.get("row_sparse_tables") and _click_rows() or _mlp_rows()
    blob = _click_blob() if kw.get("row_sparse_tables") else _mlp_blob()
    kw = dict(dict(comm_overlap=True), **kw)
    common = dict(communication_window=2, batch_size=8, learning_rate=0.1,
                  **kw)
    shapes = [w.shape for w in blob["weights"]]
    dtypes = [w.dtype for w in blob["weights"]]
    out = []
    for worker_pkg in worker_pkgs:
        mod = jsh if group_pkg == "jax" else psh
        group = mod.ShardedServerGroup("downpour", blob, 1, shards)
        group.start()
        try:
            if worker_pkg == "jax":
                w = jworkers.DOWNPOURWorker(
                    blob, "sgd", "categorical_crossentropy", "127.0.0.1", 0,
                    shard_plan=jsh.make_shard_plan(shapes, dtypes, shards),
                    shard_addrs=group.addrs, **common)
                head = _JAX_COMPILED.setdefault(repr(sorted(kw.items())), w)
                jworkers.share_compiled_state([head, w])
            else:
                w = pworkers.DOWNPOURWorker(
                    blob, "sgd", "categorical_crossentropy", "127.0.0.1", 0,
                    shard_plan=psh.make_shard_plan(shapes, dtypes, shards),
                    shard_addrs=group.addrs, device="cpu", **common)
            w.train(0, rows)
            # one 'u' a window a shard (the row-sparse step is one 'u' too)
            assert w.transport_ops == shards * (1 + w._commits)
        finally:
            group.stop()
        center, clocks = group.snapshot()
        out.append((center, clocks, [float(h) for h in w.history]))
    return out


def _assert_same_run(a, b):
    (ca, ka, ha), (cb, kb, hb) = a, b
    assert ka == kb and min(ka) > 0
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x, y)
    assert ha == hb


@pytest.mark.parametrize("case", sorted(INTEROP))
def test_port_worker_into_jax_group(case):
    shards, kw = INTEROP[case]
    into_jax, = _interop_run("jax", ["torch"], shards, kw)
    into_port, = _interop_run("torch", ["torch"], shards, kw)
    _assert_same_run(into_jax, into_port)


@pytest.mark.parametrize("case", sorted(INTEROP))
def test_jax_worker_into_port_group(case):
    shards, kw = INTEROP[case]
    into_port, = _interop_run("torch", ["jax"], shards, kw)
    into_jax, = _interop_run("jax", ["jax"], shards, kw)
    _assert_same_run(into_port, into_jax)


# ---------------------------------------------------------------------------
# sharded checkpoints across the packages
# ---------------------------------------------------------------------------

D, C = 10, 3


def _stack(m):
    return [m.Dense(16, activation="relu"), m.Dense(C, activation="softmax")]


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    jm = JaxSequential(_stack(jl), input_shape=(D,), compute_dtype="float32")
    shapes = [w.shape for w in jm.get_weights(jm.init(jax.random.PRNGKey(0)))]
    return [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _rows(rows=64, seed=1):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (C, D))
    labels = rng.integers(0, C, rows)
    x = (protos[labels] + 0.3 * rng.standard_normal((rows, D))).astype(
        np.float32)
    return {"features": x,
            "label_encoded": np.eye(C, dtype=np.float32)[labels]}


def _trainer(pkg, ckpt, num_epoch):
    weights = _weights()
    kw = dict(num_workers=1, batch_size=8, num_epoch=num_epoch,
              communication_window=4, label_col="label_encoded", seed=3,
              execution="host_ps", ps_shards=2, worker_optimizer="sgd",
              learning_rate=0.05, checkpoint_dir=ckpt)
    if pkg == "jax":
        jm = JaxSequential(_stack(jl), input_shape=(D,),
                           compute_dtype="float32")
        model = JaxFitted(jm, jm.set_weights(jm.init(jax.random.PRNGKey(0)),
                                             weights))
        return jdk.ADAG(model, **kw), jdk.Dataset(_rows())
    pm = port.Sequential(_stack(pl), input_shape=(D,),
                         compute_dtype="float32", device="cpu")
    return (port.ADAG(port.FittedModel(load_jax_weights(pm, weights)),
                      device="cpu", **kw), port.Dataset(_rows()))


def _saved_clocks(ck, step):
    """The per-shard clock vector of a host-PS npz checkpoint: the leaf
    after the center's (the state's keys sort center, clock, workers in
    both packages)."""
    n_center = len(_weights())
    with np.load(f"{ck}/ckpt_{step}.npz") as z:
        return [int(c) for c in z[f"leaf_{n_center}"]]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_sharded_checkpoint_resumes_across_packages(tmp_path, writer,
                                                    reader):
    ck = str(tmp_path / "ck")
    t, ds = _trainer(writer, ck, 1)
    saved = [np.asarray(w) for w in t.train(ds).get_weights()]
    assert _saved_clocks(ck, 1) == [2, 2]  # 64 rows / (4 x 8) a shard
    # resumed at epoch 1 of 1, the reader returns the restored center
    r, ds = _trainer(reader, ck, 1)
    got = [np.asarray(w) for w in r.train(ds, resume=True).get_weights()]
    for a, b in zip(got, saved):
        np.testing.assert_array_equal(a, b)
    # resumed for a second epoch, its clocks go on from the restored ones
    r, ds = _trainer(reader, ck, 2)
    r.train(ds, resume=True)
    assert len(r.get_history()) == 2
    assert _saved_clocks(ck, 2) == [4, 4]


def test_port_trains_on_from_a_jax_sharded_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    t, ds = _trainer("jax", ck, 1)
    t.train(ds)
    ck2 = str(tmp_path / "ck2")
    import shutil
    shutil.copytree(ck, ck2)
    jt, jds = _trainer("jax", ck, 2)
    want = jt.train(jds, resume=True).get_weights()
    pt, pds = _trainer("torch", ck2, 2)
    got = pt.train(pds, resume=True).get_weights()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    assert _saved_clocks(ck, 2) == _saved_clocks(ck2, 2) == [4, 4]
