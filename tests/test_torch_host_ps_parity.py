"""The port's host parameter server and PS workers against the JAX
package's, on the CPU.

 - **Server side, bit for bit.**  The same commit sequences (dense f32,
   int8 codes + scales decoded at the transport boundary, bf16 leaves,
   hand-built ``SparseDelta``s, coalesced drains with and without the
   ``_arrival`` stamp) go into a JAX and a port PS of each class
   (DOWNPOUR's delta server, ADAG's, DynSGD's): the two centers and
   clocks are identical.  A bf16 commit's bytes from the port worker
   equal the JAX worker's (``ml_dtypes`` and torch both round to nearest
   even).
 - **Worker side, within f32.**  One worker on ``execution="host_ps"``
   for each of the five algorithms, with ``comm_overlap`` off and on, 2
   epochs from one numpy weight set on the same rows: one worker makes
   the async order deterministic, so the port's window-loss history and
   final center equal the JAX run's within rtol 1e-5, atol 1e-6 (the
   SPMD parity's tolerance; Adam at epsilon 1e-4, ROADMAP's parity
   protocol for exact-zero gradients).
 - **The host-PS legs of the other JAX test files**, as port cases:
   BatchNorm statistics through the PS (``test_batchnorm.py:100``), the
   schedule refusals and a schedule with accumulation
   (``test_schedules.py:188-215``), ``parallelism_factor``
   (``test_trainers.py:187-200``), ``segment_col`` refused on host_ps
   (``test_packing.py:329``), the orbax refusal and the npz
   checkpoint/resume (``test_checkpoint_metrics.py:148-150, :252-330``),
   the resumed one-worker run bit-identical to the uninterrupted one.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as port
from distkeras_tpu import networking as jnet
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu.workers import DOWNPOURWorker as JaxDOWNPOURWorker
from distkeras_tpu_torch import networking as pnet
from distkeras_tpu_torch import parameter_servers as pps
from distkeras_tpu_torch.checkpoint import Checkpointer
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.core.model import load_jax_weights
from distkeras_tpu_torch.workers import DOWNPOURWorker

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(48,), (4, 8), (), (16,)]
TOTAL = sum(int(np.prod(s, dtype=np.int64)) for s in SHAPES)


# ---------------------------------------------------------------------------
# the server side: same commits, bit-identical centers and clocks
# ---------------------------------------------------------------------------

def _blob():
    return {"model": "{}",
            "weights": [np.zeros(s, np.float32) for s in SHAPES]}


def _servers(kind):
    if kind == "delta":
        return jps.DeltaParameterServer(_blob()), \
            pps.DeltaParameterServer(_blob())
    if kind == "adag":
        return jps.ADAGParameterServer(_blob(), 3), \
            pps.ADAGParameterServer(_blob(), 3)
    return jps.DynSGDParameterServer(_blob()), \
        pps.DynSGDParameterServer(_blob())


def _commit_pairs(rng):
    """(JAX message, port message) pairs of every wire form, decoded as
    each package's transport boundary decodes them."""
    pairs = []
    for clock in (0, 1, 0):
        d = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        pairs.append(({"delta": [a.copy() for a in d], "clock": clock},
                      {"delta": [a.copy() for a in d], "clock": clock}))
    # int8 codes + per-tensor scales, as the workers code them
    d = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    scales = [float(np.max(np.abs(a)) / 127.0) or 1.0 for a in d]
    codes = [np.clip(np.rint(a / s), -127, 127).astype(np.int8)
             for a, s in zip(d, scales)]
    pairs.append(tuple(
        mod._decode_commit_msg({"delta": [c.copy() for c in codes],
                                "scales": list(scales), "clock": 2})
        for mod in (jps, pps)))
    # bf16 leaves: ml_dtypes arrays on one side, torch tensors on the other
    d = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    pairs.append(({"delta": [a.astype(ml_dtypes.bfloat16) for a in d],
                   "clock": 1},
                  {"delta": [torch.from_numpy(np.array(a))
                             .to(torch.bfloat16) for a in d], "clock": 1}))
    # hand-built sparse commits (one unsorted sender), f32 and int8-coded
    for k, sort in ((12, True), (7, False), (20, True)):
        idx = rng.choice(TOTAL, size=k, replace=False).astype(np.int32)
        if sort:
            idx = np.sort(idx)
        vals = rng.standard_normal(k).astype(np.float32)
        pairs.append(({"delta": jnet.SparseDelta(idx, vals, TOTAL),
                       "clock": 3},
                      {"delta": pnet.SparseDelta(idx, vals, TOTAL),
                       "clock": 3}))
    idx = np.sort(rng.choice(TOTAL, 9, replace=False)).astype(np.int32)
    vals = rng.standard_normal(9).astype(np.float32)
    scale = float(np.max(np.abs(vals)) / 127.0)
    q = np.clip(np.rint(vals / scale), -127, 127).astype(np.int8)
    pairs.append(tuple(
        mod._decode_commit_msg({"delta": net.SparseDelta(idx, q, TOTAL,
                                                         scale),
                                "clock": 2})
        for mod, net in ((jps, jnet), (pps, pnet))))
    return pairs


def _assert_same(jax_ps, port_ps):
    assert jax_ps.num_updates == port_ps.num_updates
    for a, b in zip(jax_ps.center, port_ps.center):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["delta", "adag", "dynsgd"])
def test_sequential_commits_bit_identical(kind):
    jax_ps, port_ps = _servers(kind)
    for jm, pm in _commit_pairs(np.random.default_rng(0)):
        jax_ps.handle_commit(jm)
        port_ps.handle_commit(pm)
    _assert_same(jax_ps, port_ps)


@pytest.mark.parametrize("arrival", [False, True])
@pytest.mark.parametrize("kind", ["delta", "adag", "dynsgd"])
def test_coalesced_drains_bit_identical(kind, arrival):
    """The commits in three drains (dense runs split the sparse runs),
    with and without the event server's ``_arrival`` stamps."""
    jax_ps, port_ps = _servers(kind)
    pairs = _commit_pairs(np.random.default_rng(1))
    if arrival:
        for i, (jm, pm) in enumerate(pairs):
            jm["_arrival"] = pm["_arrival"] = i // 3
    for lo, hi in ((0, 4), (4, 7), (7, len(pairs))):
        cj = jax_ps.apply_drain([jm for jm, _ in pairs[lo:hi]])
        cp = port_ps.apply_drain([pm for _, pm in pairs[lo:hi]])
        assert cj == cp
    _assert_same(jax_ps, port_ps)


def test_bf16_commit_bytes_equal_the_jax_workers():
    """A bf16 commit from the port worker and from the JAX worker: the
    same delta, the same encoded frame byte for byte, and the same centre
    after both PSs apply it."""
    rng = np.random.default_rng(2)
    model = JaxSequential([jl.Dense(5)], input_shape=(3,),
                          compute_dtype="float32")
    blob = {"model": model.to_json(),
            "weights": [np.zeros((3, 5), np.float32),
                        np.zeros((5,), np.float32)]}
    jw = JaxDOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", 1,
                           wire_dtype="bfloat16")
    pw = DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", 1,
                        wire_dtype="bfloat16", device="cpu")
    # ties and subnormals on purpose: the rounding rule must agree
    delta = [rng.standard_normal((3, 5)).astype(np.float32),
             np.array([1.00390625, 1.01171875, -2.0 ** -130, 3e38, 0.0],
                      np.float32)]
    jmsg, japplied = jw._prepare_commit([d.copy() for d in delta], 0)
    pmsg, papplied = pw._prepare_commit([d.copy() for d in delta], 0)
    assert jnet.encode_message(jmsg) == pnet.encode_message(pmsg)
    for a, b in zip(japplied, papplied):
        np.testing.assert_array_equal(a, b)
    assert pw.commit_bytes == sum(d.size * 2 for d in delta)
    jax_ps = jps.DeltaParameterServer(blob)
    port_ps = pps.DeltaParameterServer(blob)
    jax_ps.handle_commit(jnet.decode_message(jnet.encode_message(jmsg)))
    port_ps.handle_commit(pnet.decode_message(pnet.encode_message(pmsg)))
    _assert_same(jax_ps, port_ps)


# ---------------------------------------------------------------------------
# the worker side: one worker, each algorithm, overlap off and on
# ---------------------------------------------------------------------------

D, C = 10, 3


def _stack(m):
    return [m.Dense(16, activation="relu"), m.Dense(C, activation="softmax")]


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    jm = JaxSequential(_stack(jl), input_shape=(D,), compute_dtype="float32")
    shapes = [w.shape for w in jm.get_weights(jm.init(jax.random.PRNGKey(0)))]
    return [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _jax_model(weights, stack=_stack, d=D):
    jm = JaxSequential(stack(jl), input_shape=(d,), compute_dtype="float32")
    return JaxFitted(jm, jm.set_weights(jm.init(jax.random.PRNGKey(0)),
                                        weights))


def _port_model(weights, stack=_stack, d=D):
    pm = port.Sequential(stack(pl), input_shape=(d,),
                         compute_dtype="float32", device="cpu")
    return port.FittedModel(load_jax_weights(pm, weights))


def _rows(rows=160, seed=1):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (C, D))
    labels = rng.integers(0, C, rows)
    x = (protos[labels] + 0.3 * rng.standard_normal((rows, D))).astype(
        np.float32)
    return {"features": x,
            "label_encoded": np.eye(C, dtype=np.float32)[labels]}


ALGORITHMS = {
    "ADAG": dict(worker_optimizer="adam-eps", learning_rate=3e-3),
    "DOWNPOUR": dict(worker_optimizer="sgd", learning_rate=0.05),
    "DynSGD": dict(worker_optimizer="sgd", learning_rate=0.05),
    "AEASGD": dict(worker_optimizer="adam-eps", learning_rate=3e-3,
                   rho=2.0),
    "EAMSGD": dict(learning_rate=0.05, rho=1.0, momentum=0.9),
}


def _optimizer(pkg, kw):
    kw = dict(kw)
    if kw.get("worker_optimizer") == "adam-eps":
        kw["worker_optimizer"] = pkg.Adam(kw["learning_rate"], epsilon=1e-4)
    return kw


def jax_one_worker(name, weights, rows, overlap, **common):
    """The JAX reference of a one-worker host-PS run, built from the JAX
    package's public parts: ``allocate_parameter_server`` and
    ``make_socket_server`` around the trainer's model blob, and one JAX
    worker's ``train`` over every row.  The center is read once the
    server's clock has reached the worker's commits.  (The JAX trainer
    stops its server as soon as the worker thread joins; its event loop
    can then exit with a serial worker's last fire-and-forget ``'c'``
    unread in the socket, so its center misses that commit now and then
    under load: this reference waits for it.)  Returns (window losses,
    center weights, the worker, the server's clock)."""
    import time

    from distkeras_tpu.workers import WORKER_CLASSES as JAX_WORKERS
    kw = dict(num_workers=1, batch_size=8, num_epoch=2,
              communication_window=4, label_col="label_encoded", seed=3,
              execution="host_ps", comm_overlap=overlap)
    kw.update(common)
    jt = getattr(jdk, name)(_jax_model(weights), **kw,
                            **_optimizer(jdk, ALGORITHMS[name]))
    blob = _jax_model(weights).serialize()
    ps = jps.allocate_parameter_server(jt.ALGORITHM, blob, 1)
    server = jps.make_socket_server(ps)
    server.start()
    try:
        extra = ({"rho": jt.rho} if jt.ALGORITHM in ("aeasgd", "eamsgd")
                 else {})
        worker = JAX_WORKERS[jt.ALGORITHM](
            blob, worker_optimizer=jt.worker_optimizer, loss=jt.loss,
            ps_host="127.0.0.1", ps_port=server.port,
            communication_window=jt.communication_window,
            features_col=jt.features_col, label_col=jt.label_col,
            batch_size=jt.batch_size, num_epoch=jt.num_epoch,
            learning_rate=jt.learning_rate, seed=jt.seed,
            comm_overlap=jt.comm_overlap, **extra)
        worker.train(0, {jt.features_col: rows["features"],
                         jt.label_col: rows[jt.label_col]})
        deadline = time.monotonic() + 30.0
        while ps.num_updates < worker._commits:
            assert time.monotonic() < deadline, (ps.num_updates,
                                                 worker._commits)
            time.sleep(0.001)
        with ps._lock:
            center = [w.copy() for w in ps.center]
            clock = ps.num_updates
    finally:
        server.stop()
    return list(worker.history), center, worker, clock


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_one_worker_matches_jax(name, overlap):
    weights, rows = _weights(), _rows()
    common = dict(num_workers=1, batch_size=8, num_epoch=2,
                  communication_window=4, label_col="label_encoded",
                  seed=3, execution="host_ps", comm_overlap=overlap)
    jhist, jcenter, jw, jclock = jax_one_worker(name, weights, rows,
                                                overlap)
    pt = getattr(port, name)(_port_model(weights), device="cpu", **common,
                             **_optimizer(port, ALGORITHMS[name]))
    pfit = pt.train(port.Dataset(rows))
    assert pt.comm_overlap is overlap
    # 160 rows / (window 4 x batch 8) = 5 windows an epoch
    assert len(pt.get_history()) == len(jhist) == 10
    np.testing.assert_allclose(pt.get_history(), jhist, **TOL)
    for a, b in zip(pfit.get_weights(), jcenter):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    (pw,) = pt._ps_workers
    assert pw._commits == jw._commits == 10
    assert pw.transport_ops == jw.transport_ops
    assert pt._ps_server.ps.num_updates == jclock == 10


def test_the_jax_trainer_can_lose_the_last_commit_and_the_port_waits(
        monkeypatch):
    """Which side loses the last commit: hold the JAX server's event loop
    for 0.3 s after it answers the last window's pull (EAMSGD pulls, then
    commits), as a loaded machine sometimes does.  The worker's last
    ``'c'`` and its ``'q'`` arrive meanwhile, the JAX trainer stops the
    server, and the loop exits with the commit unread: the JAX center has
    9 of 10 commits.  The port's trainer, held the same way, waits for the
    clock to reach the commits sent (``_await_applied``) and has all 10."""
    import time
    weights, rows = _weights(), _rows()
    common = dict(num_workers=1, batch_size=8, num_epoch=2,
                  communication_window=4, label_col="label_encoded",
                  seed=3, execution="host_ps", comm_overlap=False)
    servers = []
    for module in (jps, pps):
        cls = module.SocketParameterServer
        drain = cls._process_drain

        def held(self, entries, drain=drain):
            drain(self, entries)
            if self.ps.num_updates == 9 and any(
                    e[1] == b"p" for e in entries):
                time.sleep(0.3)  # the loop is late back to select()

        monkeypatch.setattr(cls, "_process_drain", held)
        make = module.make_socket_server

        def capture(*a, make=make, **k):
            servers.append(make(*a, **k))
            return servers[-1]

        monkeypatch.setattr(module, "make_socket_server", capture)
    jt = jdk.EAMSGD(_jax_model(weights), **common,
                    **_optimizer(jdk, ALGORITHMS["EAMSGD"]))
    jfit = jt.train(jdk.Dataset(rows))
    pt = port.EAMSGD(_port_model(weights), device="cpu", **common,
                     **_optimizer(port, ALGORITHMS["EAMSGD"]))
    pfit = pt.train(port.Dataset(rows))
    jserver, pserver = servers
    assert jt._ps_workers[0]._commits == pt._ps_workers[0]._commits == 10
    assert jserver.ps.num_updates == 9
    assert pserver.ps.num_updates == 10
    # the reference that waits has the commit the JAX trainer lost
    _, jcenter, _, jclock = jax_one_worker("EAMSGD", weights, rows, False)
    assert jclock == 10
    for a, b, c in zip(pfit.get_weights(), jcenter, jfit.get_weights()):
        np.testing.assert_allclose(a, b, **TOL)
    assert not all(np.allclose(a, np.asarray(c), **TOL)
                   for a, c in zip(pfit.get_weights(), jfit.get_weights()))


# ---------------------------------------------------------------------------
# the host-PS legs of the other JAX test files
# ---------------------------------------------------------------------------

NUM_CLASSES = 4


def _dataset(n=1024, d=16, seed=0, shift=None):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (NUM_CLASSES, d))
    labels = rng.integers(0, NUM_CLASSES, n)
    x = (protos[labels] + 0.3 * rng.standard_normal((n, d))).astype(
        np.float32)
    if shift is not None:
        x = (x * shift[1] + shift[0]).astype(np.float32)
    return port.Dataset({
        "features": x, "label": labels.astype(np.int64),
        "label_encoded": np.eye(NUM_CLASSES, dtype=np.float32)[labels]})


def _mlp(d=16):
    return port.Sequential(
        [port.Dense(32, activation="relu"),
         port.Dense(NUM_CLASSES, activation="softmax")],
        input_shape=(d,), compute_dtype="float32", device="cpu")


def _accuracy(fitted, ds):
    pred = fitted.predict(ds["features"])
    return float(np.mean(np.argmax(pred, axis=1) == ds["label"]))


def test_host_ps_bn_stats_update():
    """test_batchnorm.py:100: worker-side EMA'd statistics flow through
    the delta commits into the center; eval-mode inference works."""
    mean, std = np.linspace(-3, 3, 16), np.linspace(0.5, 4, 16)
    ds = _dataset(n=1024, shift=(mean, std))
    model = port.Sequential(
        [port.BatchNormalization(momentum=0.9),
         port.Dense(32, activation="relu"),
         port.Dense(NUM_CLASSES, activation="softmax")],
        input_shape=(16,), compute_dtype="float32", device="cpu")
    t = port.ADAG(model, num_workers=2, batch_size=32, num_epoch=6,
                  communication_window=4, label_col="label_encoded",
                  worker_optimizer="adam", learning_rate=3e-3,
                  execution="host_ps", device="cpu")
    fitted = t.train(ds)
    stats = fitted.model.layers[0].stats
    x = np.asarray(ds["features"])
    np.testing.assert_allclose(stats.mean.numpy(), x.mean(axis=0), atol=1.0)
    np.testing.assert_allclose(stats.var.numpy(), x.var(axis=0), rtol=0.5)
    assert _accuracy(fitted, ds) > 0.9


def test_validation_refused_on_host_ps():
    """test_schedules.py:188-200: validation and early stopping have no
    between-epoch hook on the PS engine."""
    ds = _dataset(n=256)
    kw = dict(num_workers=2, label_col="label_encoded",
              execution="host_ps", device="cpu")
    with pytest.raises(ValueError, match="between-epoch hook"):
        port.ADAG(_mlp(), **kw).train(ds, validation_data=ds)
    with pytest.raises(ValueError, match="between-epoch hook"):
        port.ADAG(_mlp(), early_stopping_patience=2, **kw).train(ds)


def test_host_ps_schedule_and_accumulation_converge():
    """test_schedules.py:203-215."""
    ds = _dataset(n=1024)
    t = port.ADAG(_mlp(), num_workers=2, batch_size=16, num_epoch=4,
                  communication_window=2, label_col="label_encoded",
                  worker_optimizer="sgd", learning_rate=0.3,
                  lr_schedule="warmup_cosine", gradient_accumulation=2,
                  execution="host_ps", device="cpu")
    assert _accuracy(t.train(ds), ds) > 0.9


def test_parallelism_factor():
    """test_trainers.py:187-200: factor x num_workers worker threads on
    host_ps; the SPMD engine refuses a factor > 1."""
    ds = _dataset(n=512)
    t = port.ADAG(_mlp(), num_workers=2, parallelism_factor=2,
                  batch_size=8, num_epoch=4, communication_window=2,
                  label_col="label_encoded", worker_optimizer="adam",
                  learning_rate=5e-3, execution="host_ps", device="cpu")
    fitted = t.train(ds)
    assert t.parallelism_factor == 2 and len(t._ps_workers) == 4
    assert _accuracy(fitted, ds) > 0.5
    with pytest.raises(ValueError):
        port.ADAG(_mlp(), device="cpu", parallelism_factor=2)
    with pytest.raises(ValueError):
        port.ADAG(_mlp(), execution="host_ps", device="cpu",
                  parallelism_factor=0)


def test_segment_col_refused_on_host_ps():
    """test_packing.py:329."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 16, (8, 8)).astype(np.int32)
    ds = port.Dataset({"features": tokens, "label": tokens,
                       "segment_ids": np.ones_like(tokens)})
    model = port.transformer_lm(vocab_size=16, seq_len=8, d_model=8,
                                num_heads=2, num_layers=1, mlp_dim=8,
                                positional="rope", device="cpu")
    with pytest.raises(ValueError, match="spmd"):
        port.ADAG(model, segment_col="segment_ids",
                  loss="sparse_categorical_crossentropy_masked",
                  execution="host_ps", device="cpu").train(ds)


def test_orbax_refused_on_host_ps(tmp_path):
    """test_checkpoint_metrics.py:148-150: the JAX class refuses resuming
    an npz directory through orbax; the port has no orbax backend and
    refuses it at construction, on host_ps too."""
    with pytest.raises(NotImplementedError, match="orbax"):
        port.ADAG(_mlp(), checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_backend="orbax", execution="host_ps",
                  device="cpu")


def _ckpt_kw(**over):
    kw = dict(num_workers=2, batch_size=8, num_epoch=4,
              communication_window=2, label_col="label_encoded",
              worker_optimizer="adam", learning_rate=5e-3, seed=3,
              execution="host_ps", device="cpu")
    kw.update(over)
    return kw


def test_host_ps_checkpoint_resume(tmp_path):
    """test_checkpoint_metrics.py:252-300: epoch-wave checkpoints hold the
    PS center and clock and every worker's optimizer state; a resumed
    run continues the clock and trains to the same quality."""
    ds = _dataset(n=512)
    ck_full = str(tmp_path / "ck_full")
    full = port.ADAG(_mlp(), checkpoint_dir=ck_full, **_ckpt_kw())
    assert _accuracy(full.train(ds), ds) > 0.8
    assert Checkpointer(ck_full).latest_step() == 4

    ck = str(tmp_path / "ck")
    port.ADAG(_mlp(), checkpoint_dir=ck, **_ckpt_kw(num_epoch=2)).train(ds)
    assert Checkpointer(ck).latest_step() == 2
    resumed = port.ADAG(_mlp(), checkpoint_dir=ck, **_ckpt_kw())
    fitted = resumed.train(ds, resume=True)
    assert Checkpointer(ck).latest_step() == 4
    # per worker: ceil(256 / (2 x 8)) = 16 windows an epoch, 2 epochs left
    assert len(resumed.get_history()) == 2 * 2 * 16
    assert _accuracy(fitted, ds) > 0.8
    # the clock went on: every window of all 4 epochs committed once
    assert resumed._ps_server.ps.num_updates == 4 * 2 * 16


def test_host_ps_resume_equals_uninterrupted_run(tmp_path):
    """One worker fixes the interleaving: 1 epoch + a resumed second one
    ends on the uninterrupted 2-epoch run's center, bit for bit (the
    optimizer state and the clock come back from the npz)."""
    ds = _dataset(n=256)
    kw = _ckpt_kw(num_workers=1, num_epoch=2)
    full = port.ADAG(_mlp(), checkpoint_dir=str(tmp_path / "a"), **kw)
    want = full.train(ds).get_weights()
    ck = str(tmp_path / "b")
    port.ADAG(_mlp(), checkpoint_dir=ck, **dict(kw, num_epoch=1)).train(ds)
    resumed = port.ADAG(_mlp(), checkpoint_dir=ck, **kw)
    got = resumed.train(ds, resume=True).get_weights()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert resumed.get_history() == full.get_history()[16:]


def test_checkpoint_engine_mismatch_refused(tmp_path):
    """test_checkpoint_metrics.py:320-330: an SPMD checkpoint does not
    resume on host_ps."""
    ds = _dataset(n=128)
    ck = str(tmp_path / "ck")
    port.ADAG(_mlp(), checkpoint_dir=ck, num_workers=1, batch_size=8,
              communication_window=2, label_col="label_encoded",
              device="cpu").train(ds)
    with pytest.raises(ValueError, match="engine"):
        port.ADAG(_mlp(), checkpoint_dir=ck, **_ckpt_kw(num_epoch=2)).train(
            ds, resume=True)
