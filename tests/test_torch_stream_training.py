"""The port's streaming trainer (``stream=True`` on ``execution="host_ps"``,
``streaming.run_stream_training``) against the JAX package, on the CPU.

 - **The knobs**: every value the JAX trainer refuses is refused with the
   JAX message (the constructor's checks, ``train``'s dispatch and the
   horizon loop's own refusals), as one parametrised test.
 - **One worker, within f32**: one worker makes the async order
   deterministic, so the port's per-horizon centers (read in
   ``on_horizon``) and window losses equal a JAX oracle's within rtol
   1e-5, atol 1e-6 (the host-PS parity bands), for DOWNPOUR and ADAG on
   an MLP and for DOWNPOUR on a 2-layer narrow LM.  The oracle is built
   from the JAX package's public parts: a JAX PS and socket server, a JAX
   ``LeaseLedger`` and one JAX worker's ``train_leases`` per horizon over
   the same permutation, its center read once the server's clock reached
   the worker's commits (a JAX ``run_stream_training`` reads its center
   without that wait, so it is no oracle; ROADMAP C).
 - **The JAX acceptance cases at their sizes**: accuracy tracks a
   drifting stream; killing workers mid-horizon loses no example (every
   horizon's ledger complete) for (DOWNPOUR, 1 shard) and (ADAG, 3
   shards); the tail horizon takes the remainder; ``max_horizons`` ends an
   unbounded source; ``stream=False`` runs as before.
 - **The seams and stats**: ``_on_ps_ready`` fires once, before any
   commit; ``stream_stats`` and ``elastic_stats`` carry the JAX keys.
"""

import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as port
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu import resilience as jres
from distkeras_tpu import streaming as jstream
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import FittedModel as JFitted
from distkeras_tpu.core.model import Sequential as JSequential
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.workers import WORKER_CLASSES as JAX_WORKERS
from distkeras_tpu_torch import StreamSource
from distkeras_tpu_torch import streaming as pstream
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.core.model import load_jax_weights

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
V, D, C = 64, 8, 4  # the click-stream's vocabulary, embedding, classes


# ---------------------------------------------------------------------------
# models and streams
# ---------------------------------------------------------------------------

def embedding_model():
    return port.Sequential([pl.Embedding(V, D), pl.Flatten(),
                            pl.Dense(C, activation="softmax")],
                           input_shape=(1,), compute_dtype="float32",
                           device="cpu")


def make_mapping(seed=0):
    return np.random.default_rng(seed).integers(0, C, V)


def click_chunks(mapping, num_chunks, rows=64, seed=0, drift_to=None,
                 drift_at=None):
    rng = np.random.default_rng(seed)
    for i in range(num_chunks):
        m = (drift_to if drift_at is not None and i >= drift_at
             else mapping)
        items = rng.integers(0, V, rows).astype(np.int32).reshape(-1, 1)
        yield items, np.eye(C, dtype=np.float32)[m[items[:, 0]]]


def mapping_accuracy(fitted, mapping):
    items = np.arange(V, dtype=np.int32).reshape(-1, 1)
    return float((fitted.predict(items).argmax(-1) == mapping).mean())


def trainer(cls=port.DOWNPOUR, model=None, **kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("batch_size", 16)
    kw.setdefault("num_epoch", 1)
    kw.setdefault("communication_window", 2)
    kw.setdefault("learning_rate", 0.5)
    kw.setdefault("execution", "host_ps")
    kw.setdefault("device", "cpu")
    return cls(model if model is not None else embedding_model(), **kw)


# ---------------------------------------------------------------------------
# the knobs, message for message
# ---------------------------------------------------------------------------

def _jax_embedding_model():
    return JSequential([jl.Embedding(V, D), jl.Flatten(),
                        jl.Dense(C, activation="softmax")],
                       input_shape=(1,), compute_dtype="float32")


def _empty():
    return iter(())


KNOB_CASES = {
    "spmd": (dict(stream=True), None),
    "process_ps": (dict(execution="process_ps", stream=True), None),
    "horizon_windows_0": (dict(execution="host_ps", stream=True,
                               horizon_windows=0), None),
    "horizon_windows_without_stream": (dict(execution="host_ps",
                                            horizon_windows=4), None),
    "max_horizons_0": (dict(execution="host_ps", stream=True,
                            max_horizons=0), None),
    "max_horizons_without_stream": (dict(execution="host_ps",
                                         max_horizons=1), None),
    "a_dataset": (dict(execution="host_ps", stream=True), "dataset"),
    "checkpoint_dir": (dict(execution="host_ps", stream=True,
                            checkpoint_dir="ckpt"), "source"),
    "resume": (dict(execution="host_ps", stream=True), "resume"),
    "an_empty_stream": (dict(execution="host_ps", stream=True), "source"),
}


def _raise(pkg, kw, call, tmp_path):
    """The ValueError of one knob case in ``pkg`` (jdk or port)."""
    kw = dict(kw)
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / f"{pkg.__name__}_ck")
    model = _jax_embedding_model() if pkg is jdk else embedding_model()
    if pkg is port:
        kw["device"] = "cpu"
    src_cls = (jstream.StreamSource if pkg is jdk else StreamSource)
    with pytest.raises(ValueError) as e:
        t = pkg.DOWNPOUR(model, num_workers=1, batch_size=16, **kw)
        if call == "dataset":
            t.train(pkg.Dataset({"features": np.zeros((4, 1), np.int32),
                                 "label": np.zeros((4, C), np.float32)}))
        elif call == "resume":
            t.train(src_cls(generator=_empty()), resume=True)
        elif call == "source":
            t.train(src_cls(generator=_empty()))
    return str(e.value)


@pytest.mark.parametrize("case", sorted(KNOB_CASES) + ["not_a_ps_trainer"])
def test_stream_refusals_match_jax(case, tmp_path):
    if case == "not_a_ps_trainer":
        msgs = []
        for mod, src in ((jstream, jstream.StreamSource),
                         (pstream, StreamSource)):
            with pytest.raises(ValueError) as e:
                mod.run_stream_training(SimpleNamespace(ALGORITHM="local"),
                                        src(generator=_empty()))
            msgs.append(str(e.value))
    else:
        kw, call = KNOB_CASES[case]
        msgs = [_raise(pkg, kw, call, tmp_path) for pkg in (jdk, port)]
    assert msgs[0] == msgs[1]


def test_stream_knobs_are_taken():
    t = trainer(stream=True)
    assert t.stream is True and t.horizon_windows is None
    assert t.max_horizons is None and t.on_horizon is None
    assert t.stream_stats == {}
    t = trainer(stream=True, horizon_windows=4, max_horizons=2)
    assert (t.horizon_windows, t.max_horizons) == (4, 2)
    assert trainer().stream is False


# ---------------------------------------------------------------------------
# one worker against the JAX oracle
# ---------------------------------------------------------------------------

FEATURES, CLASSES = 10, 3


def _mlp_stack(m):
    return [m.Dense(16, activation="relu"),
            m.Dense(CLASSES, activation="softmax")]


def _mlp_pair(seed=0):
    rng = np.random.default_rng(seed)
    jm = JSequential(_mlp_stack(jl), input_shape=(FEATURES,),
                     compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    w = [(0.3 * rng.standard_normal(a.shape)).astype(np.float32)
         for a in jm.get_weights(params)]
    pm = port.Sequential(_mlp_stack(pl), input_shape=(FEATURES,),
                         compute_dtype="float32", device="cpu")
    return JFitted(jm, jm.set_weights(params, w)), load_jax_weights(pm, w)


def _mlp_chunks(num_chunks=5, rows=48, seed=1):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (CLASSES, FEATURES))
    out = []
    for _ in range(num_chunks):
        labels = rng.integers(0, CLASSES, rows)
        x = (protos[labels] + 0.3 * rng.standard_normal(
            (rows, FEATURES))).astype(np.float32)
        out.append((x, np.eye(CLASSES, dtype=np.float32)[labels]))
    return out


LM_CFG = dict(vocab_size=16, seq_len=8, d_model=16, num_heads=2,
              num_layers=2, mlp_dim=32, compute_dtype="float32")


def _lm_pair(seed=0):
    jm = jax_lm(**LM_CFG)
    params = jm.init(jax.random.PRNGKey(0), (LM_CFG["seq_len"],))
    rng = np.random.default_rng(seed)
    w = [(rng.standard_normal(a.shape) / np.sqrt(a.shape[0])
          if a.ndim == 2 else 0.1 * rng.standard_normal(a.shape)
          + (a.ndim == 1)).astype(np.float32)
         for a in jm.get_weights(params)]
    pm = port.transformer_lm(**LM_CFG, device="cpu")
    return JFitted(jm, jm.set_weights(params, w)), load_jax_weights(pm, w)


def _lm_chunks(num_chunks=3, rows=24, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_chunks):
        x = rng.integers(0, 16, (rows, LM_CFG["seq_len"])).astype(np.int32)
        out.append((x, ((x + 1) % 16).astype(np.int32)))
    return out


def jax_stream_oracle(jt, jfitted, chunks, horizon_windows):
    """One JAX worker trained horizon by horizon over the JAX stream:
    per horizon, ``default_rng(seed + 7919 · h)``'s permutation, the
    ledger resized and begun, the worker's ``train_leases``, the center
    read once the server's clock reached the worker's commits.  Returns
    (window losses, per-horizon centers)."""
    blob = jfitted.serialize()
    ps = jps.allocate_parameter_server(jt.ALGORITHM, blob, 1)
    server = jps.make_socket_server(ps)
    server.start()
    win_rows = jt.communication_window * jt.batch_size
    horizon_rows = horizon_windows * win_rows
    try:
        kw = jps._worker_kwargs(jt, 1, horizon_rows)
        kw.update(worker_optimizer=jt.worker_optimizer,
                  ps_host="127.0.0.1", ps_port=server.port)
        worker = JAX_WORKERS[jt.ALGORITHM](blob, **kw)
        src = jstream.StreamSource(generator=iter(chunks))
        chunk = src.read(horizon_rows)
        ledger = jres.LeaseLedger(len(chunk[0]), win_rows,
                                  max(1, horizon_windows // 4),
                                  min_deadline=600.0)
        centers, state, h = [], None, 0
        while chunk is not None:
            perm = np.random.default_rng(jt.seed + 7919 * h).permutation(
                len(chunk[0]))
            hx, hy = chunk[0][perm], chunk[1][perm]
            ledger.resize(len(hx))
            ledger.begin_epoch(h)
            res = worker.train_leases(
                0, ledger, lambda l: (hx[l.start:l.stop], hy[l.start:l.stop]),
                initial_state=state)
            state = res["state"]
            deadline = time.monotonic() + 30.0
            while ps.num_updates < worker._commits:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            ledger.assert_epoch_complete(h)
            with ps._lock:
                centers.append([w.copy() for w in ps.center])
            h += 1
            chunk = src.read(horizon_rows)
    finally:
        server.stop()
    return list(worker.history), centers


def _optimizer(pkg, name):
    if name == "ADAG":
        return dict(worker_optimizer=pkg.Adam(3e-3, epsilon=1e-4),
                    learning_rate=3e-3)
    return dict(worker_optimizer="sgd", learning_rate=0.05)


@pytest.mark.parametrize("name,model", [("DOWNPOUR", "mlp"),
                                        ("ADAG", "mlp"),
                                        ("DOWNPOUR", "lm")])
def test_one_worker_stream_matches_the_jax_oracle(name, model):
    jf, pm = _mlp_pair() if model == "mlp" else _lm_pair()
    chunks = _mlp_chunks() if model == "mlp" else _lm_chunks()
    common = dict(num_workers=1, batch_size=8, num_epoch=1,
                  communication_window=2, seed=5, execution="host_ps",
                  stream=True, horizon_windows=4)
    if model == "lm":
        common["loss"] = "sparse_categorical_crossentropy_from_logits"
    jt = getattr(jdk, name)(jf, **common, **_optimizer(jdk, name))
    jhist, jcenters = jax_stream_oracle(jt, jf, chunks, 4)
    pt = getattr(port, name)(port.FittedModel(pm), device="cpu",
                             lease_timeout=600.0, **common,
                             **_optimizer(port, name))
    centers = []
    pt.on_horizon = lambda h, f: centers.append(f.get_weights())
    pfit = pt.train(StreamSource(generator=iter(chunks)))
    rows = sum(len(c[0]) for c in chunks)
    assert pt.stream_stats["rows"] == rows
    assert pt.stream_stats["horizons"] == len(jcenters) == len(centers)
    assert len(pt.get_history()) == len(jhist) > 0
    np.testing.assert_allclose(pt.get_history(), jhist, **TOL)
    for ours, theirs in zip(centers, jcenters):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(pfit.get_weights(), jcenters[-1]):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# the JAX acceptance cases, at their sizes
# ---------------------------------------------------------------------------

def test_stream_training_accuracy_tracks_drift():
    map_a = make_mapping(seed=0)
    map_b = map_a.copy()
    flip = np.random.default_rng(1).permutation(V)[: V // 2]
    map_b[flip] = (map_b[flip] + 1) % C
    gen = click_chunks(map_a, num_chunks=24, rows=64, seed=2,
                       drift_to=map_b, drift_at=12)
    accs = []
    t = trainer(stream=True, horizon_windows=12, row_sparse=True)
    t.on_horizon = lambda h, f: accs.append(
        mapping_accuracy(f, map_a if h < 2 else map_b))
    fitted = t.train(StreamSource(generator=gen))
    assert t.stream_stats["horizons"] == 4
    assert t.stream_stats["rows"] == 24 * 64
    assert accs[1] > 0.6, accs
    assert accs[-1] > 0.8 and accs[-1] >= accs[1], accs
    assert mapping_accuracy(fitted, map_b) > 0.8
    for h in range(4):
        rep = t.elastic_stats["lease_completions"][h]
        assert rep["completed"] == rep["leases"]


@pytest.mark.parametrize("name,shards", [("DOWNPOUR", 1), ("ADAG", 3)])
def test_killing_workers_mid_horizon_loses_no_example(name, shards):
    mapping = make_mapping()
    t = trainer(getattr(port, name), num_workers=4, stream=True,
                horizon_windows=16, row_sparse=True, ps_shards=shards,
                lease_timeout=0.5,
                fault_injection={1: ("exit", 2), 2: ("hang", 3)})
    fitted = t.train(StreamSource(
        generator=click_chunks(mapping, num_chunks=24, rows=64, seed=3)))
    stats = t.elastic_stats
    assert t.stream_stats["rows"] == 24 * 64
    for h in range(t.stream_stats["horizons"]):
        rep = stats["lease_completions"][h]
        assert rep["completed"] == rep["leases"], rep
        assert rep["rows_completed"] == 512
    assert {1, 2} <= set(t.failed_workers)
    assert stats["respawns"] >= 1
    for w in t._ps_workers:
        client = getattr(w, "_shard_client", None)
        regressions = (client.clock_regressions if client is not None
                       else w.clock_regressions)
        assert regressions == 0
    assert mapping_accuracy(fitted, mapping) > 0.7


def test_the_tail_horizon_takes_the_remainder():
    # 5 chunks of 64 rows = 320; a horizon = 4 windows x 2 x 16 = 128 rows
    t = trainer(stream=True, horizon_windows=4)
    t.train(StreamSource(generator=click_chunks(make_mapping(), 5, seed=4)))
    assert t.stream_stats["horizons"] == 3
    assert t.stream_stats["rows"] == 320
    reps = t.elastic_stats["lease_completions"]
    assert [reps[h]["rows_completed"] for h in range(3)] == [128, 128, 64]
    assert t.stream_stats["buffer"]["rows_out"] == 320


def test_max_horizons_bounds_an_unbounded_source():
    mapping = make_mapping()

    def forever():
        rng = np.random.default_rng(5)
        while True:
            items = rng.integers(0, V, 64).astype(np.int32).reshape(-1, 1)
            yield items, np.eye(C, dtype=np.float32)[mapping[items[:, 0]]]

    t = trainer(stream=True, horizon_windows=4, max_horizons=2)
    t.train(StreamSource(generator=forever()))
    assert t.stream_stats["horizons"] == 2
    assert t.stream_stats["rows"] == 2 * 128


def test_stream_false_runs_as_before():
    ds = port.Dataset(dict(zip(("features", "label"), next(click_chunks(
        make_mapping(), 1, rows=256)))))

    def run():
        t = trainer()
        return t, t.train(ds).get_weights()

    (t1, w1), (_, w2) = run(), run()
    assert t1.stream is False and t1.row_sparse is None
    assert t1.stream_stats == {}
    assert not hasattr(t1, "_worker_supervisor")
    for a, b in zip(w1, w2):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the seams and the stats
# ---------------------------------------------------------------------------

def test_on_ps_ready_fires_once_before_any_commit():
    calls = []
    t = trainer(stream=True, horizon_windows=4)

    def ready(server, addr):
        calls.append((addr, server.ps.num_updates))

    t._on_ps_ready = ready
    t.train(StreamSource(generator=click_chunks(make_mapping(), 4, seed=6)))
    assert len(calls) == 1
    (host, port_), clock = calls[0]
    assert clock == 0 and host == "127.0.0.1"
    assert (host, port_) == t._ps_advertise_addr
    assert t._ps_server.ps.num_updates > 0


def test_stream_and_elastic_stats_carry_the_jax_keys():
    """The same small stream through both trainers: the stats' keys, the
    horizon and row counts, and the per-horizon report keys agree (the
    JAX run is read for its keys only, not as an oracle)."""
    chunks = list(click_chunks(make_mapping(), 4, seed=7))
    jt = jdk.DOWNPOUR(_jax_embedding_model(), num_workers=2, batch_size=16,
                      num_epoch=1, communication_window=2, learning_rate=0.5,
                      execution="host_ps", stream=True, horizon_windows=4)
    jt.train(jstream.StreamSource(generator=iter(chunks)))
    pt = trainer(num_workers=2, stream=True, horizon_windows=4)
    pt.train(StreamSource(generator=iter(chunks)))
    assert set(pt.stream_stats) == set(jt.stream_stats)
    assert set(pt.stream_stats["buffer"]) == set(jt.stream_stats["buffer"])
    assert set(pt.elastic_stats) == set(jt.elastic_stats)
    for k in ("horizons", "rows", "horizon_rows"):
        assert pt.stream_stats[k] == jt.stream_stats[k], k
    assert pt.stream_stats["buffer"] == jt.stream_stats["buffer"]
    assert (set(pt.elastic_stats["lease_completions"][0])
            == set(jt.elastic_stats["lease_completions"][0]))
    assert pt.stream_stats["examples_per_sec"] > 0
