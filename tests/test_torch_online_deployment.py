"""The port's online deployment (``deployment_online.py``) against the JAX
module's contract (``tests/test_online_deployment.py``), on the CPU.

 - **Freshness is exact accounting**: the port's ``FreshnessTracker`` and
   ``_weighted_percentile`` are fed the same events as the JAX ones and
   give the same stats, equal to the hand-computed instants.
 - **bind/advertise**: the same host pairs as the JAX resolver; a stream
   trains with the PS on a wildcard bind and the workers on loopback.
 - **OnlineDeployment**: the process graph runs end to end with an
   inline engine pumped from ``on_horizon`` — serving through every
   hot reload, served traffic fed back, freshness populated and mirrored,
   the served model learning the mapping; blue/green swaps are atomic
   (generations 1, 2, 3, every probe on one generation) and a pull into
   the warming clone never moves the weights the old engine serves; a
   killed engine loses no request (``serve`` resubmits; with
   ``supervise=True`` the ``EngineSupervisor`` swaps a clone in);
   constructing no deployment changes nothing.

The tiny next-item LM of the JAX tests (vocab 16, seq 6, d_model 16, 2
heads, 1 layer, mlp 32, f32) has numpy-drawn weights; waits are for
states, not times.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distkeras_tpu import deployment_online as jdep
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu_torch import (DOWNPOUR, EngineDead, EngineSupervisor,
                                 FreshnessTracker, OnlineDeployment,
                                 StreamSource, transformer_lm)
from distkeras_tpu_torch.core.model import FittedModel, load_jax_weights
from distkeras_tpu_torch.deployment_online import _weighted_percentile
from distkeras_tpu_torch.parameter_servers import resolve_ps_hosts
from distkeras_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)

V, L = 16, 4
CFG = dict(vocab_size=V, seq_len=L + 2, d_model=16, num_heads=2,
           num_layers=1, mlp_dim=32, compute_dtype="float32")
PROBE = np.arange(V, dtype=np.int32).reshape(-1, 1)


def make_lm(seed=0):
    m = transformer_lm(**CFG, device="cpu")
    rng = np.random.default_rng(seed)
    w = [(rng.standard_normal(a.shape) / np.sqrt(a.shape[0])
          if a.ndim == 2 else 0.1 * rng.standard_normal(a.shape)
          + (a.ndim == 1)).astype(np.float32) for a in m.get_weights()]
    return FittedModel(load_jax_weights(m, w))


def make_engine(seed=1, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", 3)
    return ServingEngine(make_lm(seed), **kw)


def make_stream_trainer(**kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("batch_size", 8)
    kw.setdefault("num_epoch", 1)
    kw.setdefault("communication_window", 2)
    kw.setdefault("execution", "host_ps")
    kw.setdefault("loss", "sparse_categorical_crossentropy_from_logits")
    kw.setdefault("worker_optimizer", "adam")
    kw.setdefault("learning_rate", 3e-3)
    kw.setdefault("stream", True)
    kw.setdefault("horizon_windows", 4)
    kw.setdefault("seed", 0)
    kw.setdefault("device", "cpu")
    return DOWNPOUR(make_lm(), **kw)


def mapping_chunks(mapping, num_chunks, rows=128, seed=0):
    """Token-mapping LM stream: y = mapping[x] per position — prompt
    ``[item]`` + one greedy step recommends ``mapping[item]``."""
    rng = np.random.default_rng(seed)
    for _ in range(num_chunks):
        x = rng.integers(0, V, (rows, L)).astype(np.int32)
        yield x, mapping[x]


def served_accuracy(dep, mapping):
    rows, gens = dep.serve(list(PROBE), num_steps=1)
    pred = np.array([r[1] for r in rows])
    return float(np.mean(pred == mapping[PROBE[:, 0]])), gens


# ---------------------------------------------------------------------------
# the freshness tracker: the JAX tracker's events, the JAX tracker's stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("samples,q,want", [
    ([], 50, None), ([(3.0, 7)], 50, 3.0),
    ([(2.0, 10), (3.0, 10)], 50, 2.0), ([(2.0, 10), (3.0, 10)], 99, 3.0),
    ([(5.0, 1), (1.0, 99)], 50, 1.0), ([(5.0, 1), (1.0, 99)], 100, 5.0),
])
def test_weighted_percentile_exact(samples, q, want):
    assert _weighted_percentile(samples, q) == want
    assert jdep._weighted_percentile(samples, q) == want


def _both(events):
    """Replay ``events`` into a port and a JAX tracker; their stats."""
    out = []
    for tr in (FreshnessTracker(), jdep.FreshnessTracker()):
        for name, *args in events:
            if name == "pull":
                tr.note_pull(args[0], generation=args[1])
            elif name == "commit":
                tr.note_commit(args[0], t=args[1])
            else:
                tr.note_horizon(args[0])
        out.append(tr.stats())
    assert out[0] == out[1]
    return out[0]


def test_freshness_tracker_exact_samples():
    s = _both([("horizon", [(10, 0.0), (10, 1.0)]), ("commit", 0, 2.0),
               ("commit", 0, 9.0), ("pull", 3.0, 5)])
    assert s["freshness_p50_s"] == 2.0 and s["freshness_p99_s"] == 3.0
    assert s["freshness_rows"] == 20
    assert s["freshness_horizons_served"] == 1
    assert s["freshness_horizons_committed"] == 1
    assert s["reload_pulls"] == 1 and s["center_generation"] == 5


def test_freshness_pull_serves_only_prior_commits():
    events = [("horizon", [(4, 0.0)]), ("horizon", [(4, 0.5)]),
              ("pull", 1.0, 1)]
    assert _both(events)["freshness_rows"] == 0
    events += [("commit", 0, 2.0), ("commit", 1, 5.0), ("pull", 3.0, 2)]
    s = _both(events)
    assert s["freshness_horizons_served"] == 1 and s["freshness_rows"] == 4
    events += [("pull", 6.0, 3)]
    s = _both(events)
    assert s["freshness_horizons_served"] == 2 and s["freshness_rows"] == 8
    assert s["center_generation"] == 3 and s["freshness_p50_s"] == 3.0


def test_freshness_empty_stats():
    s = _both([])
    assert s["freshness_p50_s"] is None and s["freshness_p99_s"] is None
    assert s["freshness_rows"] == 0 and s["reload_pulls"] == 0
    assert s["center_generation"] is None


# ---------------------------------------------------------------------------
# bind/advertise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bind,adv,want", [
    (None, None, ("127.0.0.1", "127.0.0.1")),
    ("0.0.0.0", None, ("0.0.0.0", "127.0.0.1")),
    ("::", None, ("::", "127.0.0.1")),
    ("10.0.0.5", None, ("10.0.0.5", "10.0.0.5")),
    ("0.0.0.0", "10.0.0.5", ("0.0.0.0", "10.0.0.5")),
])
def test_resolve_ps_hosts_matrix(bind, adv, want):
    t = SimpleNamespace(ps_bind_host=bind, ps_advertise_host=adv)
    assert resolve_ps_hosts(t) == jps.resolve_ps_hosts(t) == want
    assert resolve_ps_hosts(object()) == ("127.0.0.1", "127.0.0.1")


def test_ps_host_knobs_validated_eagerly():
    with pytest.raises(ValueError, match="empty string"):
        make_stream_trainer(ps_bind_host="")
    with pytest.raises(ValueError, match="empty string"):
        make_stream_trainer(ps_advertise_host="")
    with pytest.raises(ValueError, match="host_ps"):
        make_stream_trainer(execution="spmd", stream=False, num_workers=1,
                            horizon_windows=None, ps_bind_host="0.0.0.0")


def test_stream_trains_on_wildcard_bind_loopback_advertise():
    """The PS binds 0.0.0.0 while the workers dial loopback; a plain
    stream run grows no freshness keys."""
    rng = np.random.default_rng(0)
    mapping = rng.permutation(V).astype(np.int32)
    tr = make_stream_trainer(ps_bind_host="0.0.0.0",
                             ps_advertise_host="127.0.0.1")
    fitted = tr.train(StreamSource(generator=mapping_chunks(mapping, 2)))
    assert fitted is not None
    assert tr.stream_stats["rows"] == 2 * 128
    assert tr._ps_advertise_addr[0] == "127.0.0.1"
    assert "freshness_p50_s" not in tr.stream_stats


# ---------------------------------------------------------------------------
# OnlineDeployment: construction
# ---------------------------------------------------------------------------

def test_online_deployment_validation():
    eng = make_engine()
    src = StreamSource(generator=iter(()))
    with pytest.raises(ValueError, match="stream=True"):
        OnlineDeployment(make_stream_trainer(stream=False,
                                             horizon_windows=None),
                         src, eng)
    dep = OnlineDeployment(make_stream_trainer(ps_shards=2), src,
                           make_engine())
    assert dep.trainer.ps_shards == 2
    with pytest.raises(ValueError, match="StreamSource"):
        OnlineDeployment(make_stream_trainer(), [1, 2], eng)
    with pytest.raises(ValueError, match="ServingEngine"):
        OnlineDeployment(make_stream_trainer(), src, object())
    with pytest.raises(ValueError, match="reload_every"):
        OnlineDeployment(make_stream_trainer(), src, eng, reload_every=0)
    attached = make_engine()
    attached.attach_ps("127.0.0.1", 1)
    with pytest.raises(ValueError, match="already attach_ps-ed"):
        OnlineDeployment(make_stream_trainer(), src, attached)


def test_no_deployment_no_behavior_change():
    tr = make_stream_trainer()
    assert getattr(tr, "_on_ps_ready", None) is None
    assert tr.on_horizon is None
    assert tr.ps_bind_host is None and tr.ps_advertise_host is None
    f = make_lm(1)
    eng = ServingEngine(f, num_slots=4, max_len=3)
    assert eng.model is f.model  # a never-attached engine shares it
    assert eng._reload_listener is None and eng._reload_policy is None
    assert eng.stats["reloads"] == 0 and eng.stats["reload_failures"] == 0
    assert eng.stats["center_generation"] is None
    base = StreamSource(generator=iter(()))
    dep = OnlineDeployment(make_stream_trainer(), base, eng)
    assert dep.source._base is base
    assert eng._ps_addr is None and eng._reload_listener is None
    assert eng.model is f.model
    assert dep.generation == 0 and dep.swaps == []


# ---------------------------------------------------------------------------
# the process graph end to end (inline engine, natural drain)
# ---------------------------------------------------------------------------

def test_online_deployment_serves_during_horizons_and_tracks_freshness():
    rng = np.random.default_rng(0)
    mapping = rng.permutation(V).astype(np.int32)
    trainer = make_stream_trainer()
    caller = make_lm(1)
    dep = OnlineDeployment(
        trainer, StreamSource(generator=mapping_chunks(mapping, 3)),
        ServingEngine(caller, num_slots=4, max_len=3), reload_every=1)
    frozen = [w.copy() for w in caller.get_weights()]
    curve, gen_tags = [], []

    def on_horizon(h, fitted):
        acc, gens = served_accuracy(dep, mapping)
        curve.append(acc)
        gen_tags.extend(gens)
        if h < 3:  # feedback rides along while the base stream lives
            fx = np.repeat(PROBE, L, axis=1)
            dep.feed(fx, mapping[fx])

    trainer.on_horizon = on_horizon
    dep.start()
    assert dep.wait_ps_ready(timeout=60.0)
    fitted = dep.join(timeout=300.0)
    dep.stop()
    assert fitted is not None and dep.done
    s = dep.stats()
    assert s["stream_stats"]["rows"] == 3 * 128 + s["rows_fed_back"]
    assert s["rows_fed_back"] > 0
    assert len(curve) == s["stream_stats"]["horizons"]
    assert s["engine_requests_failed"] == 0
    assert s["engine_requests_completed"] == len(gen_tags)
    assert all(g == 0 for g in gen_tags)
    assert s["engine_reloads"] > 0 and s["engine_reload_failures"] == 0
    assert s["engine_center_generation"] is not None
    assert s["freshness_p50_s"] is not None
    assert s["freshness_p99_s"] >= s["freshness_p50_s"]
    assert s["freshness_rows"] > 0
    assert trainer.stream_stats["freshness_p50_s"] == s["freshness_p50_s"]
    assert dep.engine.stats["freshness_p50_s"] == s["freshness_p50_s"]
    assert curve[-1] >= curve[0] and curve[-1] >= 0.5, curve
    # the engine reloaded its own copy: the caller's model never moved
    for a, b in zip(caller.get_weights(), frozen):
        np.testing.assert_array_equal(a, b)


def test_blue_green_swaps_atomic_attribution():
    """Three swaps mid-run: generations 1, 2, 3, every probe batch on one
    generation, every old engine drained clean, every clone warmed on a
    pull — and the pull into the clone left the old engine's weights as
    they were (each engine owns its copy)."""
    rng = np.random.default_rng(1)
    mapping = rng.permutation(V).astype(np.int32)
    trainer = make_stream_trainer(seed=1)
    dep = OnlineDeployment(
        trainer, StreamSource(generator=mapping_chunks(mapping, 3,
                                                       seed=1)),
        make_engine(), reload_every=1)
    records, by_gen, horizons, untouched = [], {}, [], []

    def on_horizon(h, fitted):
        if h in (0, 1, 2):
            old = dep.engine
            before = [w.copy() for w in old.model.get_weights()]
            records.append(dep.blue_green_swap())
            untouched.append(all(np.array_equal(a, b) for a, b in zip(
                old.model.get_weights(), before)))
            assert dep.engine.model is not old.model
        acc, gens = served_accuracy(dep, mapping)
        assert len(set(gens)) == 1
        by_gen[gens[0]] = by_gen.get(gens[0], 0) + len(gens)
        horizons.append(h)

    trainer.on_horizon = on_horizon
    dep.start()
    dep.join(timeout=300.0)
    dep.stop()
    s = dep.stats()
    assert len(records) == 3 and all(untouched)
    assert all(r["blue_green"] and r["old_drained_clean"] and r["pulled"]
               for r in records)
    assert [r["generation"] for r in records] == [1, 2, 3]
    assert s["generation"] == 3
    assert sum(by_gen.values()) == len(PROBE) * len(horizons)
    assert s["engine_requests_completed"] == by_gen[s["generation"]]
    assert s["engine_requests_failed"] == 0


def test_serve_resubmits_lost_requests_after_an_engine_kill():
    trainer = make_stream_trainer()
    eng = make_engine()
    dep = OnlineDeployment(trainer, StreamSource(generator=iter(())), eng,
                           reload_every=1)
    h, g = dep.submit(PROBE[2], 1)
    assert g == 0
    dep.kill_engine()
    with pytest.raises(EngineDead):
        h.result(timeout=1.0)
    clone = eng.respawn_clone()
    swap = threading.Timer(0.05, lambda: setattr(dep, "engine", clone))
    swap.start()
    rows, gens = dep.serve(list(PROBE[:4]), num_steps=1, retry_wait_s=20.0)
    swap.join()
    assert all(r is not None for r in rows)
    assert gens == [1, 1, 1, 1]
    assert dep.swaps[-1]["old_dead"] is True


def test_serve_raises_when_no_replacement_arrives():
    dep = OnlineDeployment(make_stream_trainer(),
                           StreamSource(generator=iter(())), make_engine(),
                           reload_every=1)
    dep.kill_engine()
    with pytest.raises(EngineDead, match="lost|replacement"):
        dep.serve(list(PROBE[:2]), num_steps=1, retries=1,
                  retry_wait_s=0.05)


def test_a_supervised_live_engine_is_swapped_after_a_kill():
    """The deployment as an ``EngineSupervisor``'s target (what
    ``supervise=True`` starts) over a started engine: a kill is detected,
    a warmed clone is swapped in through the deployment's setter
    (generation 1), and ``serve`` completes every request there."""
    eng = make_engine().warmup().start()
    dep = OnlineDeployment(make_stream_trainer(),
                           StreamSource(generator=iter(())), eng)
    dep.supervisor = EngineSupervisor(dep, heartbeat_interval=0.01,
                                      liveness_deadline=30.0).start()
    try:
        dep.kill_engine()
        rows, gens = dep.serve(list(PROBE[:4]), num_steps=1,
                               retry_wait_s=30.0)
        assert all(r is not None for r in rows) and gens == [1] * 4
        assert dep.generation == 1 and dep.swaps[-1]["old_dead"]
        assert dep.supervisor.recoveries[0]["restarted"]
    finally:
        dep.supervisor.stop()
        dep.engine.stop()


def test_a_live_engine_is_detached_before_the_ps_stops():
    """A started engine serving from ``on_horizon`` pulls after the step
    that resolves its requests, while the horizon loop goes on: the
    deployment detaches it through the loop's ``_on_ps_close`` seam before
    the PS stops, so no pull fails at the end of training, and serving
    afterwards pulls nothing."""
    rng = np.random.default_rng(5)
    mapping = rng.permutation(V).astype(np.int32)
    eng = make_engine().warmup().start()
    dep = OnlineDeployment(
        make_stream_trainer(max_horizons=3),
        StreamSource(generator=mapping_chunks(mapping, 3, seed=5)), eng)
    closed = []
    dep.trainer.on_horizon = lambda h, fitted: served_accuracy(dep, mapping)
    real_close = dep._on_ps_close
    dep._on_ps_close = lambda: (closed.append(eng.stats["reloads"]),
                                real_close())
    dep.start()
    try:
        assert dep.join(timeout=120.0) is not None
        assert closed and eng._ps_addr is None
        reloads = eng.stats["reloads"]
        assert reloads > 0 and eng.stats["reload_failures"] == 0
        served_accuracy(dep, mapping)
        assert eng.stats["reloads"] == reloads
        assert eng.stats["reload_failures"] == 0
    finally:
        dep.stop()
        eng.stop()


def test_a_clone_swapped_in_after_the_ps_stopped_is_detached():
    dep = OnlineDeployment(make_stream_trainer(),
                           StreamSource(generator=iter(())), make_engine())
    dep._engine.attach_ps("127.0.0.1", 1, every=1)
    clone = dep.engine.respawn_clone()
    assert clone._ps_addr is not None
    dep._on_ps_close()
    assert dep.engine._ps_addr is None
    dep.engine = clone
    assert clone._ps_addr is None and dep.generation == 1


def test_kill_ps_shard_requires_recovery():
    dep = OnlineDeployment(make_stream_trainer(),
                           StreamSource(generator=iter(())), make_engine())
    with pytest.raises(RuntimeError, match="recovery=True"):
        dep.kill_ps_shard()


def test_source_stop_ends_a_self_sustaining_feedback_loop():
    dep = OnlineDeployment(make_stream_trainer(),
                           StreamSource(generator=iter(())), make_engine())
    dep.source.feed(np.zeros((4, L), np.int32), np.zeros((4, L), np.int32))
    assert dep.source.rows_fed_back == 4
    dep.source.stop()
    assert dep.source.read(64) is None


def test_feedback_is_spliced_ahead_of_base_rows():
    base = [(np.full((4, L), 7, np.int32), np.full((4, L), 7, np.int32))]
    dep = OnlineDeployment(make_stream_trainer(),
                           StreamSource(generator=iter(base)),
                           make_engine())
    assert dep.feed(np.ones((2, L), np.int32), np.ones((2, L), np.int32)) \
        == 2
    with pytest.raises(ValueError, match="disagree"):
        dep.feed(np.ones((2, L), np.int32), np.ones((3, L), np.int32))
    x, _ = dep.source.read(6)
    np.testing.assert_array_equal(x[:, 0], [1, 1, 7, 7, 7, 7])
    s = dep.tracker.stats()
    assert s["freshness_horizons_committed"] == 0
    assert dep.source.buffer is dep.source._base.buffer


def test_start_is_one_shot():
    rng = np.random.default_rng(3)
    mapping = rng.permutation(V).astype(np.int32)
    dep = OnlineDeployment(
        make_stream_trainer(),
        StreamSource(generator=mapping_chunks(mapping, 1, seed=3)),
        make_engine())
    dep.start()
    assert dep.join(timeout=120.0) is not None
    with pytest.raises(RuntimeError, match="one-shot"):
        dep.start()
    dep.stop()
