"""The port's survivable servers and elastic workers against the JAX
package's, on the CPU.

 - **The lease ledger, call for call.**  Seeded sequences of ``acquire``,
   ``renew``, ``complete``, ``revoke_expired``, ``revoke_worker``,
   ``resize`` and ``begin_epoch`` calls under one injected clock go into a
   JAX and a port ``LeaseLedger``: every return value, deadline, rate,
   revocation and report is equal.
 - **Journals across the packages.**  A snapshot one package's
   ``ShardJournal`` writes restores in the other's (same files, same meta).
 - **Workers across the packages' respawned shards.**  A JAX worker with
   ``recovery=True`` resumes across a port shard that a port
   ``ShardSupervisor`` respawned, and a port worker across a JAX shard the
   JAX supervisor respawned; on both sides the commit stamped with the old
   generation is rejected and the next one lands on the restored center.
 - **One elastic worker, within f32.**  ``elastic=True`` with one worker
   and no fault, on a model without dropout, from one numpy weight set:
   the port's history and center equal the JAX run's (the same
   per-epoch permutation, the same leases).
"""

import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as port
from distkeras_tpu import ps_sharding as jsh
from distkeras_tpu import resilience as jres
from distkeras_tpu.workers import DOWNPOURWorker as JaxDOWNPOURWorker
from distkeras_tpu_torch import ps_sharding as psh
from distkeras_tpu_torch import resilience as pres
from distkeras_tpu_torch.workers import DOWNPOURWorker

from test_torch_host_ps_parity import (ALGORITHMS, TOL, _jax_model,
                                       _optimizer, _port_model, _rows,
                                       _weights)

torch.set_num_threads(1)

FAST = dict(attempts=None, backoff=0.02, max_backoff=0.2, deadline=20.0,
            seed=0)


# ---------------------------------------------------------------------------
# the lease ledger, call for call
# ---------------------------------------------------------------------------

def _ledger_calls(seed, n=400):
    """A seeded call script: (method, args, clock advance)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        w = int(rng.integers(0, 4))
        dt = float(rng.choice([0.0, 0.05, 0.3, 1.0, 7.5]))
        if r < 0.3:
            ops.append(("acquire", (w,), dt))
        elif r < 0.65:
            ops.append(("renew", (int(rng.integers(0, 12)), w), dt))
        elif r < 0.8:
            ops.append(("complete", (int(rng.integers(0, 12)), w), dt))
        elif r < 0.88:
            ops.append(("revoke_expired", (), dt))
        elif r < 0.93:
            ops.append(("revoke_worker", (w,), dt))
        elif r < 0.96:
            ops.append(("resize", (int(rng.integers(300, 1300)),), dt))
        else:
            ops.append(("begin_epoch", (int(rng.integers(1, 5)),), dt))
    return ops


def _plain(x):
    """Ledger results as plain data (Lease is a NamedTuple in both)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return tuple(x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("seed,kw", [
    (0, dict(lease_windows=1)),
    (1, dict(lease_windows=2, min_deadline=0.5, slack=3.0)),
    (2, dict(lease_windows=3, min_deadline=2.0, default_window_s=0.4)),
    (3, dict(lease_windows=5, min_deadline=0.1, slack=1.5)),
])
def test_lease_ledger_equals_jax_call_for_call(seed, kw):
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731
    jl = jres.LeaseLedger(1000, rows_per_window=64, clock=clock, **kw)
    pl = pres.LeaseLedger(1000, rows_per_window=64, clock=clock, **kw)
    assert _plain(jl.begin_epoch(0)) == _plain(pl.begin_epoch(0))
    for method, args, dt in _ledger_calls(seed):
        t[0] += dt
        want = getattr(jl, method)(*args)
        got = getattr(pl, method)(*args)
        assert _plain(got) == _plain(want), (method, args)
        assert pl._state == jl._state
        assert pl.rates == jl.rates
        assert pl.reassigned == jl.reassigned
        assert pl.windows_by_worker == jl.windows_by_worker
        assert pl.epoch_done() == jl.epoch_done()
        assert pl.pending() == jl.pending()
    assert pl.completions == jl.completions
    for epoch in jl.completions:
        assert pl.epoch_report(epoch) == jl.epoch_report(epoch)
    assert _plain(pl.leases) == _plain(jl.leases)


# ---------------------------------------------------------------------------
# journals across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_snapshots_restore_across_packages(writer, tmp_path):
    mods = {"jax": jres, "port": pres}
    w = mods[writer].ShardJournal(str(tmp_path), max_to_keep=2)
    r = mods["port" if writer == "jax" else "jax"].ShardJournal(
        str(tmp_path), max_to_keep=2)
    rng = np.random.default_rng(5)
    centers = {}
    for shard in range(2):
        for snap in range(1, 4):
            c = [rng.standard_normal((4, 3)).astype(np.float32),
                 rng.standard_normal((7,)).astype(np.float32)]
            w.save(shard, snap, c, clock=10 * snap + shard,
                   generation=snap % 2)
            centers[shard] = c
    for shard in range(2):
        out = r.latest(shard)
        assert out["clock"] == 30 + shard and out["generation"] == 1
        assert out["snap_id"] == 3
        for a, b in zip(out["center"], centers[shard]):
            np.testing.assert_array_equal(a, b)
    assert r._ckpt(0).all_steps() == w._ckpt(0).all_steps() == [2, 3]


# ---------------------------------------------------------------------------
# workers across the packages' respawned shards
# ---------------------------------------------------------------------------

def _blob():
    return {"model": "{}",
            "weights": [np.zeros((8,), np.float32),
                        np.zeros((3,), np.float32)]}


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_worker_resumes_across_the_other_packages_respawned_shard(
        server_pkg):
    """The server side (group + supervisor) from one package, the worker
    from the other: commit d1, snapshot, commit d2, kill and respawn shard
    0 (generation 1, d2 dropped); the worker's next commit, stamped with
    generation 0, is rejected by the respawned shard, the pull resumes and
    learns generation 1, and a commit at generation 1 lands."""
    if server_pkg == "port":
        group = psh.ShardedServerGroup("downpour", _blob(), num_workers=1,
                                       num_shards=2)
        sup_cls = pres.ShardSupervisor
        wk = JaxDOWNPOURWorker(
            _blob(), "sgd", "mse", "127.0.0.1", 0,
            shard_plan=jsh.make_shard_plan([(8,), (3,)],
                                           [np.float32] * 2, 2),
            recovery=True, retry_policy=jres.RetryPolicy(**FAST),
            shard_addrs=None)
    else:
        group = jsh.ShardedServerGroup("downpour", _blob(), num_workers=1,
                                       num_shards=2)
        sup_cls = jres.ShardSupervisor
        wk = DOWNPOURWorker(
            _blob(), "sgd", "mse", "127.0.0.1", 0,
            shard_plan=psh.make_shard_plan([(8,), (3,)],
                                           [np.float32] * 2, 2),
            recovery=True, retry_policy=pres.RetryPolicy(**FAST),
            device="cpu")
    group.start()
    wk.shard_addrs = group.addrs
    sup = sup_cls(group, "downpour", 1, liveness_deadline=0.3)
    try:
        for j in range(2):
            sup.snapshot_shard(j)
        wk.connect()
        wk.pull()
        ones = [np.ones(8, np.float32), np.ones(3, np.float32)]
        wk.update(ones, 0)                                   # d1
        sup.snapshot_shard(0)
        wk.update([10 * a for a in ones], 0)                 # d2
        sup.kill_shard(0)
        rec = sup.respawn_shard(0)
        assert rec["generation"] == 1 and rec["restored_clock"] == 1
        assert rec["dropped_updates"] == 1
        # stamped with generation 0: resumed, re-sent, rejected
        wk.commit([100 * a for a in ones], 0)
        center = wk.pull()
        client = wk._shard_client
        assert client.resumes >= 1 and client._gens == [1, 0]
        s0 = group.plan.scatter([np.asarray(c) for c in center])
        np.testing.assert_array_equal(s0[0][0], np.ones_like(s0[0][0]))
        np.testing.assert_array_equal(s0[1][0], np.full_like(s0[1][0], 111))
        assert group.servers[0].ps.num_updates == 1  # the stale one dropped
        wk.update(ones, 0)                                   # generation 1
        after = group.plan.scatter([np.asarray(c) for c in wk.pull()])
        np.testing.assert_array_equal(after[0][0],
                                      np.full_like(after[0][0], 2.0))
        assert group.servers[0].ps.num_updates == 2
        wk.disconnect()
    finally:
        group.stop()


# ---------------------------------------------------------------------------
# one elastic worker against the JAX run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ADAG", "DOWNPOUR"])
def test_one_elastic_worker_matches_jax(name):
    weights, rows = _weights(), _rows()
    common = dict(num_workers=1, batch_size=8, num_epoch=2,
                  communication_window=4, label_col="label_encoded",
                  seed=3, execution="host_ps", elastic=True,
                  lease_windows=2)
    jt = getattr(jdk, name)(_jax_model(weights), **common,
                            **_optimizer(jdk, ALGORITHMS[name]))
    jfit = jt.train(jdk.Dataset(rows))
    pt = getattr(port, name)(_port_model(weights), device="cpu", **common,
                             **_optimizer(port, ALGORITHMS[name]))
    pfit = pt.train(port.Dataset(rows))
    # 160 rows / (window 4 x batch 8) = 5 windows an epoch, leases of 2
    assert len(pt.get_history()) == len(jt.get_history()) == 10
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    for a, b in zip(pfit.get_weights(), jfit.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert (pt.elastic_stats["lease_completions"]
            == jt.elastic_stats["lease_completions"])
    assert pt.elastic_stats["windows_per_worker"] == {0: 10}
