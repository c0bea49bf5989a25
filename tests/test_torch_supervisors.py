"""The port's serving supervisors (``distkeras_tpu_torch/resilience.py``:
``EngineSupervisor``, ``PairSupervisor``, ``FleetSupervisor``) and the
router's QoS legs: the supervisor cases of the JAX package's
``tests/test_serving_resilience.py``, ``tests/test_serving_disagg.py`` and
``tests/test_serving_qos.py`` on the port.

The contract pinned here, on the JAX serving tests' tiny LM (vocab 17,
seq 32, d_model 16, 2 heads, 2 layers, f32; 2 slots, max_len 24, paged
blocks of 4), one numpy weight set in both packages:

 - ``RetryPolicy.describe`` and the default policies equal the JAX
   package's;
 - an engine behind a ``ServingServer`` that crashes or wedges is
   detected, declared dead, restarted through ``respawn_clone`` (warmed
   before it goes live) and swapped into the server, and a client retrying
   under a ``RetryPolicy`` gets the ``generate`` row, once per transport
   core; the clone carries the speculative, int8 and paged knobs; without
   restart the failure stays typed;
 - ``PairSupervisor`` restarts a dead prefill engine through the pair's
   ``replace_engine`` and the pair then serves the unified row;
 - ``FleetSupervisor``'s own thread restarts a replica killed under
   traffic: no accepted request is lost, every row equals the unkilled
   one, the restarted replica serves, and a restarted graphed engine
   (a recording graph stands in for the CUDA graph here) captures once;
 - the router's tenant-aware dispatch spills batch work off an affine
   replica with interactive backlog, and a scale-down over a suspended
   request resubmits it with an equal row.

Tests wait for the states they assert (a recovery recorded, a handle done,
a suspension, the blocks reclaimed), never for a fixed time.
"""

import time
import zlib

import numpy as np
import pytest
import torch

import distkeras_tpu.resilience as jresilience
import distkeras_tpu_torch.resilience as presilience
from distkeras_tpu_torch.resilience import (EngineSupervisor,
                                            FleetSupervisor, PairSupervisor,
                                            RetryPolicy)
from distkeras_tpu_torch.router import ServingRouter
from distkeras_tpu_torch.serving import (DisaggPair, EngineDead,
                                         ServingClient, ServingEngine,
                                         ServingServer, TenantPolicy)
from test_torch_serving_fastpath import RecordingGraph, graphed  # noqa: F401
from test_torch_serving_wire import (PROMPT, _assert_slots_reclaimed,
                                     _wait_for, _want, _wedge,
                                     models, server_core)  # noqa: F401

torch.set_num_threads(1)

P6 = np.arange(1, 7, dtype=np.int32)


@pytest.fixture(scope="module")
def fitted(models):
    return models[1]


def _boom():
    raise RuntimeError("chaos: decode crashed")


def _paged(fitted, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 24)
    kw.setdefault("block_size", 4)
    return ServingEngine(fitted, paged=True, **kw)


def _assert_no_block_leaks(eng):
    assert eng.kv_blocks_in_use == 0
    assert eng._pool.check_conservation()
    assert not eng._plans


# ---------------------------------------------------------------------------
# the retry policies
# ---------------------------------------------------------------------------

def _fields(policy):
    return (policy.attempts, policy.backoff, policy.max_backoff,
            policy.jitter, policy.deadline, policy.seed)


def test_retry_policies_describe_and_defaults_as_jax():
    for name in ("DEFAULT_CONNECT_POLICY", "DEFAULT_RECOVERY_POLICY"):
        j, p = getattr(jresilience, name), getattr(presilience, name)
        assert _fields(p) == _fields(j)
        assert p.describe() == j.describe()
    for kw in (dict(attempts=3), dict(attempts=None, deadline=2.5)):
        assert (RetryPolicy(**kw).describe()
                == jresilience.RetryPolicy(**kw).describe())


# ---------------------------------------------------------------------------
# EngineSupervisor: detect crash + wedge, restart, client retry
# ---------------------------------------------------------------------------

def test_supervisor_restarts_crashed_engine_and_client_retries(
        fitted, server_core):
    eng = ServingEngine(fitted, num_slots=2, max_len=24).warmup()
    want = _want(fitted, PROMPT, 6)
    with ServingServer(eng, poll_s=0.01) as srv:
        with EngineSupervisor(srv, heartbeat_interval=0.05,
                              liveness_deadline=2.0) as sup:
            with ServingClient(*srv.addr) as c:
                np.testing.assert_array_equal(c.generate(PROMPT, 6), want)
                eng._decode_once = _boom
                row = c.generate(
                    PROMPT, 6,
                    retry_policy=RetryPolicy(attempts=40, backoff=0.05))
                np.testing.assert_array_equal(row, want)  # bit-identical
            assert srv.engine is not eng
            assert srv.engine.dead is None
            assert _wait_for(lambda: len(sup.recoveries) == 1)
            rec = sup.recoveries[0]
            assert rec["reason"] == "crashed" and rec["restarted"]
            assert rec["recovery_ms"] is not None
            _assert_slots_reclaimed(srv.engine)


def test_supervisor_detects_wedged_engine_via_heartbeat(fitted,
                                                        server_core):
    eng = ServingEngine(fitted, num_slots=2, max_len=24).warmup()
    want = _want(fitted, PROMPT, 6)
    release = _wedge(eng)
    try:
        with ServingServer(eng, poll_s=0.01) as srv:
            with EngineSupervisor(srv, heartbeat_interval=0.05,
                                  liveness_deadline=0.5) as sup:
                with ServingClient(*srv.addr) as c:
                    row = c.generate(
                        PROMPT, 6,
                        retry_policy=RetryPolicy(attempts=60, backoff=0.05))
                    np.testing.assert_array_equal(row, want)
                assert len(sup.recoveries) == 1, sup.recoveries
                assert sup.recoveries[0]["reason"] == "wedged"
    finally:
        release()


def test_supervisor_without_restart_fails_typed(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24).warmup()
    h = eng.submit(PROMPT, 8)
    eng._decode_once = _boom
    eng.start()
    with EngineSupervisor(eng, heartbeat_interval=0.05,
                          liveness_deadline=1.0, restart=False) as sup:
        assert h.wait(timeout=10.0)
        with pytest.raises(EngineDead):
            h.result()
        assert _wait_for(lambda: len(sup.recoveries) == 1)
        assert not sup.recoveries[0]["restarted"]
        assert sup.engine is eng  # no replacement
    with pytest.raises(EngineDead):
        eng.submit(PROMPT, 2)
    eng.stop()


def test_supervisor_restart_preserves_spec_and_quant(fitted, server_core):
    """An engine crash under supervision: the respawned clone carries the
    draft and the int8 KV, and the retried request completes."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24, spec_draft=fitted,
                        spec_len=3, kv_dtype="int8").warmup()
    with ServingServer(eng, poll_s=0.01) as srv:
        with EngineSupervisor(srv, heartbeat_interval=0.05,
                              liveness_deadline=2.0) as sup:
            with ServingClient(*srv.addr) as c:
                eng._decode_once = _boom
                row = c.generate(
                    PROMPT, 6,
                    retry_policy=RetryPolicy(attempts=40, backoff=0.05))
                assert row.shape == (len(PROMPT) + 6,)
            new = srv.engine
            assert new is not eng and new.dead is None
            assert new._draft_model is eng._draft_model
            assert new.spec_len == eng.spec_len
            assert new.kv_dtype == "int8"
            assert _wait_for(lambda: len(sup.recoveries) == 1)
            _assert_slots_reclaimed(new)


def test_paged_supervisor_restart_carries_knobs(fitted, server_core):
    """The respawned clone keeps paged/block_size/kv_blocks (same arena
    shape) with a FRESH trie, and the retried request completes
    generate-identically."""
    eng = _paged(fitted, kv_blocks=12).warmup()
    with ServingServer(eng, poll_s=0.01) as srv:
        with EngineSupervisor(srv, heartbeat_interval=0.05,
                              liveness_deadline=2.0) as sup:
            with ServingClient(*srv.addr) as c:
                eng._decode_once = _boom
                row = c.generate(
                    PROMPT, 6,
                    retry_policy=RetryPolicy(attempts=40, backoff=0.05))
                np.testing.assert_array_equal(row, _want(fitted, PROMPT, 6))
            assert _wait_for(lambda: len(sup.recoveries) >= 1)
            fresh = srv.engine
            assert fresh is not eng
            assert fresh.paged and fresh.block_size == 4
            assert fresh.kv_blocks == 12
            assert _wait_for(lambda: fresh.kv_blocks_in_use == 0)
            _assert_no_block_leaks(fresh)


# ---------------------------------------------------------------------------
# PairSupervisor: the disaggregated pair's restart seam
# ---------------------------------------------------------------------------

def _role(fitted, role):
    return ServingEngine(fitted, paged=True, role=role, num_slots=2,
                         max_len=24, block_size=4, kv_blocks=30)


def test_pair_supervisor_restart_seam(fitted):
    """A dead prefill engine is respawned through respawn_clone and
    swapped into the pair via replace_engine; traffic after recovery
    completes token-identically."""
    req = {"prompt": PROMPT, "num_steps": 6}
    uni = _paged(fitted, kv_blocks=30)
    want = uni.submit(**req)
    uni.run_until_idle()
    pre, dec = _role(fitted, "prefill"), _role(fitted, "decode")
    pair = DisaggPair([pre], decode=dec, poll_s=0.005)
    with pair:
        assert pair.submit(**req).wait(timeout=60.0)
        sup = PairSupervisor(pair, liveness_deadline=30.0)
        assert sup.check_all() == [None, None]
        pre.declare_dead("chaos: kill the prefill half")
        recs = sup.recover_all()
        assert len(recs) == 1 and recs[0]["restarted"]
        assert sup.restarts == 1 and sup.recoveries == recs
        new_pre = pair.engines[0]
        assert new_pre is not pre and new_pre.role == "prefill"
        row = pair.submit(**req).result(timeout=60.0)
    np.testing.assert_array_equal(row, want.result())
    assert pair.counters["requests_completed"] == 2
    assert pair.kv_blocks_in_use == 0
    for e in pair.engines:
        _assert_no_block_leaks(e)


# ---------------------------------------------------------------------------
# FleetSupervisor: its own thread restores capacity under traffic
# ---------------------------------------------------------------------------

TRACE = [(np.array([3 + i % 5, 4, 5, 6 + i % 3], np.int32), 6,
          {} if i % 2 else {"seed": i, "temperature": 0.8})
         for i in range(10)]


def test_fleet_supervisor_thread_restarts_a_replica_killed_under_traffic(
        fitted):
    """Replica 0's decode is paced so that it is mid-stream when it dies
    (timing only, never token values)."""
    e0, e1 = _paged(fitted), _paged(fitted)
    orig = e0._decode_once

    def paced():
        time.sleep(0.01)
        return orig()

    e0._decode_once = paced
    with ServingRouter([e0, e1], affinity="least-loaded") as r:
        with FleetSupervisor(r, heartbeat_interval=0.02,
                             liveness_deadline=5.0) as sup:
            hs = [r.submit(p, n, **kw) for p, n, kw in TRACE]
            on_e0 = [h for h in hs if r.generation_of(h)[0] == 0]
            assert _wait_for(lambda: any(len(h.tokens) for h in on_e0))
            e0.declare_dead("chaos: replica 0 killed mid-trace")
            rows = [h.result(timeout=60) for h in hs]
            assert _wait_for(lambda: sup.restarts == 1)
            rec = sup.recoveries[0]
            assert rec["reason"] == "crashed" and rec["restarted"]
            assert rec["recovery_ms"] > 0
            new = r.engines[0]
            assert new is not e0 and new.dead is None
            assert r.fleet_snapshot()[0]["generation"] == 1
            assert r.counters["requests_failed"] == 0
            assert r.counters["requests_completed"] == len(TRACE)
            assert r.counters["resubmissions"] >= 1
            # the restarted replica serves the right tokens
            h = new.submit(PROMPT, 6)
            np.testing.assert_array_equal(h.result(timeout=30),
                                          _want(fitted, PROMPT, 6))
        assert _wait_for(lambda: r.kv_blocks_in_use == 0)
    for (p, n, kw), row in zip(TRACE, rows):
        np.testing.assert_array_equal(row, _want(fitted, p, n, **kw))


def test_fleet_supervisor_restart_of_a_graphed_replica_captures_once(
        fitted, graphed):
    """On a card the restarted clone's warmup captures its decode graph
    before it goes live (a recording graph here): one capture per clone,
    none at its first step, and rows equal after the swap."""
    e0 = ServingEngine(fitted, num_slots=2, max_len=24).warmup()
    e1 = ServingEngine(fitted, num_slots=2, max_len=24).warmup()
    assert graphed.captures == 2
    with ServingRouter([e0, e1], affinity="least-loaded") as r:
        sup = FleetSupervisor(r, liveness_deadline=5.0)
        e1.declare_dead("chaos")
        (rec,) = sup.recover_all()
        assert rec["restarted"] and graphed.captures == 3
        new = r.engines[1]
        assert new.stats["graph_captures"] == 1
        hs = [r.submit(PROMPT, 6, seed=s, temperature=0.7)
              for s in range(4)]
        for s, h in enumerate(hs):
            np.testing.assert_array_equal(
                h.result(timeout=30),
                _want(fitted, PROMPT, 6, seed=s, temperature=0.7))
        assert graphed.captures == 3
        assert new.stats["graph_replays"] > 0


def test_fleet_supervisor_detects_a_wedged_replica(fitted):
    e0, e1 = ServingEngine(fitted, num_slots=2, max_len=24), \
        ServingEngine(fitted, num_slots=2, max_len=24)
    release = _wedge(e0)
    try:
        with ServingRouter([e0, e1], affinity="least-loaded") as r:
            with FleetSupervisor(r, heartbeat_interval=0.02,
                                 liveness_deadline=0.3) as sup:
                hs = [r.submit(PROMPT, 6, seed=s, temperature=0.7)
                      for s in range(4)]
                rows = [h.result(timeout=60) for h in hs]
                assert _wait_for(lambda: len(sup.recoveries) == 1)
                assert sup.recoveries[0]["reason"] == "wedged"
                assert r.counters["requests_failed"] == 0
                assert e0 not in r.engines
    finally:
        release()
    for s, row in enumerate(rows):
        np.testing.assert_array_equal(
            row, _want(fitted, PROMPT, 6, seed=s, temperature=0.7))


# ---------------------------------------------------------------------------
# router: tenant-aware dispatch + scale_down over suspended requests
# ---------------------------------------------------------------------------

def _bulk(**kw):
    return TenantPolicy("bulk", tier="batch", **kw)


def _live(**kw):
    return TenantPolicy("live", tier="interactive", **kw)


def test_router_tenant_spill_dispatch(fitted):
    """Batch-tier submissions spill off an affine replica with
    interactive backlog (``tenant_spills``); interactive submissions keep
    their affinity — they are what the backlog drains into."""
    e1, e2 = _paged(fitted, max_len=32), _paged(fitted, max_len=32)
    r = ServingRouter(replicas=[e1, e2], affinity="prefix",
                      affinity_blocks=1, block_size=4,
                      tenants=[_live(), _bulk()])
    prompt = np.arange(1, 10, dtype=np.int32)
    key = np.asarray(prompt[:4], np.int32).tobytes()
    reps = list(r._replicas)
    affine = max(reps, key=lambda rep: zlib.crc32(
        key + rep.uid.to_bytes(4, "little")))
    other = next(rep for rep in reps if rep is not affine)
    # affine replica: NOT saturated (no affinity spill) but with an
    # interactive request queued; the other replica is least-loaded
    affine.load = lambda: {"queue_depth": 1, "active": 1, "slots_free": 1,
                           "slots_total": 2, "queued_interactive": 1}
    other.load = lambda: {"queue_depth": 0, "active": 0, "slots_free": 2,
                          "slots_total": 2, "queued_interactive": 0}
    assert r._dispatch_order(prompt, tenant="bulk")[0][0] is other
    assert r.counters["tenant_spills"] == 1
    assert r._dispatch_order(prompt, tenant="live")[0][0] is affine
    assert r.counters["affinity_routed"] == 1
    # untenanted traffic is batch-tier on a tenanted fleet: it spills too
    assert r._dispatch_order(prompt, tenant=None)[0][0] is other
    assert r.counters["tenant_spills"] == 2
    # fleet QoS reached every in-process replica as an unshared clone
    for e in (e1, e2):
        assert set(e._tenants) == {"live", "bulk"}
        assert e._tenants["live"] is not r._tenants["live"]


def test_router_scale_down_resubmits_suspended(fitted):
    """scale_down on a replica holding a SUSPENDED request: the drain
    timeout fails it typed, the relay resubmits to the surviving replica,
    and the client-visible stream is still bit-identical — zero loss.
    The owner's decode is paced and its resume held while the request is
    suspended (this engine is fast; timing only, never token values)."""
    req = dict(prompt=P6, num_steps=18, temperature=0.8, seed=7)
    want = _want(fitted, P6, 18, max_len=32, temperature=0.8, seed=7)
    e1 = _paged(fitted, num_slots=1, max_len=32, kv_blocks=30)
    e2 = _paged(fitted, num_slots=1, max_len=32, kv_blocks=30)
    origs = {e: (e._decode_once, e._resume_suspended) for e in (e1, e2)}

    def paced(orig):
        def step():
            time.sleep(0.02)
            return orig()
        return step

    for e, (dec, _) in origs.items():
        e._decode_once = paced(dec)
        e._resume_suspended = lambda rec: False
    r = ServingRouter(replicas=[e1, e2], affinity="prefix", block_size=4,
                      tenants=[_live(), _bulk()])
    r.start()
    try:
        h = r.submit(tenant="bulk", **req)
        rec = r._live[h.id]
        assert _wait_for(lambda: rec.upstream is not None
                         and len(rec.upstream.tokens) >= 2, timeout=30.0)
        eng, uid = rec.replica.engine, rec.replica.uid
        survivor = e2 if eng is e1 else e1
        survivor._decode_once, survivor._resume_suspended = origs[survivor]
        # queue interactive work on the owning replica, then preempt the
        # upstream: the freed (only) slot goes to the interactive request
        it = eng.submit(tenant="live", prompt=P6, num_steps=24)
        assert eng.preempt(rec.upstream)
        assert _wait_for(lambda: rec.upstream.id in eng._suspended,
                         timeout=30.0)
        assert r.scale_down(uid=uid, timeout=0.0) == uid
        np.testing.assert_array_equal(h.result(timeout=60.0), want)
        assert r.counters["requests_failed"] == 0
        assert r.counters["resubmissions"] >= 1
        with pytest.raises(EngineDead):  # the direct submit died typed
            it.result(timeout=5.0)
        assert _wait_for(lambda: survivor.kv_blocks_in_use == 0)
        assert not eng._suspended
    finally:
        r.stop()
