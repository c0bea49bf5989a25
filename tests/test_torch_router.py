"""The port's ``ServingRouter`` (``distkeras_tpu_torch/router.py``): the
cases of the JAX package's ``tests/test_router.py`` on the port's engines,
servers and clients.

The contract pinned here, on the JAX router tests' tiny LM (vocab 17, seq
32, d_model 16, 2 heads, 2 layers, f32; 2 slots, max_len 24, paged blocks
of 4), with the port's ``generate`` as the oracle:

 - a single-replica router is bit-identical to a bare engine (greedy and
   sampled, in-process and over the wire) and streams chunks like one;
 - the lock-free ``load()`` snapshot reports death and drain, the trie's
   node counter survives eviction, and the wire ``'s'`` probe carries the
   engine's keys (the queue/completion and incremental-trie cases of
   ``tests/test_router.py:143,171`` are ``test_torch_serving_fastpath.py
   :: test_load_snapshot_tracks_the_engine`` and
   ``test_torch_serving_paged.py :: test_paged_load_snapshot_reports_the_trie``);
 - the routing units: the route key's block rule, the spill rule,
   rendezvous stability and the saturation spill, dead and draining
   replicas excluded; prefix affinity holds the fleet's hit rate where
   random routing scatters the tenants;
 - the replica-kill matrix (queued, mid-stream, under load, over the wire
   typed and by a torn transport) loses no accepted request: the
   resubmitted stream replays the delivered prefix silently and the row
   equals the unkilled one; a fully dead fleet fails typed; twelve
   threads submitting through a kill, at a short switch interval, lose
   nothing;
 - cancel, rolling swap with every response attributed to one
   ``(replica, generation)``, scale-down without leaked requests or
   blocks, autoscale, the fleet supervisor's restart through
   ``replace_engine``, typed backpressure and drain;
 - ``networking.ClientPool`` and ``RetryPolicy.call_reconnecting``.

Tests wait for the states they assert (a handle done, a token count, the
blocks reclaimed), never for a fixed time.  The parity with the JAX router
(dispatch, counters, rows) is in ``tests/test_torch_router_parity.py``, the
wire interop across the packages in ``tests/test_torch_router_interop.py``.
"""

import zlib

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.resilience import FleetSupervisor, RetryPolicy
from distkeras_tpu_torch.router import ServingRouter
from distkeras_tpu_torch.serving import (Draining, EngineDead, QueueFull,
                                         ServingClient, ServingEngine,
                                         ServingServer)
from test_torch_serving_wire import (PROMPT, _wait_for, _want,  # noqa: F401
                                     models, server_core)

pytestmark = pytest.mark.router

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fitted(models):
    return models[1]


def _engine(fitted, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 24)
    return ServingEngine(fitted, **kw)


def _paged_engine(fitted, **kw):
    kw.setdefault("prefill_mode", "bucketed")
    kw.setdefault("paged", True)
    kw.setdefault("block_size", 4)
    kw.setdefault("kv_blocks", 64)
    return _engine(fitted, **kw)


# ---------------------------------------------------------------------------
# single-replica bit-identity (the defaults-unchanged contract)
# ---------------------------------------------------------------------------

def test_single_replica_router_bit_identical_in_process(fitted):
    with ServingRouter([_engine(fitted)]) as r:
        greedy = r.submit(PROMPT, 8).result(timeout=30)
        sampled = r.submit(PROMPT, 8, temperature=0.9, seed=5,
                           top_k=8).result(timeout=30)
    np.testing.assert_array_equal(greedy, _want(fitted, PROMPT, 8))
    np.testing.assert_array_equal(
        sampled, _want(fitted, PROMPT, 8, temperature=0.9, seed=5,
                       top_k=8))


def test_single_replica_router_bit_identical_over_wire(fitted, server_core):
    with ServingServer(_engine(fitted)) as srv:
        with ServingRouter(addrs=[srv.addr]) as r:
            greedy = r.submit(PROMPT, 8).result(timeout=30)
            sampled = r.submit(PROMPT, 8, temperature=0.9,
                               seed=5).result(timeout=30)
    np.testing.assert_array_equal(greedy, _want(fitted, PROMPT, 8))
    np.testing.assert_array_equal(
        sampled, _want(fitted, PROMPT, 8, temperature=0.9, seed=5))


def test_router_streams_chunks_like_an_engine(fitted):
    with ServingRouter([_engine(fitted)]) as r:
        h = r.submit(PROMPT, 6)
        got = []
        while True:
            chunk, done = h.next_chunk(timeout=5.0)
            got.extend(int(t) for t in chunk)
            if done:
                break
        assert got == list(h.tokens)
        np.testing.assert_array_equal(h.result(), _want(fitted, PROMPT, 6))


def test_router_takes_prompts_as_lists_and_tensors(fitted):
    """A port caller may hold its prompt as a list or a torch tensor: the
    router hashes and submits the same int32 tokens."""
    r = ServingRouter([_engine(fitted)], block_size=4)
    prompt = np.arange(1, 10, dtype=np.int32)
    want = r._route_key(prompt)
    try:
        for form in (prompt.tolist(), torch.from_numpy(prompt.copy()),
                     torch.from_numpy(prompt.astype(np.int64))):
            h = r.submit(form, 4)
            assert h.prompt.dtype == np.int32
            assert r._route_key(h.prompt) == want
        r.start()
        assert _wait_for(lambda: r.counters["requests_completed"] == 3)
    finally:
        r.stop()


def test_router_rejects_non_unified_replicas(fitted):
    pre = _paged_engine(fitted, role="prefill")
    with pytest.raises(ValueError, match="unified"):
        ServingRouter([pre])
    with pytest.raises(ValueError, match="at least one replica"):
        ServingRouter()
    with pytest.raises(ValueError, match="affinity"):
        ServingRouter([_engine(fitted)], affinity="sticky")


# ---------------------------------------------------------------------------
# the lock-free load snapshot
# ---------------------------------------------------------------------------

def test_engine_load_snapshot_reports_death_and_drain(fitted):
    eng = _engine(fitted)
    eng.submit(PROMPT, 4)
    eng.declare_dead("chaos")
    snap = eng.load()
    assert snap["dead"] is True and snap["queue_depth"] == 0

    eng2 = _engine(fitted)
    assert eng2.drain(timeout=10.0)
    assert eng2.load()["draining"] is True


def test_trie_node_counter_survives_eviction(fitted):
    # a pool small enough that later admissions evict cached chains
    eng = _paged_engine(fitted, kv_blocks=8, num_slots=1)
    for seed in range(5):
        p = np.array([seed + 1] * 9, np.int32)  # distinct chains
        h = eng.submit(p, 4, seed=seed)
        while not h.done:
            eng.step()
    assert eng.stats["blocks_evicted"] > 0
    assert eng._pool.trie_nodes == eng._pool.cached_blocks()


def test_wire_stats_probe_matches_engine_load(fitted, server_core):
    with ServingServer(_engine(fitted)) as srv:
        with ServingClient(*srv.addr) as c:
            snap = c.load()
            want = srv.engine.load()
            assert set(snap) == set(want)
            assert snap["slots_total"] == want["slots_total"]
            assert snap["dead"] is False


# ---------------------------------------------------------------------------
# routing policy units
# ---------------------------------------------------------------------------

def test_route_key_follows_trie_block_boundary_rule(fitted):
    r = ServingRouter([_engine(fitted)], block_size=4, affinity_blocks=2)
    # cap is p_len - 1: a 4-token prompt cannot share its only block
    assert r._route_key(np.arange(4, dtype=np.int32)) is None
    k1 = r._route_key(np.arange(5, dtype=np.int32))
    assert k1 == np.arange(4, dtype="<i4").tobytes()
    # affinity_blocks caps the hashed prefix at 2 blocks = 8 tokens
    k2 = r._route_key(np.arange(16, dtype=np.int32))
    assert k2 == np.arange(8, dtype="<i4").tobytes()
    # the block size is read off the first paged replica
    assert ServingRouter([_paged_engine(fitted)]).block_size == 4
    assert ServingRouter([_engine(fitted)]).block_size == 16
    r.stop()


def test_should_spill_rule():
    idle = {"queue_depth": 0, "slots_free": 2, "slots_total": 2}
    busy = {"queue_depth": 2, "slots_free": 0, "slots_total": 2}
    flood = {"queue_depth": 9, "slots_free": 0, "slots_total": 2}
    # free slots: never spill, whatever the queue says
    assert not ServingRouter._should_spill(idle, idle)
    # saturated but within one slot-pool of the least-loaded: stay affine
    assert not ServingRouter._should_spill(busy, idle)
    # saturated AND far deeper than least-loaded: spill
    assert ServingRouter._should_spill(flood, idle)


def test_prefix_dispatch_is_stable_and_spills_under_saturation(fitted):
    r = ServingRouter([_engine(fitted), _engine(fitted)], block_size=4,
                      affinity_blocks=2)
    prompt = np.array([9] * 9, np.int32)
    first = [rep.uid for rep, _ in r._dispatch_order(prompt)][0]
    # rendezvous: the replica whose crc32(key + uid) is largest
    key = np.asarray(prompt[:8], "<i4").tobytes()
    assert first == max((0, 1), key=lambda u: zlib.crc32(
        key + u.to_bytes(4, "little")))
    for _ in range(5):  # same key, same replica, every time
        assert r._dispatch_order(prompt)[0][0].uid == first
    affine = r._replicas[first]
    other = r._replicas[1 - first]
    # saturate the affine replica far past the spill threshold
    affine.load = lambda: {"queue_depth": 9, "slots_free": 0,
                           "slots_total": 2, "active": 2}
    other.load = lambda: {"queue_depth": 0, "slots_free": 2,
                          "slots_total": 2, "active": 0}
    spills0 = r.counters["affinity_spills"]
    assert r._dispatch_order(prompt)[0][0].uid == other.uid
    assert r.counters["affinity_spills"] == spills0 + 1
    r.stop()


def test_dispatch_excludes_dead_and_draining_replicas(fitted):
    e0, e1 = _engine(fitted), _engine(fitted)
    r = ServingRouter([e0, e1], affinity="least-loaded")
    e0.declare_dead("chaos")
    order = r._dispatch_order(PROMPT)
    assert [rep.uid for rep, _ in order] == [1]
    e1.declare_dead("chaos")
    with pytest.raises(EngineDead, match="no live serving replica"):
        r._dispatch_order(PROMPT)
    r.stop()


# ---------------------------------------------------------------------------
# prefix-affinity vs random: the cache-aware-routing win
# ---------------------------------------------------------------------------

def _fleet_trace(groups=4, per_group=5, prefix_len=8, steps=3):
    """Multi-tenant shared-prefix trace: ``groups`` tenants, each with a
    distinct ``prefix_len``-token system prefix and per-request suffix."""
    out = []
    for g in range(groups):
        for i in range(per_group):
            prompt = np.array([g + 2] * prefix_len + [10 + i], np.int32)
            out.append((prompt, steps, g))
    return out


def _run_fleet(fitted, affinity, seed=0):
    engines = [_paged_engine(fitted), _paged_engine(fitted)]
    with ServingRouter(engines, affinity=affinity, block_size=4,
                       affinity_blocks=2, seed=seed) as r:
        by_group = {}
        for prompt, steps, g in _fleet_trace():
            h = r.submit(prompt, steps, seed=g)
            h.result(timeout=30)  # sequential: deterministic trie state
            by_group.setdefault(g, set()).add(r.generation_of(h)[0])
        stats = r.stats
        hit = stats["prefix_hit_tokens"]
        rate = hit / max(hit + stats["prefill_tokens"], 1)
        r.drain(timeout=10.0)
    return rate, by_group, stats


def test_affinity_routing_holds_prefix_hit_rate_where_random_collapses(
        fitted):
    aff_rate, aff_groups, aff_stats = _run_fleet(fitted, "prefix")
    rnd_rate, rnd_groups, _ = _run_fleet(fitted, "random", seed=3)
    # affinity: every tenant's requests landed on ONE warm-trie replica
    assert all(len(uids) == 1 for uids in aff_groups.values())
    # random provably scattered at least one tenant across replicas
    assert any(len(uids) > 1 for uids in rnd_groups.values())
    # and the hit rate shows it: warm tries serve the shared prefix
    assert aff_rate > rnd_rate
    assert aff_rate > 0.4  # 2 shared blocks of a 9-token prompt, 4/5 hits
    assert aff_stats["affinity_routed"] > 0
    assert aff_stats["resubmissions"] == 0


# ---------------------------------------------------------------------------
# replica-kill failover matrix: zero accepted requests lost
# ---------------------------------------------------------------------------

def test_kill_while_queued_resubmits_in_process(fitted):
    # replica 0 never schedules (not started) -> the request parks on it;
    # killing it must move the request to the live replica, bit-identically
    e0, e1 = _engine(fitted), _engine(fitted)
    r = ServingRouter([e0, e1], affinity="least-loaded")
    e1.start()
    try:
        h = r.submit(PROMPT, 8, seed=7, temperature=0.9)
        assert r.generation_of(h) == (0, 0)
        assert len(h.tokens) == 0
        e0.declare_dead("chaos: killed with the request queued")
        got = h.result(timeout=30)
        np.testing.assert_array_equal(
            got, _want(fitted, PROMPT, 8, seed=7, temperature=0.9))
        assert r.generation_of(h) == (1, 0)
        assert r.counters["resubmissions"] == 1
        assert r.counters["requests_failed"] == 0
    finally:
        r.stop()


def test_kill_mid_stream_replays_exactly_once_in_process(fitted):
    # replica 0 is stepped BY HAND: emit a few tokens, then die mid-stream.
    # The resubmitted stream must replay the prefix silently — the client
    # sees each token exactly once, and the row is bit-identical.
    e0, e1 = _engine(fitted), _engine(fitted)
    r = ServingRouter([e0, e1], affinity="least-loaded")
    e1.start()
    try:
        h = r.submit(PROMPT, 10, seed=11, temperature=0.8)
        assert r.generation_of(h) == (0, 0)
        up = r._live[h.id].upstream  # the replica-side handle
        while len(up.tokens) < 3:  # hand-step: 3 of 10 tokens, no more
            e0.step()
        assert _wait_for(lambda: len(h.tokens) >= 3)
        assert not h.done
        prefix = list(h.tokens)[:3]
        e0.declare_dead("chaos: killed mid-stream")
        got = h.result(timeout=30)
        want = _want(fitted, PROMPT, 10, seed=11, temperature=0.8)
        np.testing.assert_array_equal(got, want)
        # the already-delivered prefix was never duplicated or rewritten
        assert list(got[len(PROMPT):len(PROMPT) + 3]) == prefix
        assert r.generation_of(h) == (1, 0)
        assert r.counters["resubmissions"] == 1
        assert r.counters["requests_failed"] == 0
    finally:
        r.stop()


def test_kill_under_load_loses_zero_requests_in_process(fitted):
    e0, e1 = _engine(fitted, num_slots=4), _engine(fitted, num_slots=4)
    r = ServingRouter([e0, e1], affinity="least-loaded")
    e1.start()
    try:
        handles = [(r.submit(PROMPT, 6, seed=s, temperature=0.7), s)
                   for s in range(8)]
        parked = [h for h, _ in handles if r.generation_of(h)[0] == 0]
        assert parked  # least-loaded spread some share onto replica 0
        e0.declare_dead("chaos: killed under load")
        for h, s in handles:
            np.testing.assert_array_equal(
                h.result(timeout=30),
                _want(fitted, PROMPT, 6, seed=s, temperature=0.7))
        assert r.counters["requests_failed"] == 0
        assert r.counters["requests_completed"] == len(handles)
        assert r.counters["resubmissions"] >= len(parked)
    finally:
        r.stop()


def test_kill_resubmits_over_wire_typed_death(fitted, server_core):
    # typed EngineDead through the wire: the dead server answers probes
    # (dead=True) and streams error frames; requests fail over to the
    # live server
    with ServingServer(_engine(fitted)) as s0, \
            ServingServer(_engine(fitted)) as s1:
        with ServingRouter(addrs=[s0.addr, s1.addr],
                           affinity="least-loaded", load_ttl=0.0) as r:
            want = _want(fitted, PROMPT, 8, seed=7, temperature=0.9)
            handles = [r.submit(PROMPT, 8, seed=7, temperature=0.9)
                       for _ in range(4)]
            s0.engine.declare_dead("chaos: wire replica killed")
            for h in handles:
                np.testing.assert_array_equal(h.result(timeout=30), want)
            assert r.counters["requests_failed"] == 0
            assert r.counters["requests_completed"] == 4


def test_kill_resubmits_over_wire_transport_fault(fitted, server_core):
    # the server process "dies" (socket torn, probes unreachable): relays
    # must fail over on the raw ConnectionError, not just typed frames
    s0 = ServingServer(_engine(fitted)).start()
    s1 = ServingServer(_engine(fitted)).start()
    try:
        with ServingRouter(addrs=[s0.addr, s1.addr],
                           affinity="least-loaded", load_ttl=0.0) as r:
            want = _want(fitted, PROMPT, 8, seed=7, temperature=0.9)
            handles = [r.submit(PROMPT, 8, seed=7, temperature=0.9)
                       for _ in range(4)]
            s0.stop()
            for h in handles:
                np.testing.assert_array_equal(h.result(timeout=30), want)
            assert r.counters["requests_failed"] == 0
            assert r._replicas[0].load()["unreachable"] is True
    finally:
        s0.stop()
        s1.stop()


def test_concurrent_submitters_through_a_kill_lose_nothing(fitted):
    """More submitting threads than cores, with a short interpreter switch
    interval, through a fleet whose replica 0 dies mid-run: every accepted
    request ends with its own row, exactly once, and the router's terminal
    counters balance (a lost update in the shared routing state would
    break one of the three)."""
    import sys
    import threading
    e0, e1 = _engine(fitted, num_slots=4), _engine(fitted, num_slots=4)
    r = ServingRouter([e0, e1], affinity="least-loaded")
    got, errors = {}, []
    started = threading.Barrier(13)

    def user(u):
        started.wait(timeout=30)
        for k in range(3):
            seed = 10 * u + k
            try:
                got[seed] = r.submit(PROMPT, 4, seed=seed,
                                     temperature=0.8).result(timeout=60)
            except Exception as e:  # collected: the test asserts none
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        r.start()
        users = [threading.Thread(target=user, args=(u,)) for u in range(12)]
        for t in users:
            t.start()
        started.wait(timeout=30)
        assert _wait_for(lambda: r.counters["requests_completed"] >= 6)
        e0.declare_dead("chaos: replica 0 killed under concurrent load")
        for t in users:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        r.stop()
    assert errors == []
    assert sorted(got) == sorted(10 * u + k for u in range(12)
                                 for k in range(3))
    for seed, row in got.items():
        np.testing.assert_array_equal(
            row, _want(fitted, PROMPT, 4, seed=seed, temperature=0.8))
    c = r.counters
    assert c["requests_submitted"] == c["requests_completed"] == 36
    assert c["requests_failed"] == 0


def test_whole_fleet_dead_fails_typed(fitted):
    e0 = _engine(fitted)
    r = ServingRouter([e0], retry_policy=RetryPolicy(attempts=2,
                                                     backoff=0.01))
    h = r.submit(PROMPT, 8)  # single replica: kill it with it in flight
    e0.declare_dead("chaos: the whole fleet")
    with pytest.raises(EngineDead):
        h.result(timeout=30)
    assert r.counters["requests_failed"] == 1
    assert r.dead is not None
    with pytest.raises(EngineDead):
        r.submit(PROMPT, 4)
    r.stop()


def test_cancel_mid_failover_mirrors_cancel(fitted):
    e0, e1 = _engine(fitted), _engine(fitted)
    r = ServingRouter([e0, e1], affinity="least-loaded")
    e1.start()
    try:
        h = r.submit(PROMPT, 8)
        assert r.cancel(h) is True
        e0.step()  # one scheduler iteration sheds the cancelled request
        assert _wait_for(lambda: h.done)
        assert h.finish == "cancel"
        assert r.cancel(h) is False
        assert r.counters["requests_cancelled"] == 1
    finally:
        r.stop()


# ---------------------------------------------------------------------------
# rolling blue/green: every response attributed to exactly one generation
# ---------------------------------------------------------------------------

def test_rolling_swap_under_traffic_attributes_every_response(fitted):
    e0, e1 = _engine(fitted), _engine(fitted)
    with ServingRouter([e0, e1], affinity="least-loaded") as r:
        want = _want(fitted, PROMPT, 6, seed=2, temperature=0.6)
        before = [r.submit(PROMPT, 6, seed=2, temperature=0.6)
                  for _ in range(4)]
        assert r.rolling_swap(drain_timeout=15.0) == 2
        after = [r.submit(PROMPT, 6, seed=2, temperature=0.6)
                 for _ in range(4)]
        for h in before + after:
            np.testing.assert_array_equal(h.result(timeout=30), want)
        gens = [r.generation_of(h) for h in before + after]
        # exactly one (replica, generation) per response, all valid
        assert all(g is not None and g[1] in (0, 1) for g in gens)
        # post-swap traffic runs on the NEW generation only
        assert all(g[1] == 1 for g in [r.generation_of(h) for h in after])
        assert r.counters["generation_swaps"] == 2
        assert r.counters["requests_failed"] == 0
        # the swapped-out engines are fully retired, replacements live
        assert e0 not in r.engines and e1 not in r.engines
        assert len(r.engines) == 2


# ---------------------------------------------------------------------------
# elasticity: scale up on queue pressure, drain down without leaks
# ---------------------------------------------------------------------------

def test_scale_down_drains_without_losing_requests_or_blocks(fitted):
    e0, e1 = _paged_engine(fitted), _paged_engine(fitted)
    with ServingRouter([e0, e1], affinity="least-loaded") as r:
        handles = [r.submit(PROMPT, 4, seed=s) for s in range(6)]
        for h in handles:
            h.result(timeout=30)
        victim_uid = r.scale_down(timeout=15.0)
        assert victim_uid is not None
        assert r.num_replicas == 1
        victim = e0 if victim_uid == 0 else e1
        assert victim not in r.engines
        # the drained replica leaked nothing: every request terminal,
        # every KV block back in its pool
        assert victim.kv_blocks_in_use == 0
        s = victim.stats
        assert (s["requests_submitted"]
                == s["requests_completed"] + s["requests_failed"]
                + s["requests_rejected"])
        assert r.counters["requests_failed"] == 0
        # min_replicas floor: the last replica is not drainable
        assert r.scale_down(timeout=5.0) is None
        # the survivor still serves
        np.testing.assert_array_equal(
            r.submit(PROMPT, 4, seed=0).result(timeout=30),
            _want(fitted, PROMPT, 4, seed=0))
        assert _wait_for(lambda: r.kv_blocks_in_use == 0, timeout=10.0)


def test_autoscale_tick_grows_on_queue_pressure(fitted):
    e0 = _engine(fitted, num_slots=1, queue_capacity=16)
    r = ServingRouter([e0], engine_factory=lambda: _engine(fitted),
                      scale_up_queue=2, max_replicas=2)
    try:
        parked = [r.submit(PROMPT, 4, seed=s)
                  for s in range(6)]  # replica 0 not started: queue grows
        assert r.autoscale_tick() == "up"
        assert r.num_replicas == 2
        assert r.counters["scale_ups"] == 1
        # the new replica is live: a fresh request routes somewhere live
        # (replica 0 is saturated per the spill rule) and completes
        r.start()
        np.testing.assert_array_equal(
            r.submit(PROMPT, 4, seed=0).result(timeout=30),
            _want(fitted, PROMPT, 4, seed=0))
        for s, h in enumerate(parked):  # zero-loss through the scale-up
            np.testing.assert_array_equal(
                h.result(timeout=30), _want(fitted, PROMPT, 4, seed=s))
    finally:
        r.stop()


def test_fleet_supervisor_restarts_dead_replica(fitted):
    e0, e1 = _engine(fitted), _engine(fitted)
    with ServingRouter([e0, e1], affinity="least-loaded") as r:
        sup = FleetSupervisor(r, liveness_deadline=5.0)
        assert sup.check_all() == [None, None]
        e0.declare_dead("chaos")
        assert sup.check_all()[0] == "crashed"
        recs = sup.recover_all()
        assert len(recs) == 1 and recs[0]["restarted"]
        assert sup.restarts == 1
        # the replacement went in through replace_engine: generation
        # bumped, fresh engine serving
        assert e0 not in r.engines and len(r.engines) == 2
        snap = r.fleet_snapshot()
        assert snap[0]["generation"] == 1
        np.testing.assert_array_equal(
            r.submit(PROMPT, 4).result(timeout=30),
            _want(fitted, PROMPT, 4))
        # elastic membership: refresh() tracks a scale-up
        r.engine_factory = lambda: _engine(fitted)
        r.scale_up()
        sup.refresh()
        assert len(sup.supervisors) == 3


# ---------------------------------------------------------------------------
# admission semantics at the router boundary
# ---------------------------------------------------------------------------

def test_router_backpressure_is_typed_and_blocking_waits(fitted):
    e0 = _engine(fitted, num_slots=1, queue_capacity=1)
    r = ServingRouter([e0])  # not started: nothing drains the queue
    try:
        h = r.submit(PROMPT, 4, block=False)
        with pytest.raises(QueueFull):
            r.submit(PROMPT, 4, block=False)
        with pytest.raises(QueueFull):
            r.submit(PROMPT, 4, block=True, timeout=0.05)
        r.cancel(h)
        e0.step()  # shed the parked request so teardown has no stragglers
        assert _wait_for(lambda: h.done)
        assert r.counters["requests_rejected"] == 2
    finally:
        r.stop()


def test_router_drain_stops_admission_typed(fitted):
    with ServingRouter([_engine(fitted)]) as r:
        h = r.submit(PROMPT, 4)
        assert r.drain(timeout=15.0)
        np.testing.assert_array_equal(h.result(timeout=5),
                                      _want(fitted, PROMPT, 4))
        with pytest.raises(Draining):
            r.submit(PROMPT, 4)
        assert r.counters["requests_rejected"] == 1


# ---------------------------------------------------------------------------
# networking.ClientPool + RetryPolicy.call_reconnecting units
# ---------------------------------------------------------------------------

class _FakeClient:
    def __init__(self, addr):
        self.addr = addr
        self.closed = False

    def close(self):
        self.closed = True


def test_client_pool_reuses_and_bounds_idle():
    pool = networking.ClientPool(_FakeClient, max_idle_per_addr=2)
    a = ("h", 1)
    c1 = pool.acquire(a)
    assert pool.dials == 1
    pool.release(a, c1)
    assert pool.acquire(a) is c1 and pool.reuses == 1
    extra = [pool.acquire(a) for _ in range(3)]
    assert pool.dials == 4
    for c in [c1] + extra:
        pool.release(a, c)
    # only max_idle_per_addr stay pooled; the overflow is closed
    assert sum(1 for c in [c1] + extra if c.closed) == 2
    broken = pool.acquire(a)
    pool.discard(broken)
    assert broken.closed and pool.discards == 1
    pool.close()
    assert all(c.closed for c in [c1] + extra)


def test_retry_policy_call_reconnecting_repairs_transport():
    calls, redials = [], []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("torn")
        return "ok"

    def reconnect():
        redials.append(1)
        if len(redials) == 1:
            raise OSError("still down")  # swallowed: policy backs off

    pol = RetryPolicy(attempts=5, backoff=0.001, jitter=0.0)
    assert pol.call_reconnecting(
        fn, reconnect, retry_on=(ConnectionError,)) == "ok"
    assert len(calls) == 3 and len(redials) == 2

    # typed (non-transport) failures retry WITHOUT touching the transport
    calls.clear(), redials.clear()

    def typed():
        calls.append(1)
        if len(calls) < 2:
            raise EngineDead("restarting")
        return "ok"

    assert pol.call_reconnecting(
        typed, reconnect, retry_on=(EngineDead,)) == "ok"
    assert redials == []
