"""The port's multi-tenant QoS and paged-KV preemption (``ServingEngine(
tenants=)``, ``register_tenant``, ``submit(tenant=, priority=)``,
``preempt``) against the JAX engine.

The contract pinned here, on the JAX QoS tests' tiny LM (vocab 17, seq 32,
d_model 16, 2 heads, 2 layers, f32; 2 slots, max_len 32, blocks of 4, 30
blocks), one numpy weight set in both packages:

 - policy validation, registration and clones, the weighted-fair pop
   order, priority within a tenant, the FIFO of an engine without
   tenants, quotas, tier deadline bands and per-tenant shed accounting
   equal the JAX engine's;
 - one script of ``submit`` / ``preempt`` / ``step`` through both engines
   suspends and resumes the same requests at the same steps, picks the
   same victims and books the same QoS counters, blocks and bytes
   swapped included; greedy rows equal the JAX engine's, sampled rows
   the port's own unpreempted rows (the two packages draw other bits);
 - cancel, deadline, inline drain, engine death and drain timeout while a
   request is suspended end as the JAX engine's do, typed, with no block
   leaked;
 - port cases: an int8 arena, a resume into another slot, ``preempt()``
   refused on dense, rolling and speculative engines, ``warmup`` leaving
   no trace, the decode step's graph (a recording stand-in here) never
   captured again and the static device state kept in place across a
   swap, a decode-only iteration with tenants registered, seeded random
   interleavings, and the fast overload leg.
"""

import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import distkeras_tpu.serving as jserving
import distkeras_tpu_torch.serving as pserving
from distkeras_tpu_torch import (Draining, EngineDead, QueueFull,
                                 QuotaExceeded, RequestHandle, ServingEngine,
                                 TenantPolicy)
from test_torch_serving_fastpath import (RecordingGraph, _want, both,
                                         graphed)  # noqa: F401

pytestmark = pytest.mark.qos

torch.set_num_threads(1)

P6 = np.arange(1, 7, dtype=np.int32)
BULK_LIVE = (("bulk", {"tier": "batch"}), ("live", {"tier": "interactive"}))
REQS = {
    "bulk_sampled": dict(prompt=P6, num_steps=18, temperature=0.8, seed=7),
    "bulk_greedy": dict(prompt=P6[::-1].copy(), num_steps=18),
    "bulk_lo": dict(prompt=P6, num_steps=14, temperature=0.7, seed=11),
    "bulk_hi": dict(prompt=np.array([2, 9, 4, 1, 8, 5], np.int32),
                    num_steps=14, temperature=0.7, seed=23),
    "interactive": dict(prompt=np.array([1, 2, 3, 4, 5], np.int32),
                        num_steps=8),
}
#: the counters a script must book alike in both engines
QOS_STATS = ("requests_submitted", "requests_completed", "requests_failed",
             "requests_rejected", "requests_cancelled", "requests_expired",
             "tokens_generated", "decode_steps", "prefills", "preemptions",
             "resumes", "kv_blocks_swapped_out", "kv_block_bytes_swapped_out",
             "kv_blocks_resumed", "kv_block_bytes_resumed", "quota_refused",
             "tenants")


@pytest.fixture(scope="module")
def pair():
    return both()


@pytest.fixture(scope="module")
def fitted(pair):
    return pair[1]


@pytest.fixture(scope="module")
def port_ref(fitted):
    """Unpreempted rows of every request shape from a paged port engine
    without tenants: what a preempted sampled row must equal."""
    eng = pserving.ServingEngine(fitted, paged=True, num_slots=2, max_len=32,
                                 block_size=4, kv_blocks=30)
    hs = {k: eng.submit(**kw) for k, kw in REQS.items()}
    eng.run_until_idle()
    assert eng.kv_blocks_in_use == 0
    return {k: h.result() for k, h in hs.items()}


def _policies(mod, specs):
    return [mod.TenantPolicy(name, **kw) for name, kw in specs]


def _mk(mod, f, specs=BULK_LIVE, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("kv_blocks", 30)
    kw.setdefault("paged", True)
    return mod.ServingEngine(
        f, tenants=_policies(mod, specs) if specs else None, **kw)


def _on_both(pair, script, **kw):
    """Run ``script(engine, module)`` on a JAX and a port engine built
    alike; returns (JAX result, port result)."""
    return tuple(script(_mk(mod, f, **kw), mod)
                 for mod, f in ((jserving, pair[0]), (pserving, pair[1])))


def _qos(eng) -> dict:
    out = {k: eng.stats[k] for k in QOS_STATS}
    out["swap_samples"] = (len(eng.stats["preempt_swap_ms"]),
                           len(eng.stats["preempt_resume_ms"]))
    return out


def _step_until(eng, pred, max_steps=400, what="condition") -> int:
    for n in range(max_steps):
        if pred():
            return n
        eng.step()
    assert pred(), f"never reached {what} in {max_steps} inline steps"
    return max_steps


def _wait(pred, timeout=60.0, poll=0.005, what="condition"):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(poll)


def _assert_idle(eng):
    assert eng.kv_blocks_in_use == 0
    assert eng._pool.check_conservation()
    assert not eng._plans and not eng._suspended


# ---------------------------------------------------------------------------
# policy surface: validation, registration, clone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(name=""), dict(name="t", weight=0.0), dict(name="t", rate=-1.0),
    dict(name="t", rate=1.0, burst=0.5), dict(name="t", tier="gold"),
    dict(name="t", deadline_s=0.0),
])
def test_tenant_policy_validation_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jserving.TenantPolicy(**bad)
    with pytest.raises(ValueError) as got:
        TenantPolicy(**bad)
    assert str(got.value) == str(want.value)
    # QuotaExceeded IS backpressure to untyped callers
    assert issubclass(QuotaExceeded, QueueFull)


def test_policy_defaults_and_clone_as_jax():
    for kw in (dict(), dict(rate=3.0), dict(rate=0.5), dict(rate=2.0,
                                                            burst=5.0)):
        j, p = jserving.TenantPolicy("t", **kw), TenantPolicy("t", **kw)
        assert (p.weight, p.rate, p.burst, p.tier, p.deadline_s,
                p._tokens) == (j.weight, j.rate, j.burst, j.tier,
                               j.deadline_s, j._tokens)


def test_register_tenant_and_clone(pair):
    def script(eng, mod):
        with pytest.raises(ValueError, match="expected a TenantPolicy"):
            eng.register_tenant("not-a-policy")
        p = mod.TenantPolicy("metered", rate=10.0, burst=2.0)
        p._tokens = 0.0  # drained bucket
        c = p.clone()
        eng.register_tenant(p)
        assert eng._tenants["metered"] is p
        return (c._tokens, c.burst, c.name, c.rate, c.tier,
                sorted(eng._tenants))
    want, got = _on_both(pair, script)
    assert got == want == (2.0, 2.0, "metered", 10.0, "batch",
                           ["bulk", "live", "metered"])
    with pytest.raises(ValueError, match="TenantPolicy instances"):
        ServingEngine(pair[1], num_slots=1, max_len=24, tenants=["gold"])


def test_respawn_clone_carries_fresh_buckets(fitted):
    eng = _mk(pserving, fitted, specs=(("metered", {"rate": 1.0,
                                                     "burst": 2.0}),))
    eng._tenants["metered"]._tokens = 0.0
    clone = eng.respawn_clone()
    pol = clone._tenants["metered"]
    assert pol is not eng._tenants["metered"]
    assert (pol.rate, pol.burst, pol._tokens) == (1.0, 2.0, 2.0)
    assert clone._can_preempt and clone.paged and clone.kv_blocks == 30


# ---------------------------------------------------------------------------
# admission order: WFQ stride, tiers, priority, FIFO degenerate
# ---------------------------------------------------------------------------

def test_weighted_fair_pop_order(pair):
    """Interactive tier first; within the batch tier a weight-2 tenant
    gets two admissions per weight-1 admission, in the JAX engine's
    exact sequence."""
    specs = (("a", {"weight": 2.0}), ("b", {"weight": 1.0}),
             ("live", {"tier": "interactive"}))

    def script(eng, mod):
        a = [eng.submit(P6, 4, tenant="a", block=False) for _ in range(4)]
        b = [eng.submit(P6, 4, tenant="b", block=False) for _ in range(4)]
        i0 = eng.submit(P6, 4, tenant="live", block=False)
        with eng._qlock:
            order = [eng._q_pop_locked() for _ in range(9)]
            assert eng._q_pop_locked() is None
        want = [i0, a[0], b[0], a[1], a[2], b[1], a[3], b[2], b[3]]
        assert [h.id for h in order] == [h.id for h in want]
        return [(h.id, h.tenant) for h in order], dict(eng._wf_pass)
    want, got = _on_both(pair, script, specs=specs)
    assert got == want


def test_newcomer_pass_is_seeded_at_the_backlog_floor(pair):
    """A tenant joining a backlog starts at the least backlogged pass: it
    banks no idle credit, and its picks interleave as the JAX engine's."""
    def script(eng, mod):
        for _ in range(3):
            eng.submit(P6, 4, tenant="a", block=False)
        with eng._qlock:
            eng._q_pop_locked()
            eng._q_pop_locked()
        for _ in range(3):
            eng.submit(P6, 4, tenant="c", block=False)
        with eng._qlock:
            order = [eng._q_pop_locked().tenant for _ in range(4)]
        return order, dict(eng._wf_pass)
    want, got = _on_both(pair, script, specs=(("a", {}), ("c", {})))
    assert got == want


def test_priority_within_tenant(pair):
    def script(eng, mod):
        hs = [eng.submit(P6, 4, tenant="bulk", priority=p, block=False)
              for p in (0, 5, 1, 5)]
        with eng._qlock:
            order = [eng._q_pop_locked() for _ in range(4)]
        # highest priority first, FIFO among equals
        assert [h.id for h in order] == [hs[1].id, hs[3].id, hs[2].id,
                                         hs[0].id]
        return [(h.id, h.priority) for h in order]
    want, got = _on_both(pair, script)
    assert got == want


def test_defaults_degenerate_to_fifo(pair):
    """No tenants registered: the pop is plain FIFO, requests land under
    the "default" tenant, and the load snapshot shows no interactive
    backlog."""
    def script(eng, mod):
        hs = [eng.submit(P6, 4, block=False) for _ in range(3)]
        assert eng.load()["queued_interactive"] == 0
        assert eng.queue_depth == 3
        with eng._qlock:
            order = [eng._q_pop_locked() for _ in range(3)]
        assert [h.id for h in order] == [h.id for h in hs]
        assert all(h.tenant == "default" and h.priority == 0 for h in hs)
        return eng.stats["tenants"]
    want, got = _on_both(pair, script, specs=None)
    assert got == want == {"default": {"submitted": 3, "completed": 0,
                                       "shed": 0, "quota_refused": 0,
                                       "preemptions": 0, "resumes": 0}}


def test_no_tenants_admission_order_as_jax(pair):
    """Without tenants one slot serves unnamed requests in submission
    order, and a backlog of named tenants and priorities in the JAX
    engine's order (unregistered names are weight-1 batch queues)."""
    def script(eng, mod):
        plain = [eng.submit(P6, 3) for _ in range(3)]
        eng.run_until_idle()
        named = [eng.submit(P6, 3, tenant=t, priority=p)
                 for t, p in (("x", 0), ("y", 9), ("x", 5), (None, 0),
                              ("y", 1))]
        eng.run_until_idle()
        _assert_idle(eng)
        order = [sorted(hs, key=lambda h: h.started_at)
                 for hs in (plain, named)]
        assert order[0] == plain
        return [[h.id for h in o] for o in order]
    want, got = _on_both(pair, script, specs=None, num_slots=1)
    assert got == want


def test_queued_interactive_in_load_snapshot(pair):
    def script(eng, mod):
        eng.submit(P6, 4, tenant="live", block=False)
        eng.submit(P6, 4, tenant="bulk", block=False)
        eng.submit(P6, 4, tenant="live", block=False)
        first = eng.load()["queued_interactive"]
        eng.step()
        return first, eng.load()["queued_interactive"], eng.queue_depth
    want, got = _on_both(pair, script)
    assert got == want and got[0] == 2


# ---------------------------------------------------------------------------
# quotas + tier deadline bands + shed accounting
# ---------------------------------------------------------------------------

def test_quota_token_bucket(pair):
    def script(eng, mod):
        eng.submit(P6, 4, tenant="metered", block=False)
        eng.submit(P6, 4, tenant="metered", block=False)
        # quota is policy, not backpressure: block=True raises too
        with pytest.raises(mod.QuotaExceeded):
            eng.submit(P6, 4, tenant="metered", block=True)
        eng.submit(P6, 4, tenant="other", block=False)
        return _qos(eng)
    want, got = _on_both(pair, script, specs=(
        ("metered", {"rate": 0.001, "burst": 2.0}),))
    assert got == want
    assert got["quota_refused"] == 1 and got["requests_submitted"] == 3
    assert got["tenants"]["metered"]["quota_refused"] == 1
    assert got["tenants"]["other"]["quota_refused"] == 0


def test_tier_deadline_band(pair):
    def script(eng, mod):
        now = time.perf_counter()
        h = eng.submit(P6, 4, tenant="live", block=False)
        assert 4.0 < h.deadline - now <= 5.5
        # an explicit per-request deadline wins over the tier band
        h2 = eng.submit(P6, 4, tenant="live", deadline_s=0.5, block=False)
        assert h2.deadline - now <= 1.0
        h3 = eng.submit(P6, 4, tenant="bulk", block=False)
        return h3.deadline
    want, got = _on_both(pair, script, specs=(
        ("live", {"tier": "interactive", "deadline_s": 5.0}),
        ("bulk", {})))
    assert got is None and want is None


def test_per_tenant_shed_accounting(pair):
    def script(eng, mod):
        eng.submit(P6, 4, tenant="a", block=False)  # fills the queue
        for t in ("b", "c"):
            with pytest.raises(mod.QueueFull):
                eng.submit(P6, 4, tenant=t, block=False)
        eng.submit(P6, 0, tenant="d")                # completes in place
        return _qos(eng)
    want, got = _on_both(pair, script, queue_capacity=1)
    assert got == want
    assert got["requests_rejected"] == 2
    for t in ("b", "c"):
        assert (got["tenants"][t]["submitted"],
                got["tenants"][t]["shed"]) == (1, 1)
    assert got["tenants"]["d"]["completed"] == 1


# ---------------------------------------------------------------------------
# preemption: swap-out, resume, starvation victim choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bulk_sampled", "bulk_greedy"])
def test_preempt_resume_matches_jax_and_unpreempted(pair, port_ref, name):
    """An explicit preempt mid-decode: the blocks cross to the host (d2h
    moves), the slot and every block free, and the resumed stream (h2d
    moves) equals the unpreempted one; the script suspends at the same
    step with the same blocks and bytes in both engines."""
    def script(eng, mod):
        h = eng.submit(tenant="bulk", **REQS[name])
        n0 = _step_until(eng, lambda: len(h.tokens) >= 6)
        d2h0 = eng.stats["d2h_transfers"]
        assert eng.preempt(h) is True
        n1 = _step_until(eng, lambda: h.id in eng._suspended)
        assert h.slot is None and h.finish is None
        assert eng.kv_blocks_in_use == 0
        assert eng.stats["d2h_transfers"] > d2h0
        rec = eng._suspended[h.id]
        at = (n0, n1, len(h.tokens), rec.n_blocks, rec.pos, rec.tok)
        h2d0 = eng.stats["h2d_transfers"]
        eng.run_until_idle()
        assert eng.stats["h2d_transfers"] > h2d0
        assert h.finish in ("eos", "length")
        assert eng.kv_blocks_in_use == 0
        return at, _qos(eng), h.result()
    (jat, jstats, jrow), (at, stats, row) = _on_both(pair, script)
    assert stats == jstats
    assert stats["preemptions"] == stats["resumes"] == 1
    assert stats["kv_block_bytes_resumed"] == \
        stats["kv_block_bytes_swapped_out"] > 0
    assert stats["swap_samples"] == (1, 1)
    assert stats["tenants"]["bulk"]["completed"] == 1
    np.testing.assert_array_equal(row, port_ref[name])
    if "temperature" in REQS[name]:
        assert at[:-1] == jat[:-1]   # the frontier token is a draw
    else:
        assert at == jat
        np.testing.assert_array_equal(row, jrow)


def test_starvation_preempts_lowest_priority(pair, port_ref):
    """A starved interactive submission suspends the lowest-priority
    batch request; every iteration's suspended set and slot map equal the
    JAX engine's, and every stream equals its unpreempted row."""
    def script(eng, mod):
        lo = eng.submit(tenant="bulk", priority=0, **REQS["bulk_lo"])
        hi = eng.submit(tenant="bulk", priority=5, **REQS["bulk_hi"])
        _step_until(eng, lambda: lo.slot is not None
                    and hi.slot is not None)
        it = eng.submit(tenant="live", **REQS["interactive"])
        log = []
        while eng.step():
            log.append((tuple(eng._suspended),
                        tuple(h.slot for h in (lo, hi, it))))
        # victim choice: the lowest priority first
        assert next(e[0] for e in log if e[0]) == (lo.id,)
        for h in (lo, hi, it):
            assert h.finish in ("eos", "length")
        return log, _qos(eng), [h.result() for h in (lo, hi, it)]
    (jlog, jstats, jrows), (log, stats, rows) = _on_both(pair, script)
    assert log == jlog
    assert stats == jstats
    assert stats["preemptions"] >= 1
    assert stats["resumes"] == stats["preemptions"]
    assert stats["tenants"]["live"]["preemptions"] == 0
    np.testing.assert_array_equal(rows[2], jrows[2])          # greedy
    for row, name in zip(rows, ("bulk_lo", "bulk_hi", "interactive")):
        np.testing.assert_array_equal(row, port_ref[name])


def test_block_starvation_flags_preemption(pair, port_ref):
    """An interactive request refused blocks (a slot free, the arena full)
    preempts a batch request on the next iteration, as in the JAX
    engine."""
    def script(eng, mod):
        a = eng.submit(tenant="bulk", **REQS["bulk_sampled"])
        _step_until(eng, lambda: len(a.tokens) >= 2)
        it = eng.submit(tenant="live", prompt=P6, num_steps=24)
        log = []
        while eng.step():
            log.append((tuple(eng._suspended), a.slot, it.slot))
        return log, _qos(eng), a.result(), it.result()
    (jlog, jstats, _, jit), (log, stats, row, it) = _on_both(
        pair, script, kv_blocks=12)
    assert log == jlog and stats == jstats
    assert stats["preemptions"] == stats["resumes"] >= 1
    np.testing.assert_array_equal(it, jit)
    np.testing.assert_array_equal(row, port_ref["bulk_sampled"])


def test_cancel_and_deadline_while_suspended(pair):
    """Cancel and deadline of a suspended request are bookkeeping: the
    host copy drops, the handle retires typed, nothing resumes."""
    def script(eng, mod):
        h = eng.submit(tenant="bulk", **REQS["bulk_sampled"])
        _step_until(eng, lambda: len(h.tokens) >= 2)
        assert eng.preempt(h)
        _step_until(eng, lambda: h.id in eng._suspended)
        assert eng.cancel(h) is True
        _step_until(eng, lambda: h.finish is not None)
        assert not eng._suspended and eng.kv_blocks_in_use == 0
        h2 = eng.submit(tenant="bulk", deadline_s=60.0, **REQS["bulk_lo"])
        _step_until(eng, lambda: len(h2.tokens) >= 2)
        assert eng.preempt(h2)
        _step_until(eng, lambda: h2.id in eng._suspended)
        # the deadline lapses while swapped out: the absolute deadline
        # moves into the past once the state is reached (no wall-clock race)
        h2.deadline = time.perf_counter() - 1.0
        _step_until(eng, lambda: h2.finish is not None)
        assert not eng._suspended and eng.kv_blocks_in_use == 0
        return (h.finish, h2.finish), _qos(eng), eng.stats["slot_reclaim_ms"]
    (jfin, jstats, jrec), (fin, stats, rec) = _on_both(pair, script)
    assert fin == jfin == ("cancel", "deadline")
    assert stats == jstats
    assert stats["resumes"] == 0 and stats["preemptions"] == 2
    assert len(rec) == len(jrec) == 0   # nothing to reclaim


def test_drain_inline_resumes_suspended(pair, port_ref):
    def script(eng, mod):
        h = eng.submit(tenant="bulk", **REQS["bulk_sampled"])
        _step_until(eng, lambda: len(h.tokens) >= 4)
        assert eng.preempt(h)
        _step_until(eng, lambda: h.id in eng._suspended)
        assert eng.drain(timeout=60.0) is True
        assert eng.kv_blocks_in_use == 0
        return _qos(eng), h.result()
    (jstats, _), (stats, row) = _on_both(pair, script)
    assert stats == jstats and stats["resumes"] == 1
    np.testing.assert_array_equal(row, port_ref["bulk_sampled"])


def test_declare_dead_fails_suspended_typed(pair):
    def script(eng, mod):
        h = eng.submit(tenant="bulk", **REQS["bulk_sampled"])
        q = eng.submit(tenant="bulk", **REQS["bulk_lo"])
        r = eng.submit(tenant="bulk", **REQS["bulk_hi"])
        _step_until(eng, lambda: len(h.tokens) >= 2)
        assert eng.preempt(h)
        _step_until(eng, lambda: h.id in eng._suspended)
        eng.declare_dead("supervisor kill")
        with pytest.raises(mod.EngineDead, match="swapped out"):
            h.result(timeout=5.0)
        for other in (q, r):
            with pytest.raises(mod.EngineDead, match="supervisor kill"):
                other.result(timeout=5.0)
        assert h.finish == "error" and not eng._suspended
        assert eng.queue_depth == 0 and eng.load()["dead"]
        return str(h.error), _qos(eng)
    (jmsg, jstats), (msg, stats) = _on_both(pair, script)
    assert msg == jmsg
    assert stats == jstats and stats["requests_failed"] == 3


def test_drain_timeout_fails_suspended_typed(fitted):
    """A started engine whose only slot serves interactive work cannot
    resume the suspended batch request: drain times out and fails it
    typed (the reason names the swap-out) instead of hanging."""
    eng = _mk(pserving, fitted, num_slots=1)
    eng.start()
    try:
        h = eng.submit(tenant="bulk", prompt=P6, num_steps=24,
                       temperature=0.8, seed=7)
        _wait(lambda: h.slot is not None, what="decode start")
        it = eng.submit(tenant="live", prompt=P6, num_steps=24)
        assert eng.preempt(h)
        _wait(lambda: h.id in eng._suspended, what="suspension")
        assert eng.drain(timeout=0.0, poll=0.001) is False
        with pytest.raises(EngineDead, match="swapped out"):
            h.result(timeout=5.0)
        with pytest.raises(EngineDead):
            it.result(timeout=5.0)
        assert h.finish == "drain"
        with pytest.raises((EngineDead, Draining)):
            eng.submit(P6, 2)
    finally:
        eng.stop()
    s = eng.stats
    assert (s["requests_submitted"] == s["requests_completed"]
            + s["requests_failed"] + s["requests_rejected"])


# ---------------------------------------------------------------------------
# port cases
# ---------------------------------------------------------------------------

def test_int8_arena_preempt_resume_matches_jax(pair):
    """An int8 paged arena swaps codes and scales: greedy rows, blocks and
    bytes equal the JAX int8 engine's, and the row its own unpreempted
    run's."""
    def script(eng, mod):
        ref = _mk(mod, pair[1] if mod is pserving else pair[0],
                  kv_dtype="int8")
        r = ref.submit(tenant="bulk", **REQS["bulk_greedy"])
        ref.run_until_idle()
        h = eng.submit(tenant="bulk", **REQS["bulk_greedy"])
        _step_until(eng, lambda: len(h.tokens) >= 5)
        assert eng.preempt(h)
        eng.run_until_idle()
        assert set(eng._suspended) == set()
        return _qos(eng), h.result(), r.result()
    (jstats, jrow, jref), (stats, row, ref) = _on_both(pair, script,
                                                       kv_dtype="int8")
    assert stats == jstats and stats["preemptions"] == 1
    # codes 1 B + a 4-byte scale per kv head, k and v, 2 layers, 4 rows
    per_block = 2 * 2 * 4 * 2 * (8 + 4)
    assert stats["kv_block_bytes_swapped_out"] == \
        per_block * stats["kv_blocks_swapped_out"]
    np.testing.assert_array_equal(row, jrow)
    np.testing.assert_array_equal(row, ref)
    np.testing.assert_array_equal(jrow, jref)


def test_resume_into_another_slot(pair, port_ref):
    """A request suspended from one slot resumes in another (its freed
    slot went to a queued request): its stream is slot-independent."""
    def script(eng, mod):
        a = eng.submit(tenant="bulk", **REQS["bulk_sampled"])
        b = eng.submit(tenant="bulk", prompt=P6, num_steps=4)
        _step_until(eng, lambda: len(a.tokens) >= 3)
        left = a.slot
        c = eng.submit(tenant="bulk", **REQS["bulk_greedy"])
        assert eng.preempt(a)
        _step_until(eng, lambda: a.id in eng._suspended)
        _step_until(eng, lambda: a.slot is not None)
        resumed = a.slot
        eng.run_until_idle()
        return (left, resumed), _qos(eng), [h.result() for h in (a, b, c)]
    (jslots, jstats, jrows), (slots, stats, rows) = _on_both(pair, script)
    assert slots == jslots and slots[0] != slots[1]
    assert stats == jstats and stats["resumes"] == 1
    np.testing.assert_array_equal(rows[0], port_ref["bulk_sampled"])
    np.testing.assert_array_equal(rows[2], port_ref["bulk_greedy"])
    np.testing.assert_array_equal(rows[1], jrows[1])
    np.testing.assert_array_equal(rows[2], jrows[2])


@pytest.mark.parametrize("kind", ["dense", "rolling", "speculative"])
def test_preempt_refused_where_jax_refuses(kind):
    """``preempt()`` is False on dense, rolling and speculative engines,
    as in the JAX engine; the tenants still order admission there."""
    kw = {"dense": dict(paged=False), "rolling": dict(rolling=True),
          "speculative": dict(spec_len=2)}[kind]
    jf, pf = both(seed=1, attention_window=6) if kind == "rolling" \
        else both()
    out = []
    for mod, f in ((jserving, jf), (pserving, pf)):
        extra = dict(kw)
        if kind == "speculative":
            extra["spec_draft"] = f
        eng = _mk(mod, f, **extra)
        h = eng.submit(P6, 6, tenant="bulk")
        eng.step()
        out.append((eng._can_preempt, eng.preempt(h)))
        eng.run_until_idle()
        assert eng.stats["preemptions"] == 0 and not eng._suspended
    assert out[0] == out[1] == (False, False)


def test_warmup_leaves_no_trace(fitted):
    """With tenants registered ``warmup`` also runs one swap-out and one
    ingest, through the null block and a free slot's row left inactive:
    the tokens after it equal an engine's that never warmed up."""
    rows, stats = [], []
    for warm in (True, False):
        eng = _mk(pserving, fitted)
        if warm:
            eng.warmup()
            assert not eng._dev_act.any()
            assert (eng._dev_bt == eng.kv_blocks).all()
        hs = [eng.submit(tenant="bulk", **REQS[k])
              for k in ("bulk_sampled", "bulk_greedy")]
        _step_until(eng, lambda: len(hs[0].tokens) >= 4)
        assert eng.preempt(hs[0])
        eng.run_until_idle()
        rows.append([h.result() for h in hs])
        stats.append({k: v for k, v in _qos(eng).items()})
        _assert_idle(eng)
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)
    assert stats[0] == stats[1]


def test_swap_keeps_the_graph_and_its_storage(fitted, graphed, port_ref):
    """The decode step's graph is captured once and replays over resumed
    rows: no capture after the first, a replay a decode step, and every
    static tensor it reads keeps its storage across swap-out and
    resume."""
    eng = _mk(pserving, fitted)
    eng.warmup()
    static = {name: getattr(eng, name).data_ptr() for name in (
        "_dev_tok", "_dev_pos", "_dev_act", "_dev_temp", "_dev_topk",
        "_dev_topp", "_dev_keys", "_dev_bt")}
    arena = [t.data_ptr() for c in eng.caches if c is not None
             for t in c.values()]
    a = eng.submit(tenant="bulk", **REQS["bulk_sampled"])
    b = eng.submit(tenant="bulk", **REQS["bulk_greedy"])
    _step_until(eng, lambda: len(a.tokens) >= 5)
    assert eng.preempt(a)
    _step_until(eng, lambda: a.id in eng._suspended)
    assert eng.preempt(b)
    eng.run_until_idle()
    assert eng.stats["resumes"] == 2
    assert graphed.captures == eng.stats["graph_captures"] == 1
    assert eng.stats["graph_replays"] == eng.stats["decode_steps"]
    assert static == {name: getattr(eng, name).data_ptr()
                      for name in static}
    assert arena == [t.data_ptr() for c in eng.caches if c is not None
                     for t in c.values()]
    np.testing.assert_array_equal(a.result(), port_ref["bulk_sampled"])
    np.testing.assert_array_equal(b.result(), port_ref["bulk_greedy"])


def test_decode_only_iteration_with_tenants(fitted, monkeypatch):
    """With tenants registered and nothing queued or suspended, a
    decode-only iteration runs no preemption pass, uploads nothing and
    reads back one row."""
    eng = _mk(pserving, fitted)
    calls = []
    orig = eng._balance_qos
    monkeypatch.setattr(eng, "_balance_qos",
                        lambda: calls.append(1) or orig())
    hs = [eng.submit(tenant="bulk", **REQS[k])
          for k in ("bulk_sampled", "bulk_greedy")]
    _step_until(eng, lambda: all(len(h.tokens) >= 2 for h in hs))
    for _ in range(4):
        before = (eng.stats["h2d_transfers"], eng.stats["d2h_transfers"],
                  eng.stats["prefills"], eng.stats["decode_steps"])
        eng.step()
        after = (eng.stats["h2d_transfers"], eng.stats["d2h_transfers"],
                 eng.stats["prefills"], eng.stats["decode_steps"])
        assert [y - x for x, y in zip(before, after)] == [0, 1, 0, 1]
    assert not calls
    eng.run_until_idle()


def test_request_handle_qos_fields():
    h = RequestHandle(1, P6, 4, 0.0, None, None, None, None, (0, 0))
    assert (h.tenant, h.priority) == ("default", 0)
    h = RequestHandle(2, P6, 4, 0.0, None, None, None, None, (0, 0),
                      tenant="gold", priority="3")
    assert (h.tenant, h.priority) == ("gold", 3)


# ---------------------------------------------------------------------------
# seeded interleavings: no leak, the terminal balance, exact rows
# ---------------------------------------------------------------------------

PROMPTS = [np.array(p, np.int32) for p in (
    [3, 4, 5], [1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 4])]
TENANTS = ("live", "bulk", "metered")


def _script(seed: int, n_ops: int = 40):
    """A random script of submits (tenant, priority, sampled or greedy,
    prompt, steps, a short deadline or none), preempts and cancels of an
    earlier submission, and runs of steps, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["submit", "step", "preempt", "cancel"],
                          p=[0.35, 0.35, 0.2, 0.1])
        if kind == "submit":
            ops.append(("submit", str(rng.choice(TENANTS)),
                        int(rng.integers(0, 3)), bool(rng.random() < 0.5),
                        int(rng.integers(0, len(PROMPTS))),
                        int(rng.integers(2, 17)), bool(rng.random() < 0.1)))
        elif kind == "step":
            ops.append(("step", int(rng.integers(1, 5))))
        else:
            ops.append((str(kind), int(rng.integers(0, 16))))
    return ops


@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_seeded_interleavings(fitted, seed):
    """Random scripts of submits (two tiers, priorities, a quota, short
    deadlines), preempts, cancels and steps on a tight arena: afterwards
    no block is held, the terminal balance holds per engine and per
    tenant, and every request that completed equals ``generate``."""
    eng = _mk(pserving, fitted, kv_blocks=12, specs=(
        ("live", {"tier": "interactive", "weight": 2.0}),
        ("bulk", {"tier": "batch"}),
        ("metered", {"rate": 0.001, "burst": 2.0})))
    handles = []
    for op in _script(seed):
        if op[0] == "submit":
            _, tenant, prio, sampled, p, steps, short = op
            kw = dict(temperature=0.7, seed=len(handles)) if sampled else {}
            try:
                handles.append(eng.submit(
                    PROMPTS[p], steps, tenant=tenant, priority=prio,
                    deadline_s=0.02 if short else None, block=False, **kw))
            except QuotaExceeded:
                assert tenant == "metered"
        elif op[0] in ("preempt", "cancel") and handles:
            getattr(eng, op[0])(handles[op[1] % len(handles)])
        elif op[0] == "step":
            for _ in range(op[1]):
                eng.step()
    eng.run_until_idle(max_steps=2000)
    _assert_idle(eng)
    s = eng.stats
    assert (s["requests_submitted"] == s["requests_completed"]
            + s["requests_failed"] + s["requests_rejected"])
    assert s["kv_blocks_resumed"] <= s["kv_blocks_swapped_out"]
    assert s["resumes"] <= s["preemptions"]
    for name, ts in s["tenants"].items():
        assert ts["submitted"] == ts["completed"] + ts["shed"]
    for h in handles:
        assert h.done
        if h.finish in ("eos", "length"):
            np.testing.assert_array_equal(h.result(),
                                          _want(fitted, h, max_len=32))


def test_interleaving_scripts_exercise_every_path(fitted):
    """The scripts the interleaving test draws do preempt, resume, starve,
    refuse quota, cancel and expire: over its first seeds each happens."""
    seen = dict.fromkeys(("preemptions", "resumes", "quota_refused",
                          "requests_cancelled", "requests_expired"), 0)
    for seed in range(6):
        eng = _mk(pserving, fitted, kv_blocks=12, specs=(
            ("live", {"tier": "interactive", "weight": 2.0}),
            ("bulk", {"tier": "batch"}),
            ("metered", {"rate": 0.001, "burst": 2.0})))
        handles = []
        for op in _script(seed):
            if op[0] == "submit":
                _, tenant, prio, sampled, p, steps, short = op
                try:
                    handles.append(eng.submit(
                        PROMPTS[p], steps, tenant=tenant, priority=prio,
                        deadline_s=0.001 if short else None, block=False))
                except QuotaExceeded:
                    pass
            elif op[0] in ("preempt", "cancel") and handles:
                getattr(eng, op[0])(handles[op[1] % len(handles)])
            elif op[0] == "step":
                for _ in range(op[1]):
                    eng.step()
        eng.run_until_idle(max_steps=2000)
        _assert_idle(eng)
        for k in seen:
            seen[k] += eng.stats[k]
    assert all(seen.values()), seen


# ---------------------------------------------------------------------------
# overload: the fast leg of the open-loop QoS run
# ---------------------------------------------------------------------------

def test_overload_fast_leg(fitted):
    """examples/loadgen.py's fast overload leg on the port (the port's
    loadgen trace and policies, chip_smoke.py's run_overload): every tier
    completes, the terminal balance holds and no block leaks."""
    import chip_smoke
    from distkeras_tpu_torch.examples import loadgen as ploadgen
    eng = _mk(pserving, fitted, specs=None, block_size=8, kv_blocks=None,
              num_slots=2, queue_capacity=16)
    for p in ploadgen.qos_policies(3):
        eng.register_tenant(p)
    trace = ploadgen.make_trace(10, seed=3, num_steps=8, tenants=3,
                                tier_mix=0.3)
    assert any(t["tenant"] == "interactive" for t in trace)
    assert any(t["tenant"] != "interactive" for t in trace)
    try:
        point = chip_smoke._run_overload(eng, trace, qps=500.0,
                                         timeout_s=120.0)
    finally:
        eng.stop()
    for k in ("interactive_p99_ms", "batch_completion_rate",
              "preempt_resume_ms_mean_max", "quota_refused", "tenants"):
        assert k in point
    assert 0.0 <= point["batch_completion_rate"] <= 1.0
    assert point["interactive_completion_rate"] > 0.0
    assert point["interactive_p99_ms"] is not None
    assert point["resumes"] == point["preemptions"]
    _assert_idle(eng)
    s = eng.stats
    assert (s["requests_submitted"] == s["requests_completed"]
            + s["requests_failed"] + s["requests_rejected"])
    assert not threading.active_count() > 50


def test_qos_trace_matches_loadgen():
    """The port's loadgen make_trace(tenants=3, tier_mix=0.3) draws the
    JAX example's trace, and its qos_policies(3) are the JAX example's."""
    from distkeras_tpu_torch.examples import loadgen as ploadgen
    from examples import loadgen
    for kw in (dict(num_requests=12, seed=3, num_steps=8),
               dict(num_requests=16, seed=0, vocab=512, num_steps=128,
                    temperature=0.7, prompt_lengths=(16, 64, 256, 1024))):
        want = loadgen.make_trace(tenants=3, tier_mix=0.3, **kw)
        got = ploadgen.make_trace(tenants=3, tier_mix=0.3, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            np.testing.assert_array_equal(g.pop("prompt"), w.pop("prompt"))
            assert g == w
    pols = ploadgen.qos_policies(3)
    jpols = loadgen.qos_policies(3)
    assert [(p.name, p.tier, p.weight, p.rate) for p in pols] == \
        [(p.name, p.tier, p.weight, p.rate) for p in jpols]
