"""The port's ``ServingRouter`` against the JAX package's router:
dispatch, counters and rows.

The contract pinned here, on the JAX router tests' tiny LM (vocab 17, seq
32, d_model 16, 2 heads, 2 layers, f32; 2 replicas of 2 slots, max_len
24, hashed in blocks of 4), one numpy weight set in both packages:

 - one scripted trace (shared-prefix groups, prompts too short to hash,
   a tenant backlog, a saturated replica) through a JAX fleet and a port
   fleet of engines stepped by the same script, so that every load
   snapshot is the same in both, under ``"prefix"``, ``"least-loaded"``
   and ``"random"``: each request lands on the same replica uid,
   ``counters`` and ``fleet_snapshot()``'s ``routed`` equal, and once the
   fleets run, every greedy row equals the JAX row (sampled rows equal
   the port's ``generate``: the packages draw other bits).

The two routers across the packages' wire are in
``tests/test_torch_router_interop.py``.
"""

import numpy as np
import pytest
import torch

import distkeras_tpu.router as jrouter
import distkeras_tpu.serving as jserving
import distkeras_tpu_torch.router as prouter
import distkeras_tpu_torch.serving as pserving
from test_torch_serving_wire import PROMPT, _want, models  # noqa: F401

pytestmark = pytest.mark.router

torch.set_num_threads(1)

TENANTS = (("live", "interactive"), ("bulk", "batch"))
GROUP = [np.array([g + 2] * 8 + [10 + i], np.int32)
         for g in range(3) for i in range(2)]


def _trace():
    """(phase, prompt, steps, submit keywords): phase 0 is submitted
    first, then every engine takes two steps (two prefills: its slots
    full), then phase 1.  Six requests share one 8-token prefix, so prefix
    affinity piles them on one replica whose queue then runs past the
    spill threshold; a tenant's interactive request queues on its group's
    replica and a batch request of that group meets the backlog; short
    prompts hash nothing."""
    hot = np.array([5] * 8 + [1], np.int32)
    out = [(0, hot, 4, {}) for _ in range(6)]
    out += [(0, p, 4, {"seed": i, "temperature": 0.8} if i % 2 else {})
            for i, p in enumerate(GROUP)]
    out += [(0, np.array([3, 4, 1, 6], np.int32), 4, {"tenant": "live"}),
            (1, hot, 4, {"tenant": "live"}),
            (1, hot, 4, {"tenant": "bulk"}),
            (1, hot, 4, {}),
            (1, np.array([9, 1, 2, 2], np.int32), 3, {"seed": 4,
                                                       "temperature": 0.7}),
            (1, GROUP[4], 4, {"tenant": "live"}),
            (1, GROUP[5], 4, {"tenant": "bulk"})]
    return out


AFFINITIES = ("prefix", "least-loaded", "random")


def _engines(mod, f):
    """Two dense replicas (dispatch reads no paged state but the trie's
    block count, 0 here; each JAX engine compiles its programs anew, and
    a dense engine has fewer)."""
    return [mod.ServingEngine(f, num_slots=2, max_len=24, queue_capacity=32)
            for _ in range(2)]


def _drive(mod, rmod, engines, affinity):
    """The scripted trace through one package's fleet (a fresh router over
    ``engines``, which are not running): where each request landed, the
    counters and routed counts, the load snapshots before the fleet runs,
    and every row."""
    tenants = [mod.TenantPolicy(name, tier=tier) for name, tier in TENANTS]
    r = rmod.ServingRouter(engines, affinity=affinity, seed=5,
                           block_size=4, tenants=tenants)
    trace = _trace()
    handles, picks = [], []
    for phase in (0, 1):
        if phase == 1:
            for e in r.engines:
                e.step()
                e.step()
        for ph, prompt, steps, kw in trace:
            if ph == phase:
                h = r.submit(prompt, steps, **kw)
                handles.append(h)
                picks.append(r.generation_of(h))
    out = {"picks": picks, "counters": dict(r.counters),
           "routed": [s["routed"] for s in r.fleet_snapshot()],
           "loads": [s["load"] for s in r.fleet_snapshot()]}
    r.start()
    try:
        out["rows"] = [np.asarray(h.result(timeout=60)) for h in handles]
    finally:
        r.stop()
    out["done"] = dict(r.counters)
    return out


@pytest.fixture(scope="module")
def fleets(models):
    """Each package's fleet of two engines driven under every policy in
    turn (the same engines, stopped between the runs: both packages go
    through the same states, and each JAX engine compiles once)."""
    out = {}
    for name, mod, rmod, f in (("jax", jserving, jrouter, models[0]),
                               ("port", pserving, prouter, models[1])):
        engines = _engines(mod, f)
        for affinity in AFFINITIES:
            out[name, affinity] = _drive(mod, rmod, engines, affinity)
    return out


@pytest.fixture(scope="module")
def ordered():
    """The trace's requests in submission order (phase 0, then 1)."""
    trace = _trace()
    return [t for phase in (0, 1) for t in trace if t[0] == phase]


@pytest.mark.parametrize("affinity", AFFINITIES)
def test_dispatch_counters_and_rows_equal_the_jax_router(models, fleets,
                                                         ordered, affinity):
    pf = models[1]
    want, got = fleets["jax", affinity], fleets["port", affinity]
    assert got["picks"] == want["picks"]
    assert got["counters"] == want["counters"]
    assert got["routed"] == want["routed"]
    assert got["loads"] == want["loads"]
    assert got["done"] == want["done"]
    assert got["done"]["requests_completed"] == len(ordered)
    for (_, prompt, steps, kw), g, w in zip(ordered, got["rows"],
                                            want["rows"]):
        if kw.get("temperature"):
            np.testing.assert_array_equal(
                g, _want(pf, prompt, steps, seed=kw["seed"],
                         temperature=kw["temperature"]))
        else:
            np.testing.assert_array_equal(g, w)
    if affinity == "prefix":  # the script reaches every dispatch branch
        c = got["counters"]
        assert c["affinity_routed"] and c["affinity_spills"]
        assert c["tenant_spills"]
    if affinity == "random":
        assert len(set(u for u, _ in got["picks"])) == 2
