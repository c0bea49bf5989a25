"""The port's ``ServingRouter`` and the JAX package's router across the
two packages' serving wire (one frame format, byte for byte).

The contract pinned here, on the JAX router tests' tiny LM (vocab 17, seq
32, d_model 16, 2 heads, 2 layers, f32; 2 slots, max_len 24), one numpy
weight set in both packages:

 - a port router over a JAX ``ServingServer`` and a JAX router over a
   port ``ServingServer`` stream the JAX engine's greedy rows;
 - a port router over one server of each package fails over from the
   killed JAX replica onto the port one with the same rows;
 - ``stats`` over a fleet whose first replica has not prefilled yet: the
   port merges it, the JAX router raises (a red mark on the reference
   side).
"""

import numpy as np
import pytest
import torch

import distkeras_tpu.router as jrouter
import distkeras_tpu.serving as jserving
import distkeras_tpu_torch.router as prouter
import distkeras_tpu_torch.serving as pserving
from test_torch_serving_wire import PROMPT, models  # noqa: F401

pytestmark = pytest.mark.router

torch.set_num_threads(1)

SECOND = np.array([7, 8, 9, 10], np.int32)


def _jax_rows(eng, prompts, steps):
    """The JAX engine's own greedy rows (driven inline)."""
    hs = [eng.submit(p, steps) for p in prompts]
    eng.run_until_idle()
    return [np.asarray(h.result()) for h in hs]


@pytest.mark.parametrize("direction", ["port_router_jax_server",
                                       "jax_router_port_server"])
def test_router_streams_across_the_packages(models, direction):
    jf, pf = models
    jeng = jserving.ServingEngine(jf, num_slots=2, max_len=24)
    prompts = (PROMPT, SECOND, PROMPT)
    want = _jax_rows(jeng, prompts, 6)
    if direction == "port_router_jax_server":
        router_mod, server = prouter, jserving.ServingServer(jeng,
                                                             poll_s=0.01)
    else:
        router_mod = jrouter
        server = pserving.ServingServer(
            pserving.ServingEngine(pf, num_slots=2, max_len=24), poll_s=0.01)
    with server as srv:
        with router_mod.ServingRouter(addrs=[srv.addr]) as r:
            hs = [r.submit(p, 6) for p in prompts]
            rows = [h.result(timeout=60) for h in hs]
            counters = dict(r.counters)
    for row, w in zip(rows, want):
        np.testing.assert_array_equal(row, w)
    assert counters["requests_completed"] == 3
    assert counters["requests_failed"] == 0


def test_port_router_fails_over_from_a_jax_replica_to_a_port_one(models):
    """One server of each package behind a port router: the JAX engine
    dies with requests queued on it (its loop stopped), and they resubmit
    onto the port server with the JAX engine's rows."""
    jf, pf = models
    jeng = jserving.ServingEngine(jf, num_slots=2, max_len=24)
    want = _jax_rows(jeng, [PROMPT], 6)[0]
    with jserving.ServingServer(jeng, poll_s=0.01) as js, \
            pserving.ServingServer(pserving.ServingEngine(
                pf, num_slots=2, max_len=24), poll_s=0.01) as ps:
        jeng.stop()  # the JAX replica queues but never schedules
        with prouter.ServingRouter(addrs=[js.addr, ps.addr],
                                   affinity="least-loaded",
                                   load_ttl=0.0) as r:
            hs = [r.submit(PROMPT, 6) for _ in range(4)]
            parked = [h for h in hs if r.generation_of(h)[0] == 0]
            assert parked
            jeng.declare_dead("chaos: the JAX replica is killed")
            rows = [h.result(timeout=60) for h in hs]
            assert all(r.generation_of(h)[0] == 1 for h in hs)
            assert r.counters["resubmissions"] >= len(parked)
            assert r.counters["requests_failed"] == 0
    for row in rows:
        np.testing.assert_array_equal(row, want)


def test_stats_merge_a_replica_that_has_not_prefilled(models):
    """``stats`` over a fleet whose first replica has not prefilled yet
    (its ``prefill_batch_size_mean`` is None) and whose second has: the
    port counts the None as absent, where the JAX router's sum raises
    ``TypeError`` (a red mark on the reference side).  The JAX engine
    that has prefilled is faked by its stats alone (no compile)."""
    pf = models[1]
    busy = pserving.ServingEngine(pf, num_slots=2, max_len=24)
    busy.submit(PROMPT, 2)
    busy.run_until_idle()
    fresh = {"jax": jserving.ServingEngine(models[0], num_slots=2,
                                           max_len=24),
             "port": pserving.ServingEngine(pf, num_slots=2, max_len=24)}
    ran = jserving.ServingEngine(models[0], num_slots=2, max_len=24)
    ran.stats["prefill_batch_size_mean"] = 1.0
    jr = jrouter.ServingRouter([fresh["jax"], ran])
    with pytest.raises(TypeError):
        jr.stats
    pr = prouter.ServingRouter([fresh["port"], busy])
    st = pr.stats
    assert fresh["port"].stats["prefill_batch_size_mean"] is None
    assert (st["prefill_batch_size_mean"]
            == busy.stats["prefill_batch_size_mean"] is not None)
    assert st["tokens_generated"] == 2
