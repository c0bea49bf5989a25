"""The port's load generator (``distkeras_tpu_torch.examples.loadgen``) on
the CPU: its trace and policies against the JAX example's, and its
load loops over the port's engines (the loadgen cases of
``tests/test_serving_bench.py`` on the port).

 - ``make_trace`` draws the JAX example's trace, element for element,
   over every pattern, shared prefixes, tenants and seeds; its refusals
   are the JAX example's; ``qos_policies``, ``_percentile_ms`` and the
   key sets of ``_metrics`` and ``fleet_report`` are the JAX example's;
   chip_smoke.py's traces are the JAX ``make_trace`` of their arguments;
 - the closed loop is lossless and changes scheduling only (its rows are
   offline ``generate``'s); the seeded chaos-kill schedule leaves no
   leaks and kills the same requests twice; an open-loop flood against a
   held engine sheds all but the queue's capacity, with typed
   rejections; the paged shared-prefix leg hits its prefix; the wire
   closed loop is lossless on both server cores; the router fleet is
   lossless; ``run_overload`` serves three tenants; each engine form
   (speculative, quantized, int8 KV) serves a trace; ``build_spec_engine``
   trains its pair and serves through it.

The tests wait for states, never for times."""


import numpy as np
import pytest
import torch

import chip_smoke
from distkeras_tpu_torch.examples import loadgen
from distkeras_tpu_torch.serving import QueueFull
from examples import loadgen as jloadgen

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _assert_same_trace(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["prompt"].dtype == w["prompt"].dtype == np.int32
        np.testing.assert_array_equal(g["prompt"], w["prompt"])
        assert ({k: v for k, v in g.items() if k != "prompt"}
                == {k: v for k, v in w.items() if k != "prompt"})


# ---------------------------------------------------------------------------
# the trace and the policies against the JAX example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("tenants", [0, 3])
@pytest.mark.parametrize("prefix", [None, (2, 8)], ids=["no-prefix",
                                                         "prefix"])
@pytest.mark.parametrize("pattern", ["random", "arith", "bimodal"])
def test_make_trace_equals_the_jax_example(pattern, prefix, tenants, seed):
    kw = dict(seed=seed, vocab=32, num_steps=12, temperature=0.7,
              pattern=pattern, tenants=tenants, tier_mix=0.4,
              prompt_lengths=(4, 9, 17), long_fraction=0.3)
    if prefix is not None:
        kw.update(prefix_groups=prefix[0], prefix_len=prefix[1])
    _assert_same_trace(loadgen.make_trace(20, **kw),
                       jloadgen.make_trace(20, **kw))


@pytest.mark.parametrize("kw", [dict(prefix_groups=0, prefix_len=8),
                                dict(prefix_groups=2, prefix_len=0)],
                         ids=["no-groups", "no-length"])
def test_make_trace_refuses_as_the_jax_example(kw):
    with pytest.raises(ValueError) as want:
        jloadgen.make_trace(4, **kw)
    with pytest.raises(ValueError) as got:
        loadgen.make_trace(4, **kw)
    assert str(got.value) == str(want.value)


def test_trace_is_deterministic():
    a = loadgen.make_trace(12, seed=3, temperature=0.7)
    _assert_same_trace(a, loadgen.make_trace(12, seed=3, temperature=0.7))
    c = loadgen.make_trace(12, seed=4, temperature=0.7)
    assert any((len(ra["prompt"]) != len(rc["prompt"]))
               or (ra["prompt"] != rc["prompt"][:len(ra["prompt"])]).any()
               for ra, rc in zip(a, c))
    assert loadgen.PROMPT_LENGTHS == jloadgen.PROMPT_LENGTHS


@pytest.mark.parametrize("rate,deadline", [(None, None), (5.0, 0.5)],
                         ids=["unlimited", "rate-deadline"])
@pytest.mark.parametrize("tenants", [1, 2, 3, 5])
def test_qos_policies_equal_the_jax_example(tenants, rate, deadline):
    def fields(pols):
        return [(p.name, p.tier, p.weight, p.rate, p.burst, p.deadline_s)
                for p in pols]
    kw = dict(interactive_weight=3.0, interactive_rate=rate,
              interactive_deadline_s=deadline)
    assert fields(loadgen.qos_policies(tenants, **kw)) == fields(
        jloadgen.qos_policies(tenants, **kw))


@pytest.mark.parametrize("lat", [[], [0.25], [0.01, 0.3, 0.02, 1.5, 0.7]],
                         ids=["empty", "one", "five"])
def test_percentile_ms_equals_the_jax_example(lat):
    for q in (50, 99):
        assert loadgen._percentile_ms(lat, q) == jloadgen._percentile_ms(
            lat, q)


@pytest.mark.parametrize("name", ["qos_overload", "disagg_bimodal",
                                  "paged_prefix"])
def test_chip_smoke_traces_are_the_jax_make_trace(name):
    """chip_smoke.py's phases draw the JAX example's traces."""
    c = chip_smoke
    if name == "qos_overload":
        got = c._qos_overload_trace()
        want = jloadgen.make_trace(
            c.QOS_REQUESTS, seed=c.SEED, vocab=c.LM["vocab_size"],
            num_steps=c.SERVE_STEPS, temperature=c.SERVE_TEMP,
            prompt_lengths=c.SERVE_PROMPT_LENS, tenants=3, tier_mix=0.3)
        _assert_same_trace(got, want)
        assert [p.weight for p in c._qos_policies()] == [4.0, 1.0, 1.0]
    elif name == "disagg_bimodal":
        got = c._disagg_bimodal_trace()
        want = jloadgen.make_trace(
            c.DISAGG_REQUESTS, seed=c.SEED, vocab=c.LM["vocab_size"],
            num_steps=c.SERVE_STEPS, prompt_lengths=c.DISAGG_PROMPT_LENS,
            pattern="bimodal", long_fraction=c.DISAGG_LONG_FRACTION)
        _assert_same_trace(got, want)
    else:
        got = c._prefix_trace(c.LM["vocab_size"])
        want = jloadgen.make_trace(
            c.PREFIX_REQUESTS, vocab=c.LM["vocab_size"],
            num_steps=c.PREFIX_STEPS, prompt_lengths=c.PREFIX_SUFFIXES,
            prefix_groups=1, prefix_len=c.PREFIX_LEN)
        assert len(got) == len(want)
        for (prompt, steps, kw), w in zip(got, want):
            np.testing.assert_array_equal(prompt, w["prompt"])
            assert steps == w["num_steps"] and kw == {}


# ---------------------------------------------------------------------------
# the key sets of the reports against the JAX example
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engines():
    """A paged JAX engine and a 2-replica JAX fleet, never run."""
    _, paged = jloadgen.build_engine(num_slots=2, paged=True, block_size=4)
    _, fleet = jloadgen.build_fleet(replicas=2, num_slots=2)
    yield {"paged": paged, "dense": fleet.engines[0], "fleet": fleet}
    fleet.stop()
    paged.stop()


@pytest.mark.parametrize("form", ["dense", "paged"])
def test_metrics_keys_equal_the_jax_example(jax_engines, form):
    _, eng = loadgen.build_engine(num_slots=2, paged=form == "paged",
                                  block_size=4, **CPU)
    args = ([0.1, 0.2], 1.0, 12, 2)
    want = jloadgen._metrics(jax_engines[form], *args, shed=1,
                             ttfts=[0.05], prefill_tokens=8)
    got = loadgen._metrics(eng, *args, shed=1, ttfts=[0.05],
                           prefill_tokens=8)
    assert list(got) == list(want)
    for k in ("completed", "shed", "tokens", "wall_s", "tokens_per_sec",
              "p50_ms", "p99_ms", "ttft_p50_ms", "prefill_tokens_per_sec"):
        assert got[k] == want[k]


def test_fleet_report_keys_equal_the_jax_example(jax_engines):
    _, router = loadgen.build_fleet(replicas=2, num_slots=2, **CPU)
    try:
        got = loadgen.fleet_report(router, {})
    finally:
        router.stop()
    want = jloadgen.fleet_report(jax_engines["fleet"], {})
    assert list(got) == list(want)
    assert [list(p) for p in got["per_replica"]] == [
        list(p) for p in want["per_replica"]]
    assert got["replicas"] == want["replicas"] == 2


# ---------------------------------------------------------------------------
# the load loops over the port's engines
# ---------------------------------------------------------------------------

def test_closed_loop_fast_trace_lossless():
    """Every traced request completes, zero shed, tokens accounted
    exactly, occupancy and TTFT recorded."""
    _, engine = loadgen.build_engine(num_slots=2, queue_capacity=16, **CPU)
    trace = loadgen.make_trace(6, num_steps=6, temperature=0.5)
    try:
        m = loadgen.run_closed_loop(engine, trace, concurrency=4,
                                    timeout_s=120.0)
    finally:
        engine.stop()
    assert m["completed"] == 6 and m["shed"] == 0
    assert m["tokens"] == 6 * 6
    assert m["tokens_per_sec"] > 0
    assert m["p50_ms"] is not None and m["p99_ms"] >= m["p50_ms"]
    assert 0.0 < m["slot_occupancy"] <= 1.0
    assert all(n >= 1 for n in engine.stats["slot_requests"])
    assert m["ttft_p50_ms"] is not None
    assert m["ttft_p50_ms"] <= m["p50_ms"]
    assert m["prefill_tokens_per_sec"] > 0
    assert engine.stats["prefill_batches"] >= 1
    assert engine.stats["prefill_batch_size_mean"] >= 1.0


def test_closed_loop_outputs_match_offline_generate():
    """The loadgen path changes scheduling only: each traced request's
    tokens equal offline generate's for the same seed."""
    fitted, engine = loadgen.build_engine(num_slots=2, queue_capacity=16,
                                          **CPU)
    trace = loadgen.make_trace(5, num_steps=5, temperature=0.6)
    handles = [engine.submit(**req) for req in trace]
    try:
        engine.start()
        for h in handles:
            assert h.wait(timeout=120.0)
    finally:
        engine.stop()
    for h, req in zip(handles, trace):
        temp = req.get("temperature", 0.0)
        want = fitted.generate(
            req["prompt"][None], req["num_steps"], temperature=temp,
            rng=req["seed"] if temp else None,
            max_len=engine.max_len).numpy()[0]
        np.testing.assert_array_equal(h.result(), want)


def test_closed_loop_chaos_kill_schedule_no_leaks():
    """Seeded kills cancel mid-run, the engine reclaims every slot, the
    survivors complete, and the schedule is a pure function of the
    seed."""
    def run():
        _, engine = loadgen.build_engine(num_slots=2, queue_capacity=16,
                                         **CPU)
        trace = loadgen.make_trace(8, num_steps=24, temperature=0.5)
        try:
            m = loadgen.run_closed_loop(engine, trace, concurrency=4,
                                        timeout_s=120.0, chaos_kill=0.4,
                                        chaos_seed=3)
        finally:
            engine.stop()
        return m, engine
    m, engine = run()
    assert m["killed"] > 0
    s = engine.stats
    assert s["requests_submitted"] == 8
    assert m["completed"] == 8
    assert s["requests_cancelled"] + s["requests_expired"] >= 1
    assert not engine._active.any()
    assert sorted(engine._free) == list(range(engine.num_slots))
    assert m["slot_reclaim_ms"] is None or m["slot_reclaim_ms"] >= 0
    assert 0.0 <= m["deadline_miss_rate"] <= 1.0
    assert 0.0 <= m["shed_rate"] <= 1.0
    assert run()[0]["killed"] == m["killed"]


def test_open_loop_flood_sheds_typed_and_loses_nothing():
    """An offered rate no engine keeps up with, against a queue of 4: the
    engine's scheduler is held until every submission was tried, so all
    but the queue's 4 are refused with QueueFull (shed), the 4 complete,
    and the engine's counters add up."""
    _, engine = loadgen.build_engine(num_slots=2, queue_capacity=4, **CPU)
    trace = loadgen.make_trace(32, num_steps=8)
    refused = chip_smoke._held_flood(engine, len(trace), 120.0)
    try:
        flood = loadgen.run_open_loop(engine, trace, qps=1e6,
                                      timeout_s=120.0)
    finally:
        engine.stop()
    assert flood["shed"] == len(refused) == len(trace) - 4
    assert all(type(e) is QueueFull for e in refused)
    assert flood["completed"] == 4 and flood["tokens"] == 4 * 8
    assert flood["offered_qps"] == 1e6
    s = engine.stats
    assert s["requests_rejected"] == len(refused)
    assert s["requests_submitted"] == (s["requests_completed"]
                                       + s["requests_rejected"])


def test_paged_loadgen_shared_prefix_fast_leg():
    """A shared-prefix trace through a paged engine completes losslessly
    and records prefix hits with byte-accounted block reuse."""
    a = loadgen.make_trace(8, seed=3, prefix_groups=2, prefix_len=8)
    np.testing.assert_array_equal(a[0]["prompt"][:8], a[2]["prompt"][:8])
    assert (a[0]["prompt"][:8] != a[1]["prompt"][:8]).any()
    _, engine = loadgen.build_engine(num_slots=2, max_len=32, paged=True,
                                     block_size=4, queue_capacity=16, **CPU)
    trace = loadgen.make_trace(6, num_steps=6, temperature=0.5,
                               prefix_groups=1, prefix_len=8)
    try:
        m = loadgen.run_closed_loop(engine, trace, concurrency=4,
                                    timeout_s=120.0)
    finally:
        engine.stop()
    assert m["completed"] == 6 and m["shed"] == 0
    assert m["prefix_hits"] >= 1
    assert m["prefix_hit_tokens"] >= 8
    assert m["prefix_hit_rate"] > 0
    assert m["blocks_reused"] >= 1
    assert m["kv_pool_bytes"] == engine.kv_pool_bytes
    assert engine.kv_blocks_in_use == 0


@pytest.mark.parametrize("core", ["threaded", "event"])
def test_wire_closed_loop_lossless_on_each_core(core):
    """The trace through a ServingServer over loopback completes
    losslessly; the event core holds no per-connection server thread,
    the threaded core one a live connection."""
    from distkeras_tpu_torch.serving import ServingServer
    trace = loadgen.make_trace(6, num_steps=6, temperature=0.5)
    _, engine = loadgen.build_engine(num_slots=2, queue_capacity=16, **CPU)
    srv = ServingServer(engine, server_core=core, poll_s=0.01).start()
    try:
        m = loadgen.run_wire_closed_loop(srv.addr, trace, concurrency=4,
                                         timeout_s=120.0)
    finally:
        srv.stop()
        engine.stop()
    assert m["completed"] == 6 and m["tokens"] == 6 * 6
    assert m["tokens_per_sec"] > 0
    assert m["p50_ms"] is not None and m["p99_ms"] >= m["p50_ms"]
    if core == "event":
        assert m["server_conn_threads_peak"] == 0
    else:
        assert m["server_conn_threads_peak"] >= 1
    assert engine.stats["requests_completed"] == 6


def test_closed_loop_router_fleet_lossless():
    """The closed loop drives a 2-replica router like a bare engine, and
    the skew report accounts for the whole trace."""
    _, router = loadgen.build_fleet(replicas=2, affinity="least-loaded",
                                    num_slots=2, **CPU)
    trace = loadgen.make_trace(6, num_steps=6, temperature=0.5)
    try:
        m = loadgen.run_closed_loop(router, trace, concurrency=4,
                                    timeout_s=120.0)
        report = loadgen.fleet_report(router, m)
    finally:
        router.stop()
    assert m["completed"] == 6 and m["shed"] == 0
    assert m["tokens"] == 6 * 6
    assert report["replicas"] == 2
    assert sum(p["routed"] for p in report["per_replica"]) == 6
    assert report["requests_failed"] == 0
    assert report["routed_skew"] is not None and report["routed_skew"] >= 1


def test_run_overload_serves_three_tenants():
    """The QoS overload leg over a paged engine with qos_policies(3):
    every admitted request retires, the tiers' completion rates and the
    engine's terminal balance hold, and no block leaks."""
    _, engine = loadgen.build_engine(num_slots=2, paged=True, block_size=8,
                                     queue_capacity=16, **CPU)
    for p in loadgen.qos_policies(3):
        engine.register_tenant(p)
    trace = loadgen.make_trace(10, seed=3, num_steps=8, tenants=3,
                               tier_mix=0.3)
    assert {r["tenant"] for r in trace} >= {"interactive", "batch0"}
    try:
        point = loadgen.run_overload(engine, trace, qps=500.0,
                                     timeout_s=120.0)
    finally:
        engine.stop()
    assert point["offered_qps"] == 500.0
    assert point["interactive_completion_rate"] > 0.0
    assert 0.0 <= point["batch_completion_rate"] <= 1.0
    assert point["resumes"] == point["preemptions"]
    assert set(point["tenants"]) == {"interactive", "batch0", "batch1"}
    s = engine.stats
    assert (s["requests_submitted"] == s["requests_completed"]
            + s["requests_failed"] + s["requests_rejected"])
    assert engine.kv_blocks_in_use == 0


@pytest.mark.parametrize("kw", [
    dict(spec_draft="self"), dict(spec_draft="1", spec_len=2),
    dict(quantize="int8"), dict(quantize="bf16"),
    dict(kv_dtype="int8"), dict(prefill_mode="eager"),
    dict(paged=True, block_size=4, prefill_chunk=4),
    dict(disaggregate=True, prefill_engines=2, block_size=4)],
    ids=["spec-self", "spec-1", "int8", "bf16", "kv-int8", "eager",
         "paged-chunked", "disagg-2"])
def test_each_engine_form_serves_the_trace(kw):
    _, engine = loadgen.build_engine(num_slots=2, **kw, **CPU)
    trace = loadgen.make_trace(4, num_steps=5, temperature=0.5)
    try:
        m = loadgen.run_closed_loop(engine, trace, concurrency=2,
                                    timeout_s=120.0)
    finally:
        engine.stop()
    assert m["completed"] == 4 and m["shed"] == 0
    if "spec_draft" in kw:
        assert engine.stats["drafted"] > 0 and m["spec_verify_calls"]


def test_build_engine_seeds_and_weights():
    """The same seed gives the same weights, another seed others, and
    ``weights`` loads a flat list in the JAX package's order."""
    a, _ = loadgen.build_engine(seed=3, **CPU)
    b, _ = loadgen.build_engine(seed=3, **CPU)
    c, _ = loadgen.build_engine(seed=4, **CPU)
    wa, wb, wc = a.get_weights(), b.get_weights(), c.get_weights()
    assert all(np.array_equal(x, y) for x, y in zip(wa, wb))
    assert not all(np.array_equal(x, y) for x, y in zip(wa, wc))
    d, _ = loadgen.build_engine(seed=9, weights=wc, **CPU)
    assert all(np.array_equal(x, y) for x, y in zip(d.get_weights(), wc))
    with pytest.raises(ValueError, match="weight count"):
        loadgen.build_engine(weights=wc[:-1], **CPU)


def test_build_spec_engine_trains_and_serves():
    """The trained pair at num_epoch=2 (target 2 layers, draft 1) behind a
    speculative engine: an x+1 trace completes and the draft proposes."""
    target, draft, engine = loadgen.build_spec_engine(num_epoch=2, **CPU)
    assert len(target.model.layers) - len(draft.model.layers) == 1
    trace = loadgen.make_trace(4, num_steps=6, pattern="arith")
    try:
        m = loadgen.run_closed_loop(engine, trace, concurrency=2,
                                    timeout_s=120.0)
    finally:
        engine.stop()
    assert m["completed"] == 4 and m["tokens"] == 4 * 6
    assert engine.stats["drafted"] > 0
    assert m["spec_accept_rate"] is not None


def test_sequential_baseline_counts_the_trace():
    fitted, engine = loadgen.build_engine(**CPU)
    trace = loadgen.make_trace(3, num_steps=4, temperature=0.5)
    seq = loadgen.sequential_baseline(fitted, trace, max_len=engine.max_len)
    assert seq["completed"] == 3 and seq["tokens"] == 12
    assert seq["tokens_per_sec"] > 0 and seq["p99_ms"] >= seq["p50_ms"]
