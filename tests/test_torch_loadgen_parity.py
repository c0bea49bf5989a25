"""The port's load generator against the JAX example, token for token.

The JAX ``examples/loadgen.py :: build_engine(seed=SEED)`` draws the
weights; the port's ``build_engine(weights=...)`` loads the same weights
(the JAX package's flat order) on the CPU.  The same trace (greedy and
sampled requests, a shared prefix) runs through both packages'
``run_closed_loop`` at concurrency 1, so the order of admissions is
fixed, on the dense, the paged and the disaggregated engine (f32).  Each
request's row is read from the handle its ``submit`` returned:

 - greedy rows equal the JAX engine's, token for token;
 - sampled rows equal the port's own ``generate`` with the request's
   seed (the two packages draw other bits: the port's counter-based rule
   against JAX's ``PRNGKey``);
 - the closed loop's counts (completed, tokens, shed) and the pool's
   counters (prefix hits, blocks, shipped blocks) equal the JAX run's.

``sequential_baseline`` of both packages runs the trace through each
one's ``generate``: its greedy rows are the JAX rows, its sampled rows
the port engine's.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from distkeras_tpu_torch.examples import loadgen
from examples import loadgen as jloadgen

torch.set_num_threads(1)

SEED = 5
ENGINE = dict(num_slots=2, queue_capacity=16, seed=SEED)
FORMS = {"dense": {},
         "paged": dict(paged=True, block_size=4),
         "disagg": dict(disaggregate=True, block_size=4)}
TRACE = dict(num_steps=6, temperature=0.5, prefix_groups=1, prefix_len=8,
             seed=2)
REQUESTS = 6
#: the metrics both packages must count alike on this trace
COUNTS = ("completed", "shed", "killed", "tokens", "prefix_hits",
          "prefix_hit_tokens", "blocks_allocated", "blocks_reused",
          "cow_copies")
#: the pair's hand-off counters
TRANSFER = ("kv_blocks_shipped", "kv_block_bytes_shipped",
            "kv_blocks_ingested", "kv_block_bytes_ingested")


def _trace():
    return loadgen.make_trace(REQUESTS, **TRACE)


def _closed_loop(mod, engine, trace):
    """``mod.run_closed_loop`` over ``engine`` at concurrency 1, with every
    handle that ``submit`` returned, in submission order."""
    handles = chip_smoke._recording(engine)
    try:
        metrics = mod.run_closed_loop(engine, trace, concurrency=1,
                                      timeout_s=120.0)
        stats = dict(engine.stats)
    finally:
        engine.stop()
    return metrics, stats, [np.asarray(h.result()) for h in handles]


@pytest.fixture(scope="module")
def runs():
    """Each form through both packages: (metrics, stats, rows) by
    package, and the port's fitted model."""
    trace = _trace()
    out = {}
    for form, kw in FORMS.items():
        jfitted, jeng = jloadgen.build_engine(**ENGINE, **kw)
        fitted, eng = loadgen.build_engine(
            **ENGINE, **kw, device="cpu", weights=jfitted.get_weights())
        out[form] = {"jax": _closed_loop(jloadgen, jeng, trace),
                     "port": _closed_loop(loadgen, eng, trace),
                     "fitted": fitted, "jfitted": jfitted}
    return out


def _greedy(trace):
    return [i for i, r in enumerate(trace) if not r.get("temperature")]


def _sampled(trace):
    return [i for i, r in enumerate(trace) if r.get("temperature")]


def test_the_trace_mixes_greedy_sampled_and_a_shared_prefix():
    trace = _trace()
    assert _greedy(trace) and _sampled(trace)
    head = trace[0]["prompt"][:TRACE["prefix_len"]]
    for r in trace[1:]:
        np.testing.assert_array_equal(r["prompt"][:len(head)], head)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_greedy_rows_equal_the_jax_engines(runs, form):
    trace = _trace()
    jrows, rows = runs[form]["jax"][2], runs[form]["port"][2]
    assert len(rows) == len(jrows) == len(trace)
    for i in _greedy(trace):
        np.testing.assert_array_equal(rows[i], jrows[i])


@pytest.mark.parametrize("form", sorted(FORMS))
def test_sampled_rows_equal_the_ports_generate(runs, form):
    trace = _trace()
    fitted, rows = runs[form]["fitted"], runs[form]["port"][2]
    for i in _sampled(trace):
        r = trace[i]
        want = fitted.generate(r["prompt"][None], r["num_steps"],
                               temperature=r["temperature"], rng=r["seed"],
                               max_len=32).numpy()[0]
        np.testing.assert_array_equal(rows[i], want)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_counts_equal_the_jax_runs(runs, form):
    jm, js, _ = runs[form]["jax"]
    m, s, _ = runs[form]["port"]
    assert {k: m[k] for k in COUNTS} == {k: jm[k] for k in COUNTS}
    assert m["completed"] == REQUESTS and m["shed"] == 0
    assert sorted(m) == sorted(jm)
    if form == "disagg":
        assert {k: s[k] for k in TRANSFER} == {k: js[k] for k in TRANSFER}
        assert s["kv_blocks_shipped"] > 0
    if form == "paged":
        assert m["prefix_hits"] >= 1 and m["blocks_reused"] >= 1


def _recorded_baseline(mod, fitted, trace):
    """``mod.sequential_baseline`` with each ``generate`` row kept."""
    rows = []
    generate = fitted.generate

    def recording_generate(*args, **kw):
        out = generate(*args, **kw)
        rows.append(np.asarray(out)[0] if not torch.is_tensor(out)
                    else out.numpy()[0])
        return out

    fitted.generate = recording_generate
    try:
        metrics = mod.sequential_baseline(fitted, trace, max_len=32)
    finally:
        del fitted.generate
    return metrics, rows


def test_sequential_baseline_rows_equal_jax_generate_and_the_engine(runs):
    """One prompt length, so the JAX ``generate`` compiles twice (greedy
    and sampled)."""
    trace = loadgen.make_trace(4, prompt_lengths=(6,), **TRACE)
    assert _greedy(trace) and _sampled(trace)
    dense = runs["dense"]
    m, rows = _recorded_baseline(loadgen, dense["fitted"], trace)
    jm, jrows = _recorded_baseline(jloadgen, dense["jfitted"], trace)
    assert sorted(m) == sorted(jm)
    assert m["completed"] == jm["completed"] == len(trace)
    assert m["tokens"] == jm["tokens"] == len(trace) * TRACE["num_steps"]
    for i in _greedy(trace):
        np.testing.assert_array_equal(rows[i], jrows[i])
    _, eng = loadgen.build_engine(**ENGINE, device="cpu",
                                  weights=dense["jfitted"].get_weights())
    handles = [eng.submit(**r) for r in trace]
    eng.run_until_idle()
    for i in _sampled(trace):
        np.testing.assert_array_equal(rows[i], handles[i].result())
