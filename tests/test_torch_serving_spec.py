"""Speculative decoding in the port's serving engine
(``ServingEngine(spec_draft=, spec_len=)``), against the JAX package's
speculative engine, the port's plain engines and ``generate``.

The contract pinned here, on the JAX serving tests' tiny LM (vocab 17,
seq 32, d_model 16, 2 heads, 2 layers, f32, one numpy weight set in both
packages; the independent draft another weight set):

 - greedy speculation is token-identical to the JAX speculative engine,
   to the plain engine and to ``generate``, for a self-draft and a random
   draft, ``spec_len`` 1 and 3, mixed prompt lengths in one batch, dense
   and paged pools, full and rolling, bucketed and chunked prefill, eos;
   the stats ``drafted``, ``accepted``, ``verify_calls`` and
   ``target_calls`` equal the JAX engine's;
 - sampled rows repeat exactly under one seed and leave the greedy rows of
   their batch exact; the paged engine draws what the dense one draws;
   the first committed token of a sampled round follows the warped
   target distribution (a distribution test over thousands of keys); the
   round's four draw purposes use disjoint counters;
 - the round is the captured graph (a recording stand-in here): graph =
   uncaptured, one capture, one replay an iteration, a failed capture
   raises, the static storage keeps its addresses; a decode-only
   iteration uploads nothing and reads back one array;
 - every retirement path frees both pools (paged: no block leaked).
"""

import sys
import time

import numpy as np
import pytest
import torch

import distkeras_tpu_torch.serving as serving
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.serving import ServingEngine
from test_torch_serving_fastpath import (PROMPT, TRACE, VOCAB, RecordingGraph,
                                         _want, both)
from test_torch_serving_resilience import (LONG_PROMPT, OTHER,
                                           _assert_slots_reclaimed, _wait_for)

torch.set_num_threads(1)

SPEC_STATS = ("drafted", "accepted", "verify_calls", "target_calls")


@pytest.fixture(scope="module")
def pair():
    return both()


@pytest.fixture(scope="module")
def fitted(pair):
    return pair[1]


@pytest.fixture(scope="module")
def draft_pair():
    return both(seed=99)  # an independent random draft: near-floor accepts


@pytest.fixture(scope="module")
def windowed():
    return both(seed=1, attention_window=6)


@pytest.fixture
def graphed(monkeypatch):
    """Make the engines of one test take the graph route on the CPU."""
    RecordingGraph.captures = 0
    monkeypatch.setattr(serving, "_uses_graph", lambda device: True)
    monkeypatch.setattr(serving, "_capture_graph",
                        lambda step, device: RecordingGraph(step))
    return RecordingGraph


def _assert_no_block_leaks(eng):
    assert eng.kv_blocks_in_use == 0, f"leaked {eng.kv_blocks_in_use}"
    assert eng._pool.check_conservation()
    assert not eng._plans


MIXED = [(np.arange(1, 1 + p, dtype=np.int32) % VOCAB, 5 + p % 3)
         for p in (2, 4, 7)]


# ---------------------------------------------------------------------------
# greedy token identity against the JAX speculative engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft_kind", ["self", "random"])
@pytest.mark.parametrize("spec_len", [1, 3])
def test_spec_greedy_token_identity_vs_jax_engine(pair, draft_pair,
                                                  draft_kind, spec_len):
    """Greedy speculation whatever the draft proposes (a self-draft: high
    accepts; a random one: every round falls back to the correction
    token), mixed prompt lengths in one batch: the rows equal the JAX
    speculative engine's and the port's plain eager engine's, and so do
    the speculation stats."""
    jf, pf = pair
    jd, pd = pair if draft_kind == "self" else draft_pair
    kw = dict(num_slots=3, max_len=24, spec_len=spec_len,
              prefills_per_step=3)
    eng = ServingEngine(pf, spec_draft=pd, **kw)
    jeng = JEngine(jf, spec_draft=jd, **kw)
    eager = ServingEngine(pf, num_slots=3, max_len=24, prefill_mode="eager",
                          prefills_per_step=3)
    runs = [[e.submit(p, n) for p, n in MIXED] for e in (eng, jeng, eager)]
    for e in (eng, jeng, eager):
        e.run_until_idle()
    for h, jh, w in zip(*runs):
        np.testing.assert_array_equal(h.result(), jh.result())
        np.testing.assert_array_equal(h.result(), w.result())
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: jeng.stats[k] for k in SPEC_STATS}
    assert eng.stats["verify_calls"] >= 1
    assert eng.stats["drafted"] >= spec_len
    assert 0 <= eng.stats["accepted"] <= eng.stats["drafted"]
    if draft_kind == "self":
        assert eng.stats["accepted"] > 0


def test_spec_rolling_token_identity(windowed):
    """Rolling dense pools under speculation: the ring carries spec_len
    slack slots, so the L-token verify never overwrites the oldest
    query's window; greedy rows equal the JAX speculative rolling engine's
    and rolling generate's."""
    jw, pw = windowed
    subs = [(np.arange(1, 8, dtype=np.int32) % VOCAB, 10),
            (np.array([1, 2], np.int32), 6)]
    kw = dict(num_slots=2, max_len=24, rolling=True, spec_len=3,
              prefills_per_step=2)
    eng = ServingEngine(pw, spec_draft=pw, **kw)
    jeng = JEngine(jw, spec_draft=jw, **kw)
    assert eng.caches[2]["k"].shape[1] == 6 + 3 == \
        jeng.caches[2]["k"].shape[1]
    assert eng.d_caches[2]["k"].shape[1] == 24     # the draft: full length
    hs = [eng.submit(p, n) for p, n in subs]
    jhs = [jeng.submit(p, n) for p, n in subs]
    eng.run_until_idle()
    jeng.run_until_idle()
    for h, jh in zip(hs, jhs):
        np.testing.assert_array_equal(h.result(), jh.result())
        np.testing.assert_array_equal(
            h.result(), _want(pw, h, max_len=24, rolling=True))


def test_spec_paged_rolling_bucketed_and_chunked(windowed):
    """Rolling paged pools under speculation: the target's ring view is
    window + spec_len, the draft pages max_len positions over the same
    chain (so a slot's allocation covers max_len); bucketed and chunked
    admissions emit rolling generate's tokens and free every block."""
    _, pw = windowed
    eng = ServingEngine(pw, num_slots=2, max_len=24, rolling=True,
                        paged=True, block_size=4, spec_draft=pw,
                        spec_len=3)
    assert eng._t_view == 9 and eng._t_tbl == 4
    assert eng._d_tbl == 7 and eng._blocks_per_slot == 6
    assert eng.kv_blocks == 12 and eng._dev_dbt.shape == (2, 7)
    h = eng.submit(PROMPT, 10)
    eng.run_until_idle()
    np.testing.assert_array_equal(
        h.result(), _want(pw, h, max_len=24, rolling=True))
    _assert_no_block_leaks(eng)
    eng = ServingEngine(pw, num_slots=2, max_len=28, rolling=True,
                        paged=True, block_size=4, prefill_chunk=4,
                        spec_draft=pw, spec_len=2)
    long_p = (np.arange(1, 14, dtype=np.int32) * 5) % VOCAB
    h = eng.submit(long_p, 8)
    g = eng.submit(PROMPT, 6)
    eng.run_until_idle()
    assert eng.stats["prefill_chunks"] >= 4
    for x in (h, g):
        np.testing.assert_array_equal(
            x.result(), _want(pw, x, max_len=28, rolling=True))
    _assert_no_block_leaks(eng)


def test_spec_sampled_deterministic_and_greedy_rows_exact(fitted):
    """A mixed greedy + sampled batch under speculation: sampled rows
    repeat exactly per seed, and the greedy rows of the same batch stay
    equal to the eager reference (per-row independence of the accept and
    commit)."""
    subs = [((PROMPT, 8), {}),
            ((np.array([1, 2], np.int32), 6),
             {"temperature": 0.7, "top_k": 5, "seed": 3}),
            ((np.arange(1, 8, dtype=np.int32), 5), {})]

    def run():
        eng = ServingEngine(fitted, num_slots=3, max_len=24,
                            spec_draft=fitted, spec_len=4,
                            prefills_per_step=3)
        hs = [eng.submit(*a, **k) for a, k in subs]
        eng.run_until_idle()
        return [h.result() for h in hs]

    rows1, rows2 = run(), run()
    for a, b in zip(rows1, rows2):
        np.testing.assert_array_equal(a, b)
    eager = ServingEngine(fitted, num_slots=2, max_len=24,
                          prefill_mode="eager", prefills_per_step=2)
    w0 = eager.submit(*subs[0][0])
    w2 = eager.submit(*subs[2][0])
    eager.run_until_idle()
    np.testing.assert_array_equal(rows1[0], w0.result())
    np.testing.assert_array_equal(rows1[2], w2.result())


@pytest.mark.parametrize("paged", [False, True])
def test_spec_chunked_prefill_and_eos(pair, paged):
    """Long prompts chunk-prefill into both pools (dense: both staging
    caches; paged: both arenas straight), and eos mid-round retires as
    generate stops, token for token (and as the JAX engine does)."""
    jf, pf = pair
    knobs = dict(paged=True, block_size=4) if paged else {}
    lp = (np.arange(1, 14, dtype=np.int32) * 3) % VOCAB
    eng = ServingEngine(pf, num_slots=2, max_len=32, spec_draft=pf,
                        spec_len=3, prefill_chunk=4, **knobs)
    h = eng.submit(lp, 8)
    eng.run_until_idle()
    assert eng.stats["prefill_chunks"] == 4
    np.testing.assert_array_equal(h.result(), _want(pf, h, max_len=32))

    greedy = pf.generate(PROMPT[None], 8, max_len=24).numpy()[0]
    eos = int(greedy[len(PROMPT) + 2])
    eng = ServingEngine(pf, num_slots=2, max_len=24, spec_draft=pf,
                        spec_len=4, **knobs)
    h = eng.submit(PROMPT, 8, eos_id=eos, pad_id=1)
    eng.run_until_idle()
    want = pf.generate(PROMPT[None], 8, eos_id=eos, pad_id=1,
                       max_len=24).numpy()[0]
    np.testing.assert_array_equal(h.result(), want)
    assert h.finish == "eos"
    jeng = JEngine(jf, num_slots=2, max_len=24, spec_draft=jf, spec_len=4,
                   **knobs)
    jh = jeng.submit(PROMPT, 8, eos_id=eos, pad_id=1)
    jeng.run_until_idle()
    np.testing.assert_array_equal(h.result(), jh.result())
    if paged:
        _assert_no_block_leaks(eng)


def test_spec_stats_mirror_offline_vocabulary(fitted):
    """The engine reports speculation through speculative_generate's own
    keys (drafted, accepted; verify_calls mirrored by target_calls)."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24, spec_draft=fitted,
                        spec_len=3)
    h = eng.submit(PROMPT, 10)
    eng.run_until_idle()
    s = eng.stats
    assert h.done and s["verify_calls"] >= 1
    assert s["target_calls"] == s["verify_calls"] == s["decode_steps"]
    assert s["drafted"] == 3 * s["verify_calls"]
    assert 0 <= s["accepted"] <= s["drafted"]
    # each round commits accepted + 1 tokens; the first token is the
    # prefill's and the last round may commit past the request's end
    assert len(h.tokens) - 1 <= s["accepted"] + s["verify_calls"]
    _, off = fitted.speculative_generate(fitted, PROMPT[None], 6,
                                         draft_len=3, return_stats=True)
    assert set(off) == {"target_calls", "drafted", "accepted"}
    assert set(off) < set(s)


def test_spec_warmup_runs_every_program(fitted, draft_pair, monkeypatch):
    """warmup() on a speculative engine runs the round (draft steps, the
    verify and the back-fill), every bucket's dual-pool prefill and the
    chunk programs of both models, each with every write dropped: a
    request after it is generate's."""
    _, pd = draft_pair
    calls = {"target": [], "draft": []}
    orig = pdec._forward

    def counting(model, caches, toks, pos, *a, **k):
        calls["target" if model is fitted.model else "draft"].append(
            toks.shape[1])
        return orig(model, caches, toks, pos, *a, **k)

    monkeypatch.setattr(pdec, "_forward", counting)
    eng = ServingEngine(fitted, num_slots=2, max_len=24, spec_draft=pd,
                        spec_len=2, prefill_chunk=4,
                        prefills_per_step=2).warmup()
    # the round: 2 draft steps, the verify (L = 3), the back-fill; the
    # bucket ladder is [4]; the chunk programs stage and finish at 4
    assert sorted(calls["target"]) == [3, 4, 4, 4]
    assert sorted(calls["draft"]) == [1, 1, 1, 4, 4, 4]
    h = eng.submit(PROMPT, 6)
    eng.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))
    assert eng.stats["requests_completed"] == 1


def test_spec_engine_validation(fitted, pair):
    """The JAX engine's refusals, with its messages: a draft of another
    vocabulary, speculation on the eager reference; and the port's own: a
    draft on another device than the target's."""
    jf, _ = pair
    odd = both(seed=5)
    odd[1].model.layers[0].input_dim = VOCAB + 1  # forge a vocab mismatch
    odd[0].model.layers[0].input_dim = VOCAB + 1
    for engine, f, d in ((ServingEngine, fitted, odd[1]),
                         (JEngine, jf, odd[0])):
        with pytest.raises(ValueError, match="vocabularies differ"):
            engine(f, num_slots=1, max_len=24, spec_draft=d)
        with pytest.raises(ValueError, match="bit-exactness reference"):
            engine(f, num_slots=1, max_len=24, prefill_mode="eager",
                   spec_draft=f)
    meta = both(seed=6)[1]
    meta.model.to("meta")
    with pytest.raises(ValueError, match="draft lies on"):
        ServingEngine(fitted, num_slots=1, max_len=24, spec_draft=meta)


# ---------------------------------------------------------------------------
# paged speculation
# ---------------------------------------------------------------------------

def test_paged_spec_greedy_identity_and_sampled_matches_dense(pair):
    """Speculation on the paged pool: the greedy chain is generate's and
    the JAX paged speculative engine's (stats too); a sampled row draws
    what the dense speculative engine draws (the tables change storage,
    not randomness); the draft arena shares the target's block ids and
    no block leaks."""
    jf, pf = pair
    kw = dict(num_slots=3, max_len=24, paged=True, block_size=4,
              spec_draft=pf, spec_len=3)
    eng = ServingEngine(pf, **kw)
    assert eng._d_tbl == 7 and eng.d_caches[2]["k"].shape[0] == \
        (eng.kv_blocks + 1) * 4
    g = eng.submit(PROMPT, 8)
    s = eng.submit(np.array([5, 6, 7], np.int32), 8, temperature=0.7,
                   seed=5)
    eng.run_until_idle()
    np.testing.assert_array_equal(g.result(), _want(pf, g, max_len=24))
    jeng = JEngine(jf, **{**kw, "spec_draft": jf})
    jg = jeng.submit(PROMPT, 8)
    jeng.run_until_idle()
    np.testing.assert_array_equal(g.result(), jg.result())
    dense = ServingEngine(pf, num_slots=3, max_len=24, spec_draft=pf,
                          spec_len=3)
    g2 = dense.submit(PROMPT, 8)
    s2 = dense.submit(np.array([5, 6, 7], np.int32), 8, temperature=0.7,
                      seed=5)
    dense.run_until_idle()
    np.testing.assert_array_equal(s.result(), s2.result())
    assert {k: eng.stats[k] for k in SPEC_STATS} == \
        {k: dense.stats[k] for k in SPEC_STATS}
    assert g2.done and eng.stats["drafted"] > 0
    _assert_no_block_leaks(eng)


def test_paged_spec_prefix_sharing_serves_both_arenas(pair, draft_pair):
    """A second admission sharing a full-block prefix reuses the blocks in
    both arenas (one trie serves target and draft) and a partial boundary
    block is copied on write in both: tokens equal generate and the JAX
    paged speculative engine's, with the same pool counters."""
    jf, pf = pair
    jd, pd = draft_pair
    prefix = (np.arange(10) % VOCAB).astype(np.int32)
    reqs = [(np.concatenate([prefix, [1, 2]]).astype(np.int32), 5),
            (np.concatenate([prefix, [3]]).astype(np.int32), 6)]
    kw = dict(num_slots=2, max_len=28, paged=True, block_size=4,
              spec_len=2)
    rows = []
    for engine, f, d in ((ServingEngine, pf, pd), (JEngine, jf, jd)):
        eng = engine(f, spec_draft=d, **kw)
        out = []
        for p, n in reqs:
            out.append(eng.submit(p, n))
            eng.run_until_idle()
        rows.append(([h.result() for h in out],
                     {k: eng.stats[k] for k in (
                         "blocks_allocated", "blocks_reused", "prefix_hits",
                         "prefix_hit_tokens", "cow_copies", *SPEC_STATS)}))
        if engine is ServingEngine:
            _assert_no_block_leaks(eng)
    assert rows[0][1] == rows[1][1]
    assert rows[0][1]["prefix_hits"] == 1 and rows[0][1]["cow_copies"] == 1
    for got, want in zip(rows[0][0], rows[1][0]):
        np.testing.assert_array_equal(got, want)
    for (p, n), got in zip(reqs, rows[0][0]):
        np.testing.assert_array_equal(
            got, pf.generate(p[None], n, max_len=28).numpy()[0])


# ---------------------------------------------------------------------------
# the round as a graph; transfers; static storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_spec_graph_round_equals_uncaptured(fitted, draft_pair, monkeypatch,
                                            paged):
    """A mixed greedy/sampled trace (chunked prompts, backfills) through
    the captured round and the uncaptured one: the same tokens; one
    capture at warmup, one replay a round."""
    _, pd = draft_pair
    knobs = dict(paged=True, block_size=4) if paged else {}
    reqs = [(p, s, dict(temperature=0.7, seed=i) if i % 2 else {})
            for i, (p, s) in enumerate(TRACE)]
    rows = []
    for graph in (False, True):
        if graph:
            RecordingGraph.captures = 0
            monkeypatch.setattr(serving, "_uses_graph", lambda device: True)
            monkeypatch.setattr(serving, "_capture_graph",
                                lambda step, device: RecordingGraph(step))
        eng = ServingEngine(fitted, num_slots=3, max_len=24,
                            prefill_chunk=8, spec_draft=pd, spec_len=2,
                            **knobs).warmup()
        hs = [eng.submit(p, s, **kw) for p, s, kw in reqs]
        eng.run_until_idle()
        rows.append([h.result() for h in hs])
        if graph:
            assert RecordingGraph.captures == 1
            assert eng.stats["graph_captures"] == 1
            assert eng.stats["graph_replays"] == eng.stats["decode_steps"]
            assert eng.stats["graph_replays"] == eng.stats["verify_calls"]
        else:
            assert eng.stats["graph_replays"] == 0
        if paged:
            _assert_no_block_leaks(eng)
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)
    for (p, s, kw), row in zip(reqs, rows[1]):
        if not kw:
            np.testing.assert_array_equal(
                row, fitted.generate(p[None], s, max_len=24).numpy()[0])


def test_spec_capture_mid_traffic_puts_the_warm_up_back(fitted, graphed):
    """Without warmup() the first round captures: its warm-up run
    advanced the active rows, whose tokens and positions are put back, so
    greedy rows stay generate's and a sampled row repeats."""
    rows = []
    for _ in range(2):
        eng = ServingEngine(fitted, num_slots=3, max_len=24,
                            spec_draft=fitted, spec_len=3)
        hs = [eng.submit(PROMPT, 9), eng.submit(PROMPT[::-1].copy(), 7,
                                                temperature=0.8, seed=4)]
        eng.run_until_idle()
        rows.append([h.result() for h in hs])
        np.testing.assert_array_equal(hs[0].result(),
                                      _want(fitted, hs[0], max_len=24))
    assert graphed.captures == 2
    np.testing.assert_array_equal(rows[0][1], rows[1][1])


def test_spec_failed_capture_raises_without_fallback(fitted, monkeypatch):
    def broken(step, device):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(serving, "_uses_graph", lambda device: True)
    monkeypatch.setattr(serving, "_capture_graph", broken)
    with pytest.raises(RuntimeError, match="capture of the speculative "
                                           "round"):
        ServingEngine(fitted, num_slots=1, max_len=24, spec_draft=fitted
                      ).warmup()
    eng = ServingEngine(fitted, num_slots=1, max_len=24, spec_draft=fitted)
    h = eng.submit(PROMPT, 4)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        eng.run_until_idle()
    assert h.finish == "error" and eng.stats["verify_calls"] == 0


@pytest.mark.parametrize("paged", [False, True])
def test_spec_decode_iteration_transfer_discipline(fitted, paged):
    """A decode-only speculative iteration uploads nothing and reads one
    array back (the round's committed tokens and counts)."""
    knobs = dict(paged=True, block_size=4) if paged else {}
    eng = ServingEngine(fitted, num_slots=2, max_len=32, spec_draft=fitted,
                        spec_len=2, **knobs).warmup()
    h = eng.submit(PROMPT, 24)
    eng.step()  # admission iteration (uploads happen here, counted apart)
    put = eng._put

    def no_upload(x):
        raise AssertionError("a decode-only iteration uploaded")

    eng._put = no_upload
    h0, d0 = eng.stats["h2d_transfers"], eng.stats["d2h_transfers"]
    for _ in range(4):
        eng.step()
    assert eng.stats["h2d_transfers"] - h0 == 0
    assert eng.stats["d2h_transfers"] - d0 == 4
    eng._put = put
    eng.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=32))


@pytest.mark.parametrize("paged", [False, True])
def test_spec_static_storage_keeps_its_addresses(fitted, draft_pair, paged):
    """The graph holds the pools', the tables' and the state's storage:
    traffic (prefill, chunks, rounds, retirement) writes them in place."""
    _, pd = draft_pair
    knobs = dict(paged=True, block_size=4) if paged else {}
    eng = ServingEngine(fitted, num_slots=2, max_len=24, prefill_chunk=4,
                        spec_draft=pd, spec_len=2, **knobs).warmup()

    def addresses():
        out = [t.data_ptr() for c in (*eng.caches, *eng.d_caches)
               if c is not None for t in c.values()]
        out += [eng._dev_spec.data_ptr(), eng._dev_tok.data_ptr(),
                eng._dev_pos.data_ptr(), eng._dev_keys.data_ptr()]
        if paged:
            out += [eng._dev_bt.data_ptr(), eng._dev_dbt.data_ptr()]
        return out

    before = addresses()
    hs = [eng.submit(LONG_PROMPT, 5), eng.submit(PROMPT, 7, temperature=0.6,
                                                 seed=2)]
    eng.run_until_idle()
    assert all(h.done for h in hs)
    assert addresses() == before


# ---------------------------------------------------------------------------
# the round itself: inactive rows, the draws' counters, the distribution
# ---------------------------------------------------------------------------

def test_spec_round_inactive_rows_commit_nothing(fitted):
    """An inactive row keeps its token and position and commits 0; an
    active greedy row commits accepted + 1 tokens, its chain the target's
    argmax."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24, spec_draft=fitted,
                        spec_len=3)
    eng.submit(PROMPT, 10)
    eng._schedule_prefills()
    tok, pos = eng._dev_tok.clone(), eng._dev_pos.clone()
    out, new_tok, new_pos = serving._spec_round(
        eng.model, eng._draft_model, eng.caches, eng.d_caches,
        eng._dev_tok, eng._dev_pos, eng._dev_act, eng._dev_temp,
        eng._dev_topk, eng._dev_topp, eng._dev_keys, 3)
    active = int(np.flatnonzero(eng._active)[0])
    idle = 1 - active
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert int(out[idle, -1]) == 0
    assert int(new_tok[idle]) == int(tok[idle])
    assert int(new_pos[idle]) == int(pos[idle])
    n = int(out[active, -1])
    assert 1 <= n <= 4 and int(new_pos[active]) == int(pos[active]) + n
    want = _want(fitted, eng._handles[active], max_len=24)
    got = [int(tok[active])] + [int(t) for t in out[active, :n]]
    np.testing.assert_array_equal(got, want[len(PROMPT):len(PROMPT) + n + 1])


def test_spec_draw_purposes_use_disjoint_counters(fitted, draft_pair,
                                                  monkeypatch):
    """Every draw of a sampled speculative request goes through
    ``random_bits``; each call site of the round (the draft's proposal,
    the accept uniform, the residual or bonus draw) and the prefill's
    sampler takes counter words of its own purpose window [p·V, (p+1)·V),
    one window per site, so no two purposes share bits."""
    _, pd = draft_pair
    sites = {}
    orig = pdec.random_bits

    def recording(keys, counter, rows, n):
        frame = sys._getframe(1)
        while frame.f_code.co_name not in ("_spec_round",
                                           "sample_logits_batched"):
            frame = frame.f_back
        site = (frame.f_code.co_name, frame.f_lineno)
        lo = rows.to(torch.int64) * n
        windows = set((lo // VOCAB).tolist()) | set(
            ((lo + n - 1) // VOCAB).tolist())
        sites.setdefault(site, set()).update(windows)
        return orig(keys, counter, rows, n)

    monkeypatch.setattr(pdec, "random_bits", recording)
    eng = ServingEngine(fitted, num_slots=2, max_len=24, spec_draft=pd,
                        spec_len=3)
    h = eng.submit(PROMPT, 12, temperature=0.9, top_k=6, seed=9)
    eng.run_until_idle()
    assert h.done and eng.stats["verify_calls"] >= 2
    # the prefill's sampler, and the round's draft proposal, accept
    # uniform and residual or bonus draw
    assert len(sites) == 4
    spec = {s: w for s, w in sites.items() if s[0] == "_spec_round"}
    assert len(spec) == 3
    for windows in sites.values():
        assert len(windows) == 1    # one call site, one purpose window
    assert sorted(next(iter(w)) for w in spec.values()) == [1, 2, 3]
    plain = [w for s, w in sites.items() if s[0] != "_spec_round"]
    assert all(w == {0} for w in plain)


def _warped_probs(model, prompt, temperature, top_k, top_p):
    with torch.no_grad():
        logits = model.model(torch.as_tensor(prompt[None]))[0, -1].float()
    return torch.softmax(pdec._filter_logits(logits / temperature, top_k,
                                             top_p), -1).double().numpy()


def _tv(a, b):
    return 0.5 * float(np.abs(a - b).sum())


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.8, 5, None), (1.3, None, 0.9), (1.0, 6, 0.8)])
def test_sampled_spec_first_token_follows_warped_target(
        fitted, draft_pair, temperature, top_k, top_p):
    """The Leviathan/Chen commit on its own: 512 slots hold one context
    (PROMPT then token 7) under distinct keys, and 8 rounds of fresh keys
    give 4,096 first committed tokens of a random draft's speculation.
    Their frequencies must match softmax of the warped target within the
    sampling noise: total variation at most the mean + 4 sigma of the TV
    of 4,096 exact draws (simulated, 2,000 times), while the draft's own
    warped distribution lies well outside that bound (the test has
    power); both the accept and the residual path commit tokens."""
    _, pd = draft_pair
    slots, reps, x = 512, 8, 7
    eng = ServingEngine(fitted, num_slots=slots, max_len=24, spec_draft=pd,
                        spec_len=2, prefills_per_step=slots,
                        queue_capacity=slots)
    for i in range(slots):
        eng.submit(PROMPT, 6, temperature=temperature, top_k=top_k,
                   top_p=top_p, seed=i)
    eng._schedule_prefills()
    eng._dev_tok.fill_(x)
    tok, pos = eng._dev_tok.clone(), eng._dev_pos.clone()
    rng = np.random.default_rng(1)
    firsts, counts = [], []
    for _ in range(reps):
        eng._dev_keys.copy_(torch.as_tensor(
            rng.integers(0, 2 ** 32, (slots, 2)), dtype=torch.int64))
        eng._device_round()
        firsts.append(eng._dev_spec[:, 0].numpy().copy())
        counts.append(eng._dev_spec[:, -1].numpy().copy())
        eng._dev_tok.copy_(tok)
        eng._dev_pos.copy_(pos)
    ctx = np.concatenate([PROMPT, [x]]).astype(np.int32)
    p = _warped_probs(fitted, ctx, temperature, top_k, top_p)
    q = _warped_probs(pd, ctx, temperature, top_k, top_p)
    n = slots * reps
    freq = np.bincount(np.concatenate(firsts), minlength=VOCAB) / n
    null = [_tv(rng.multinomial(n, p / p.sum()) / n, p)
            for _ in range(2000)]
    bound = float(np.mean(null) + 4 * np.std(null))
    assert _tv(freq, p) <= bound, (_tv(freq, p), bound)
    assert _tv(q, p) > 3 * bound, (_tv(q, p), bound)
    assert (freq[p == 0] == 0).all()        # nothing outside the warp
    committed = np.concatenate(counts)
    assert (committed >= 2).any() and (committed == 1).any()


# ---------------------------------------------------------------------------
# retirement under speculation
# ---------------------------------------------------------------------------

def test_spec_cancel_mid_round_frees_slot_next_occupant_unpolluted(fitted):
    """Cancel lands while a round is in flight: the slot (target and
    draft rows) returns within one iteration, and the next occupant is
    generate's (no stale draft or verify state bleeds across)."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24, spec_draft=fitted,
                        spec_len=3)
    h = eng.submit(PROMPT, 16)
    eng.step()   # prefill (and the first round dispatched)
    eng.step()   # another round in flight
    eng.cancel(h)
    eng.step()
    assert h.finish == "cancel"
    assert eng.stats["requests_cancelled"] == 1
    _assert_slots_reclaimed(eng)
    h2 = eng.submit(OTHER, 10)
    eng.run_until_idle()
    np.testing.assert_array_equal(h2.result(), _want(fitted, h2, max_len=24))


def test_spec_deadline_mid_round_and_mid_chunked_prefill(fitted):
    """Deadline expiry retires a speculating slot mid-run and a chunked
    prefill mid-flight (both pools' staging dropped)."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24, spec_draft=fitted,
                        spec_len=3, prefill_chunk=4)
    h = eng.submit(LONG_PROMPT, 4, deadline_s=0.05)
    eng.step()
    assert eng._prefilling
    assert eng._prefilling[0].d_staging is not None
    _wait_for(lambda: h._expired(time.perf_counter()))
    eng.run_until_idle()
    assert h.finish == "deadline" and not h.tokens
    _assert_slots_reclaimed(eng)

    eng = ServingEngine(fitted, num_slots=2, max_len=24, spec_draft=fitted,
                        spec_len=3)
    doomed = eng.submit(PROMPT, 16, deadline_s=0.05)
    healthy = eng.submit(OTHER, 10)
    eng.step()
    eng.step()
    _wait_for(lambda: doomed._expired(time.perf_counter()))
    eng.run_until_idle()
    assert doomed.finish == "deadline"
    assert healthy.finish == "length"
    np.testing.assert_array_equal(healthy.result(),
                                  _want(fitted, healthy, max_len=24))
    _assert_slots_reclaimed(eng)


@pytest.mark.parametrize("reason", ["cancel_running", "deadline_running",
                                    "cancel_mid_chunk",
                                    "deadline_mid_chunk", "cancel_queued"])
def test_paged_spec_retirement_matrix_zero_block_leaks(fitted, reason):
    """The paged early-retirement matrix under speculation: every path
    releases the plan (both tables re-nulled), and the next occupant
    reuses the blocks with generate's output."""
    chunked = reason.endswith("mid_chunk")
    eng = ServingEngine(fitted, num_slots=1, max_len=24, paged=True,
                        block_size=4, prefill_chunk=4, spec_draft=fitted,
                        spec_len=3)
    if reason == "cancel_queued":
        running = eng.submit(PROMPT, 12)
        target = eng.submit(OTHER, 5)
        eng.step()
        eng.cancel(target)
        eng.run_until_idle()
        assert running.finish == "length"
    else:
        prompt = LONG_PROMPT if chunked else PROMPT
        kw = {"deadline_s": 0.05} if reason.startswith("deadline") else {}
        target = eng.submit(prompt, 8, **kw)
        eng.step()
        if chunked:
            assert eng._prefilling
        else:
            eng.step()
            assert eng.kv_blocks_in_use > 0
        if reason.startswith("cancel"):
            eng.cancel(target)
        else:
            _wait_for(lambda: target._expired(time.perf_counter()))
        eng.run_until_idle()
    assert target.finish == ("cancel" if reason.startswith("cancel")
                             else "deadline")
    _assert_slots_reclaimed(eng)
    _assert_no_block_leaks(eng)
    assert (eng._dev_dbt == eng.kv_blocks).all()
    h2 = eng.submit(OTHER, 6)
    eng.run_until_idle()
    np.testing.assert_array_equal(h2.result(), _want(fitted, h2, max_len=24))
    _assert_no_block_leaks(eng)
