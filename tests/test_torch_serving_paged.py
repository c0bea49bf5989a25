"""The port's paged serving engine (``ServingEngine(paged=True)``): the
block arena, its radix prefix trie and the paged decode step, against the
JAX package's paged engine, the port's dense engine and ``generate``.

The contract pinned here, on the JAX serving tests' tiny LM (vocab 17,
seq 32, d_model 16, 2 heads, 2 layers, f32, one numpy weight set in both
packages):

 - the paged pool is a storage relayout, not a numerics change: lone
   requests (greedy and sampled), rolling pools, prefix sharing,
   copy-on-write, chunked prefill with prefix hits, capacity pressure with
   eviction and same-pass batch admissions all emit ``generate``'s
   tokens, and the same traces through the JAX paged engine give the same
   tokens and the same pool counters (``blocks_allocated``,
   ``blocks_reused``, ``blocks_evicted``, ``prefix_hits``,
   ``prefix_hit_tokens``, ``cow_copies``);
 - every retirement path (cancel or deadline against a queued, running or
   mid-chunk request) returns the pool to zero blocks in use, keeps block
   conservation and leaves no plan;
 - the decode step reads the device block tables: a decode-only
   iteration uploads nothing and reads back one token row; captured as a
   graph (a recording stand-in here, as in the dense fast-path tests) it
   equals the uncaptured step, and the arena and the tables keep their
   storage for the graph's whole life.
"""

import time

import numpy as np
import pytest
import torch

import distkeras_tpu_torch.serving as serving
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.core import quant as pquant
from distkeras_tpu_torch.serving import ServingEngine, _PagedKVPool
from test_torch_serving_fastpath import (PROMPT, TRACE, VOCAB, RecordingGraph,
                                         _want, both)
from test_torch_serving_resilience import (LONG_PROMPT, OTHER,
                                           _assert_slots_reclaimed, _wait_for)

torch.set_num_threads(1)

POOL_STATS = ("blocks_allocated", "blocks_reused", "blocks_evicted",
              "prefix_hits", "prefix_hit_tokens", "cow_copies")


@pytest.fixture(scope="module")
def pair():
    return both()


@pytest.fixture(scope="module")
def fitted(pair):
    return pair[1]


@pytest.fixture(scope="module")
def windowed():
    return both(seed=1, attention_window=6)


def _assert_no_block_leaks(eng):
    """Every retirement path returns the pool to baseline: no block held
    by a live request, free + cached + private == arena, no plan left."""
    assert eng.kv_blocks_in_use == 0, f"leaked {eng.kv_blocks_in_use}"
    assert eng._pool.check_conservation()
    assert not eng._plans


def _prefixed(prefix, tail):
    return np.concatenate([prefix, tail]).astype(np.int32)


# ---------------------------------------------------------------------------
# bit-identity: paged vs dense vs generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},                                                       # greedy
    {"temperature": 0.7, "seed": 11},                         # plain sample
    {"temperature": 0.7, "top_k": 5, "top_p": 0.9, "seed": 11},
])
def test_paged_lone_request_matches_dense_and_generate(fitted, kw):
    eng = ServingEngine(fitted, num_slots=3, max_len=24, paged=True,
                        block_size=4)
    h = eng.submit(PROMPT, 8, **kw)
    eng.run_until_idle()
    dense = ServingEngine(fitted, num_slots=3, max_len=24)
    hd = dense.submit(PROMPT, 8, **kw)
    dense.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))
    np.testing.assert_array_equal(h.result(), hd.result())
    _assert_no_block_leaks(eng)


def test_paged_rolling_lone_request_matches_generate(windowed):
    """Rolling paged pools: the ring lives in blocks behind the table
    (a fixed allocation per slot, no sharing): rolling generate's tokens,
    bucketed and chunked admission."""
    _, pw = windowed
    eng = ServingEngine(pw, num_slots=2, max_len=24, rolling=True,
                        paged=True, block_size=4)
    h = eng.submit(PROMPT, 10)
    eng.run_until_idle()
    np.testing.assert_array_equal(
        h.result(), _want(pw, h, max_len=24, rolling=True))
    _assert_no_block_leaks(eng)
    assert eng._pool.cached_blocks() == 0       # no trie on rings
    eng = ServingEngine(pw, num_slots=2, max_len=28, rolling=True,
                        paged=True, block_size=4, prefill_chunk=4)
    long_p = (np.arange(1, 14, dtype=np.int32) * 5) % VOCAB
    h = eng.submit(long_p, 6, temperature=0.5, seed=7)
    eng.run_until_idle()
    np.testing.assert_array_equal(
        h.result(), _want(pw, h, max_len=28, rolling=True))
    assert eng.stats["prefill_chunks"] == 4
    _assert_no_block_leaks(eng)


def test_paged_prefix_sharing_reuses_blocks_exactly(fitted):
    """A second admission sharing a full-block prefix shares the matched
    blocks (allocation shrinks by exactly the reuse), prefills only its
    suffix, and still emits generate's tokens."""
    eng = ServingEngine(fitted, num_slots=2, max_len=28, paged=True,
                        block_size=4)
    prefix = (np.arange(12) % VOCAB).astype(np.int32)      # 3 full blocks
    h1 = eng.submit(_prefixed(prefix, [1, 2]), 6)
    eng.run_until_idle()
    alloc1 = eng.stats["blocks_allocated"]
    pf1 = eng.stats["prefill_tokens"]
    h2 = eng.submit(_prefixed(prefix, [5, 6]), 6, temperature=0.5, seed=3)
    eng.run_until_idle()
    for h in (h1, h2):
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=28))
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["prefix_hit_tokens"] == 12
    assert eng.stats["blocks_reused"] == 3
    assert (eng.stats["blocks_allocated"] - alloc1
            == alloc1 - eng.stats["blocks_reused"])
    assert eng.stats["prefill_tokens"] - pf1 == 2
    _assert_no_block_leaks(eng)


def test_paged_cow_copies_partial_boundary_block(fitted):
    """A prompt matching a cached chain partially into a block gets a
    copy-on-write duplicate: the original stays cached, the new request
    writes its suffix into its copy, and both sides stay exact."""
    eng = ServingEngine(fitted, num_slots=2, max_len=28, paged=True,
                        block_size=4)
    p1 = (np.arange(10) % VOCAB).astype(np.int32)   # 2 full + 2 boundary
    h1 = eng.submit(_prefixed(p1, [1, 2]), 4)
    eng.run_until_idle()
    shared = [c["k"][:].clone() for c in eng.caches if c is not None]
    cached = {n.block for n in eng._pool._nodes()}
    h2 = eng.submit(_prefixed(p1, [9, 9]), 4)
    eng.run_until_idle()
    for h in (h1, h2):
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=28))
    assert eng.stats["cow_copies"] == 1
    assert eng.stats["prefix_hit_tokens"] == 10   # 8 shared + 2 copied
    bs = eng.block_size
    for before, c in zip(shared, (c for c in eng.caches if c is not None)):
        for b in cached:   # the cached chain's blocks were never written
            torch.testing.assert_close(c["k"][b * bs:(b + 1) * bs],
                                       before[b * bs:(b + 1) * bs],
                                       rtol=0, atol=0)
    _assert_no_block_leaks(eng)


def test_paged_chunked_prefill_and_prefix_hit_skips_chunks(fitted):
    """Paged chunked prefill writes straight into the request's blocks
    and stays generate's; a later admission hitting the long prompt's
    prefix skips the chunked path (its suffix fits a bucket)."""
    eng = ServingEngine(fitted, num_slots=2, max_len=32, paged=True,
                        block_size=4, prefill_chunk=4)
    long_p = (np.arange(1, 14, dtype=np.int32) * 3) % VOCAB  # 13 tokens
    h = eng.submit(long_p, 8)
    h2 = eng.submit(PROMPT, 4)
    eng.run_until_idle()
    assert eng.stats["prefill_chunks"] == 4
    for x in (h, h2):
        np.testing.assert_array_equal(x.result(),
                                      _want(fitted, x, max_len=32))
    chunks0 = eng.stats["prefill_chunks"]
    h3 = eng.submit(_prefixed(long_p[:12], [9, 9]), 6)
    eng.run_until_idle()
    np.testing.assert_array_equal(h3.result(), _want(fitted, h3, max_len=32))
    assert eng.stats["prefill_chunks"] == chunks0   # hit → bucket path
    assert eng.stats["prefix_hits"] >= 1
    _assert_no_block_leaks(eng)


def test_paged_capacity_pressure_evicts_and_backpressures(fitted):
    """A tiny arena: admissions wait at the head of the queue while live
    requests hold every block, cached refcount-0 chains are evicted LRU to
    make room, every request completes exactly, and the pool returns to
    baseline."""
    eng = ServingEngine(fitted, num_slots=4, max_len=24, paged=True,
                        block_size=4, kv_blocks=8).warmup()
    hs = [eng.submit((np.arange(i + 1, i + 5) % VOCAB).astype(np.int32),
                     6, seed=i) for i in range(6)]
    eng.step()
    assert eng.active_requests < 4 and eng.queue_depth > 0
    eng.run_until_idle()
    for h in hs:
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=24))
    assert eng.stats["blocks_evicted"] > 0
    _assert_no_block_leaks(eng)


def test_paged_same_iteration_batch_admissions_exact(fitted):
    """Same-pass admissions sharing a prefix do not cross-match (the epoch
    guard), every output is exact, and a later admission hits the
    published chains."""
    eng = ServingEngine(fitted, num_slots=4, max_len=28, paged=True,
                        block_size=4, prefills_per_step=4)
    prefix = (np.arange(8) % VOCAB).astype(np.int32)
    hs = [eng.submit(_prefixed(prefix, [i]), 5, seed=i) for i in range(4)]
    eng.run_until_idle()
    assert eng.stats["prefix_hits"] == 0
    for h in hs:
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=28))
    h5 = eng.submit(_prefixed(prefix, [9]), 5)
    eng.run_until_idle()
    np.testing.assert_array_equal(h5.result(), _want(fitted, h5, max_len=28))
    assert eng.stats["prefix_hits"] == 1
    _assert_no_block_leaks(eng)


# ---------------------------------------------------------------------------
# the port's paged engine against the JAX paged engine
# ---------------------------------------------------------------------------

def _shared_prefix_trace():
    """Eight requests over two 9-token prefixes plus suffixes of 1-6
    tokens (some past a block boundary: copy-on-write), with repeats."""
    rng = np.random.default_rng(5)
    prefixes = [rng.integers(0, VOCAB, 9).astype(np.int32) for _ in range(2)]
    return [(_prefixed(prefixes[i % 2],
                       rng.integers(0, VOCAB, 1 + i % 6)), 3 + i % 4)
            for i in range(8)]


PARITY = {
    # TRACE: mixed lengths, a 13-token prompt chunked, two per batch
    "trace_full": ("full", TRACE, dict(num_slots=3, max_len=24,
                                       prefill_chunk=8,
                                       prefills_per_step=2)),
    "trace_rolling": ("rolling", TRACE, dict(num_slots=3, max_len=24,
                                             prefill_chunk=8,
                                             prefills_per_step=2,
                                             rolling=True)),
    "shared_prefix": ("full", _shared_prefix_trace(),
                      dict(num_slots=3, max_len=24, prefill_chunk=4,
                           prefills_per_step=2)),
    "tight_arena": ("full", _shared_prefix_trace() + TRACE[:4],
                    dict(num_slots=4, max_len=24, prefill_chunk=8,
                         kv_blocks=8)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_paged_trace_token_and_stat_identical_to_jax_engine(pair, windowed,
                                                            case):
    """The same greedy trace through the JAX paged engine and the port's:
    identical tokens, and identical pool counters; every row is also the
    port's generate."""
    form, trace, kw = PARITY[case]
    jf, pf = windowed if form == "rolling" else pair
    kw = dict(kw, paged=True, block_size=4)
    eng, jeng = ServingEngine(pf, **kw), JEngine(jf, **kw)
    hs = [eng.submit(p, s) for p, s in trace]
    jhs = [jeng.submit(p, s) for p, s in trace]
    eng.run_until_idle()
    jeng.run_until_idle()
    for h, jh in zip(hs, jhs):
        np.testing.assert_array_equal(h.result(), jh.result())
        np.testing.assert_array_equal(
            h.result(), _want(pf, h, max_len=kw["max_len"],
                              rolling=kw.get("rolling", False)))
    assert ({k: eng.stats[k] for k in POOL_STATS}
            == {k: jeng.stats[k] for k in POOL_STATS})
    assert eng.stats["prefill_tokens"] == jeng.stats["prefill_tokens"]
    assert eng._pool.cached_blocks() == jeng._pool.cached_blocks()
    assert eng.kv_pool_bytes == jeng.kv_pool_bytes
    if case == "shared_prefix":
        assert eng.stats["prefix_hits"] > 0 and eng.stats["cow_copies"] > 0
    if case == "tight_arena":
        assert eng.stats["blocks_evicted"] > 0
    _assert_no_block_leaks(eng)


def test_pool_trace_of_admissions_matches_jax():
    """The host structures alone: one script of admissions, publishes and
    releases through both pools (eviction, copy-on-write, the epoch guard,
    refusal) gives the same plans and counters."""
    from distkeras_tpu.serving import _PagedKVPool as JPool
    rng = np.random.default_rng(3)
    pools = [(_PagedKVPool(10, 4, True, dict.fromkeys(POOL_STATS, 0))),
             JPool(10, 4, True, dict.fromkeys(POOL_STATS, 0))]
    live = [[], []]
    base = rng.integers(0, 5, 12)
    for step in range(40):
        toks = np.concatenate([base[:rng.integers(0, 12)],
                               rng.integers(0, 5, rng.integers(1, 6))])
        n = -(-(len(toks) + 3) // 4)
        plans = []
        for pool, held in zip(pools, live):
            if step % 3 == 0:
                pool.next_epoch()
            plan = pool.admit(toks, n)
            if plan is not None:
                pool.publish(plan, toks)
                held.append(plan)
            if len(held) > 2 or (plan is None and held):
                pool.release(held.pop(0))
            plans.append(None if plan is None else
                         (plan.blocks, plan.matched, plan.cow,
                          [x.block for x in plan.nodes]))
        assert plans[0] == plans[1]
        assert pools[0].stats == pools[1].stats
        assert pools[0].in_use() == pools[1].in_use()
        assert pools[0].check_conservation()
        assert pools[0].trie_nodes == pools[0].cached_blocks()
    assert pools[0].stats["blocks_evicted"] > 0
    assert pools[0].stats["cow_copies"] > 0


# ---------------------------------------------------------------------------
# the decode step: transfers, the graph, static storage
# ---------------------------------------------------------------------------

def test_paged_transfer_discipline_zero_h2d_one_d2h(fitted):
    """Block tables are device-resident (installed by the prefill
    programs, re-nulled at retirement), so a decode-only iteration
    uploads nothing and reads back the sampled token row."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24, paged=True,
                        block_size=4).warmup()
    h = eng.submit(PROMPT, 14)
    eng.step()
    put = eng._put

    def no_upload(x):
        raise AssertionError("a paged decode-only iteration uploaded")

    eng._put = no_upload
    h0, d0 = eng.stats["h2d_transfers"], eng.stats["d2h_transfers"]
    for _ in range(6):
        eng.step()
    assert eng.stats["h2d_transfers"] - h0 == 0
    assert eng.stats["d2h_transfers"] - d0 == 6
    eng._put = put
    eng.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))


@pytest.mark.parametrize("form", ["full", "rolling"])
def test_paged_graph_equals_uncaptured_over_a_trace(pair, windowed,
                                                    monkeypatch, form):
    """The mixed greedy/sampled trace through the paged engine with its
    step captured (one capture, a replay a step) and uncaptured: the same
    tokens, and the arena and the block tables keep their storage."""
    _, pf = windowed if form == "rolling" else pair
    reqs = [(p, s, dict(temperature=0.7, seed=i) if i % 2 else {})
            for i, (p, s) in enumerate(TRACE)]
    kw = dict(num_slots=3, max_len=24, rolling=form == "rolling",
              prefill_chunk=8, paged=True, block_size=4)
    rows = []
    for graph in (False, True):
        if graph:
            RecordingGraph.captures = 0
            monkeypatch.setattr(serving, "_uses_graph", lambda device: True)
            monkeypatch.setattr(serving, "_capture_graph",
                                lambda step, device: RecordingGraph(step))
        eng = ServingEngine(pf, **kw).warmup()
        ptrs = ([t.data_ptr() for c in eng.caches if c is not None
                 for t in c.values()], eng._dev_bt.data_ptr())
        hs = [eng.submit(p, s, **k) for p, s, k in reqs]
        eng.run_until_idle()
        rows.append([h.result() for h in hs])
        assert ptrs == ([t.data_ptr() for c in eng.caches if c is not None
                         for t in c.values()], eng._dev_bt.data_ptr())
        if graph:
            assert RecordingGraph.captures == 1
            assert eng.stats["graph_captures"] == 1
            assert eng.stats["graph_replays"] == eng.stats["decode_steps"]
        _assert_no_block_leaks(eng)
        assert (eng._dev_bt == eng.kv_blocks).all()   # every row re-nulled
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)
    for (p, s, k), row in zip(reqs, rows[0]):
        gkw = {"rng": k["seed"], "temperature": 0.7} if k else {}
        np.testing.assert_array_equal(
            row, pf.generate(p[None], s, max_len=24,
                             rolling=form == "rolling", **gkw).numpy()[0])


def test_paged_bf16_graph_equals_uncaptured(monkeypatch):
    """At bf16 the paged engine with its step captured equals the same
    engine uncaptured, token for token (a paged prefill attends over the
    whole view, a dense bucket prefill over the bucket: at bf16 the two
    are held apart, not against each other)."""
    _, pf = both(seed=3)
    pf.model.compute_dtype = "bfloat16"
    try:
        kw = dict(num_slots=2, max_len=24, paged=True, block_size=4,
                  prefill_chunk=8)
        rows = []
        for graph in (False, True):
            if graph:
                monkeypatch.setattr(serving, "_uses_graph",
                                    lambda device: True)
                monkeypatch.setattr(serving, "_capture_graph",
                                    lambda step, device: RecordingGraph(step))
            eng = ServingEngine(pf, **kw)
            assert eng.caches[2]["k"].dtype == torch.bfloat16
            hs = [eng.submit(p, s) for p, s in TRACE]
            eng.run_until_idle()
            rows.append([h.result() for h in hs])
        for a, b in zip(*rows):
            np.testing.assert_array_equal(a, b)
    finally:
        pf.model.compute_dtype = "float32"


def test_paged_warmup_runs_every_program_and_writes_only_null(fitted,
                                                              monkeypatch):
    """warmup() runs the block-table decode step, every bucket's paged
    prefill, the in-arena chunk programs and a null-onto-null copy; every
    write lands in the null block, and live traffic after it (prefix hits
    and a copy-on-write among it) is exact."""
    copies = []
    orig = ServingEngine._copy_block

    def counting(self, src, dst):
        copies.append((src, dst))
        return orig(self, src, dst)

    monkeypatch.setattr(ServingEngine, "_copy_block", counting)
    eng = ServingEngine(fitted, num_slots=2, max_len=24, paged=True,
                        block_size=4, prefill_chunk=4,
                        prefills_per_step=2)
    for c in eng.caches:
        if c is not None:
            for t in c.values():
                t.fill_(7.0)
    eng.warmup()
    assert copies == [(eng.kv_blocks, eng.kv_blocks)]
    bs = eng.block_size
    for c in eng.caches:
        if c is not None:
            for t in c.values():
                assert (t[:eng.kv_blocks * bs] == 7.0).all()
    hs = [eng.submit(np.array([2, 3, 4], np.int32), 3),
          eng.submit((np.arange(1, 13, dtype=np.int32)) % VOCAB, 3)]
    eng.run_until_idle()
    hs.append(eng.submit(_prefixed(np.arange(1, 11) % VOCAB, [9, 9]), 3))
    eng.run_until_idle()
    assert eng.stats["prefix_hits"] >= 1 and eng.stats["cow_copies"] >= 1
    for h in hs:
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=24))


# ---------------------------------------------------------------------------
# retirement: zero leaked blocks on every path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reason", ["cancel_running", "deadline_running",
                                    "cancel_mid_chunk",
                                    "deadline_mid_chunk", "cancel_queued"])
def test_paged_retirement_matrix_zero_block_leaks(fitted, reason):
    """Cancel and deadline against queued, running and mid-chunk
    requests: each path releases the request's block plan, and the next
    occupant reuses the blocks with generate's output."""
    chunked = reason.endswith("mid_chunk")
    eng = ServingEngine(fitted, num_slots=1, max_len=24, paged=True,
                        block_size=4, prefill_chunk=4)
    if reason == "cancel_queued":
        running = eng.submit(PROMPT, 12)
        target = eng.submit(OTHER, 5)          # queued behind the one slot
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
            assert eng._prefilling and eng._plans
        else:
            eng.step()                          # a step in flight
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
    h2 = eng.submit(OTHER, 6)
    eng.run_until_idle()
    np.testing.assert_array_equal(h2.result(), _want(fitted, h2,
                                                     max_len=24))
    _assert_no_block_leaks(eng)


def test_paged_drain_and_background_thread_zero_block_leaks(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24, paged=True,
                        block_size=4).start()
    hs = [eng.submit(_prefixed(PROMPT, [i]), 5 + i) for i in range(5)]
    assert eng.drain(timeout=60.0)
    for h in hs:
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=24))
    _assert_no_block_leaks(eng)


# ---------------------------------------------------------------------------
# knobs, accounting, respawn, the load snapshot
# ---------------------------------------------------------------------------

def test_paged_knob_validation(fitted, windowed):
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(fitted, num_slots=1, max_len=24, paged=True,
                      prefill_mode="eager")
    with pytest.raises(ValueError, match="block_size"):
        ServingEngine(fitted, num_slots=1, max_len=24, paged=True,
                      block_size=0)
    with pytest.raises(ValueError, match="kv_blocks"):
        ServingEngine(fitted, num_slots=1, max_len=24, paged=True,
                      block_size=4, kv_blocks=2)
    q8 = ServingEngine(fitted, num_slots=1, max_len=24, paged=True,
                       block_size=4, kv_dtype="int8")
    assert q8.caches[2]["k"].dtype == torch.int8 and "ks" in q8.caches[2]
    assert (pquant.kv_block_bytes(q8.caches, 4) * (q8.kv_blocks + 1)
            == q8.kv_pool_bytes)
    _, pw = windowed
    eng = ServingEngine(pw, num_slots=2, max_len=24, rolling=True,
                        paged=True, block_size=4)
    assert eng._t_view == 6 and eng._blocks_per_slot == 2
    assert eng.kv_blocks == 4 and eng._dev_bt.shape == (2, 3)


def test_paged_default_off_is_dense(fitted):
    """paged=False (the default) is the dense engine: no pool, no trie,
    per-slot cache rows, and the paged counters present and 0."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    assert not eng.paged and eng._pool is None and eng.kv_blocks is None
    assert eng.kv_blocks_in_use is None
    assert eng.caches[2]["k"].shape[0] == 2
    h = eng.submit(PROMPT, 6)
    eng.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))
    assert all(eng.stats[k] == 0 for k in POOL_STATS)
    assert eng.load()["trie_blocks"] == 0


def test_paged_pool_byte_accounting(pair):
    """kv_pool_bytes counts the arena (blocks and the null block), shrinks
    with kv_blocks, equals the JAX engine's, and a block costs the same
    in both packages; the int8 arena too, and each int8 engine decodes as
    its own JAX counterpart."""
    jf, pf = pair
    big = ServingEngine(pf, num_slots=2, max_len=24, paged=True,
                        block_size=4)
    small = ServingEngine(pf, num_slots=2, max_len=24, paged=True,
                          block_size=4, kv_blocks=6)
    assert small.kv_pool_bytes < big.kv_pool_bytes
    assert small.stats["kv_pool_bytes"] == small.kv_pool_bytes
    blk = pquant.kv_block_bytes(big.caches, big.block_size)
    assert blk * (big.kv_blocks + 1) == big.kv_pool_bytes
    assert big.kv_blocks == 2 * 6
    jbig = JEngine(jf, num_slots=2, max_len=24, paged=True, block_size=4)
    assert big.kv_pool_bytes == jbig.kv_pool_bytes
    dense = ServingEngine(pf, num_slots=2, max_len=24)
    assert big.kv_pool_bytes == dense.kv_pool_bytes + blk
    # the int8 arena pages codes + scales: fewer bytes than the f32 arena
    # at the same block count, the JAX engine's bytes.  Each int8 engine
    # decodes as its own JAX counterpart: the paged one prefills through
    # the int8 arena (as decode_step token by token on that arena does),
    # the dense one in full precision, quantizing on commit — two rules
    # that need not agree token for token, so paged8 is not held against
    # dense8 (the JAX test of that name does so and fails)
    kw = dict(num_slots=2, max_len=24, kv_dtype="int8")
    q8 = ServingEngine(pf, paged=True, block_size=4, **kw)
    jq8 = JEngine(jf, paged=True, block_size=4, **kw)
    assert q8.kv_pool_bytes < big.kv_pool_bytes
    assert q8.kv_pool_bytes == jq8.kv_pool_bytes
    assert (pquant.kv_block_bytes(q8.caches, 4) * (q8.kv_blocks + 1)
            == q8.kv_pool_bytes)
    h, jh = q8.submit(PROMPT, 6), jq8.submit(PROMPT, 6)
    q8.run_until_idle()
    jq8.run_until_idle()
    np.testing.assert_array_equal(h.result(), jh.result())
    arena = pdec.init_paged_arena(pf.model, 6, 4, kv_dtype="int8")
    view = pdec.PagedView(torch.arange(7)[None], 4, 24)
    toks = [int(t) for t in PROMPT]
    for t in range(len(PROMPT) + 5):
        logits, arena = pdec.decode_step(
            pf.model, arena, torch.tensor([toks[t]], dtype=torch.int32),
            torch.tensor([t]), paged=view)
        if t >= len(PROMPT) - 1:
            toks.append(int(logits.argmax(-1)))
    np.testing.assert_array_equal(h.result(), toks)
    _assert_no_block_leaks(q8)
    d8, jd8 = ServingEngine(pf, **kw), JEngine(jf, **kw)
    h, jh = d8.submit(PROMPT, 6), jd8.submit(PROMPT, 6)
    d8.run_until_idle()
    jd8.run_until_idle()
    np.testing.assert_array_equal(h.result(), jh.result())
    assert d8.kv_pool_bytes == jd8.kv_pool_bytes


def test_paged_respawn_clone_fresh_trie_same_arena(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24, paged=True,
                        block_size=4, kv_blocks=10)
    h = eng.submit(PROMPT, 4)
    eng.run_until_idle()
    assert h.done and eng._pool.cached_blocks() > 0
    clone = eng.respawn_clone()
    assert clone.paged and clone.block_size == 4 and clone.kv_blocks == 10
    assert clone._pool is not eng._pool
    assert clone._pool.cached_blocks() == 0
    assert clone.stats["prefix_hits"] == 0
    assert len(clone._pool.free) == 10
    assert (clone.caches[2]["k"].data_ptr()
            != eng.caches[2]["k"].data_ptr())
    h2 = clone.submit(PROMPT, 4)
    clone.run_until_idle()
    np.testing.assert_array_equal(h2.result(), h.result())


def test_paged_load_snapshot_reports_the_trie(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=28, paged=True,
                        block_size=4)
    prefix = (np.arange(12) % VOCAB).astype(np.int32)
    eng.submit(_prefixed(prefix, [1, 2]), 4)
    eng.run_until_idle()
    assert eng.load()["trie_blocks"] == 3 == eng._pool.cached_blocks()
    eng.submit(_prefixed(prefix, [5]), 4)
    eng.run_until_idle()
    snap = eng.load()
    assert snap["prefix_hit_tokens"] == 12
    assert snap["trie_blocks"] == eng._pool.trie_nodes == 3
