"""The port's serving fast path (``prefill_mode="bucketed"``) against the
JAX engine, the eager reference and ``generate``.

The contract pinned here, on the JAX serving tests' tiny LM (vocab 17,
seq 32, d_model 16, 2 heads, 2 layers, f32, one numpy weight set in both
packages):

 - bucketed AND chunked prefill emit the tokens of the eager reference
   and of ``generate``, greedy and sampled, full and rolling pools, mixed
   prompt lengths in one bucket batch; greedy traces equal the JAX
   engine's token for token;
 - the bucketed hot path never calls the eager ``_forward``;
 - a decode-only iteration performs ZERO host→device uploads and exactly
   ONE device→host readback;
 - a long-prompt admission stalls the running batch by at most one chunk
   per iteration;
 - the decode step's CUDA graph: captured once (at ``warmup()`` or at the
   first decode step, with the warm-up run's state put back), replayed
   every step, no new capture after warmup, and a failed capture raises.
   A CPU has no CUDA graphs, so these tests stand a recording graph in
   for ``torch.cuda.CUDAGraph`` (its replay runs the captured function);
   on the card ``chip_smoke.py``'s phase serve holds the real graph
   against the eager engine over a whole trace.
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu_torch.serving as serving
from distkeras_tpu.core.model import FittedModel as JFitted
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu_torch import FittedModel, transformer_lm
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.serving import ServingEngine, _pow2_buckets

torch.set_num_threads(1)

VOCAB = 17
CFG = dict(vocab_size=VOCAB, seq_len=32, d_model=16, num_heads=2,
           num_layers=2, mlp_dim=32, compute_dtype="float32")
PROMPT = np.array([3, 4, 5, 6], np.int32)


def both(seed=0, **kw):
    """(JAX FittedModel, port FittedModel) holding one numpy weight set."""
    jm = jax_lm(**CFG, **kw)
    params = jm.init(jax.random.PRNGKey(0), (32,))
    rng = np.random.default_rng(seed)
    weights = [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
                if w.ndim == 2 else 0.1 * rng.standard_normal(w.shape)
                + (w == 1.0)).astype(np.float32)
               for w in jm.get_weights(params)]
    pm = FittedModel(transformer_lm(**CFG, **kw, device="cpu"))
    return JFitted(jm, jm.set_weights(params, weights)), pm.set_weights(
        weights)


@pytest.fixture(scope="module")
def pair():
    return both()


@pytest.fixture(scope="module")
def fitted(pair):
    return pair[1]


@pytest.fixture(scope="module")
def windowed():
    return both(seed=1, attention_window=6)


def _want(fm, h, **kw):
    """The port's generate of handle ``h``'s request."""
    return fm.generate(
        h.prompt[None], h.num_steps, max_len=kw.pop("max_len"),
        temperature=h.temperature,
        rng=h.key if h.temperature > 0 else None,
        top_k=h.top_k, top_p=h.top_p, **kw).numpy()[0]


class RecordingGraph:
    """A stand-in for a captured CUDA graph on the CPU: the capture runs
    the warm-up once (as ``serving._capture_graph`` does), and each replay
    runs the captured function."""

    captures = 0

    def __init__(self, step):
        step()                      # the warm-up run before a capture
        self.step = step
        RecordingGraph.captures += 1

    def replay(self):
        self.step()


@pytest.fixture
def graphed(monkeypatch):
    """Make the engines of one test take the graph route on the CPU."""
    RecordingGraph.captures = 0
    monkeypatch.setattr(serving, "_uses_graph", lambda device: True)
    monkeypatch.setattr(serving, "_capture_graph",
                        lambda step, device: RecordingGraph(step))
    return RecordingGraph


# ---------------------------------------------------------------------------
# bit-identity: bucketed / chunked / rolling vs eager reference + generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},                                                       # greedy
    {"temperature": 0.7, "seed": 11},                         # plain sample
    {"temperature": 0.7, "top_k": 5, "top_p": 0.9, "seed": 11},
])
def test_bucketed_lone_request_matches_eager_and_generate(fitted, kw):
    rows = {}
    for mode in ("bucketed", "eager"):
        eng = ServingEngine(fitted, num_slots=3, max_len=24,
                            prefill_mode=mode)
        h = eng.submit(PROMPT, 8, **kw)
        eng.run_until_idle()
        rows[mode] = h.result()
    want = _want(fitted, h, max_len=24)
    np.testing.assert_array_equal(rows["bucketed"], want)
    np.testing.assert_array_equal(rows["eager"], want)


def test_mixed_prompt_lengths_share_one_bucketed_batch(fitted):
    """Four requests of four lengths admitted in one iteration land in
    ONE batched bucket prefill, and every output still matches
    generate."""
    eng = ServingEngine(fitted, num_slots=4, max_len=24,
                        prefills_per_step=4)
    hs = [eng.submit(np.arange(1, 1 + p, dtype=np.int32) % VOCAB, 6,
                     temperature=0.5, seed=40 + p)
          for p in (2, 3, 5, 7)]
    eng.run_until_idle()
    assert eng.stats["prefill_batches"] == 1
    assert eng.stats["prefill_batch_size_mean"] == 4.0
    for h in hs:
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=24))


def test_chunked_prefill_bit_identical_and_counted(fitted):
    """A prompt past ``prefill_chunk`` splits into ceil(P/chunk) chunks
    (the final one bucket-rounded) and reproduces generate exactly,
    greedy and sampled, while a short concurrent request rides along."""
    long_p = (np.arange(1, 14, dtype=np.int32) * 3) % VOCAB  # 13 tokens
    for kw in ({}, {"temperature": 0.6, "seed": 5}):
        eng = ServingEngine(fitted, num_slots=2, max_len=32,
                            prefill_chunk=4)
        h = eng.submit(long_p, 8, **kw)
        h2 = eng.submit(PROMPT, 4)
        eng.run_until_idle()
        assert eng.stats["prefill_chunks"] == 4  # 4+4+4 + final 1
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=32))
        np.testing.assert_array_equal(h2.result(),
                                      _want(fitted, h2, max_len=32))


def test_rolling_bucketed_and_chunked_bit_identical(windowed):
    """Rolling engines: the bucket prefill ring-converts per row; the
    chunked path stages a full cache and collapses it on the final chunk
    — both match rolling generate."""
    _, pw = windowed
    eng = ServingEngine(pw, num_slots=2, max_len=24, rolling=True)
    h1 = eng.submit(np.arange(1, 8, dtype=np.int32) % VOCAB, 10,
                    temperature=0.6, seed=9)
    h2 = eng.submit(np.array([1, 2], np.int32), 6)
    eng.run_until_idle()
    for h in (h1, h2):
        np.testing.assert_array_equal(
            h.result(), _want(pw, h, max_len=24, rolling=True))
    assert eng.caches[2]["k"].shape[1] == 6  # the pool really is a ring

    eng = ServingEngine(pw, num_slots=2, max_len=28, rolling=True,
                        prefill_chunk=4)
    lp = (np.arange(1, 14, dtype=np.int32) * 5) % VOCAB
    h = eng.submit(lp, 8, temperature=0.8, seed=3)
    eng.run_until_idle()
    assert eng.stats["prefill_chunks"] == 4
    np.testing.assert_array_equal(
        h.result(), _want(pw, h, max_len=28, rolling=True))


def test_eos_retirement_on_fast_path(fitted):
    greedy = fitted.generate(PROMPT[None], 8, max_len=24).numpy()[0]
    eos = int(greedy[len(PROMPT) + 2])
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    h = eng.submit(PROMPT, 8, eos_id=eos, pad_id=1)
    eng.run_until_idle()
    want = fitted.generate(PROMPT[None], 8, eos_id=eos, pad_id=1,
                           max_len=24).numpy()[0]
    np.testing.assert_array_equal(h.result(), want)
    assert h.finish == "eos"


# ---------------------------------------------------------------------------
# the port's engine against the JAX engine over one greedy trace
# ---------------------------------------------------------------------------

TRACE = [(np.arange(1, 1 + p, dtype=np.int32) * (i + 2) % VOCAB, steps)
         for i, (p, steps) in enumerate([(3, 9), (13, 6), (5, 12), (2, 4),
                                         (11, 7), (7, 5), (1, 10)])]


@pytest.mark.parametrize("form,mode", [("full", "bucketed"),
                                       ("full", "eager"),
                                       ("rolling", "bucketed"),
                                       ("rolling", "eager")])
def test_greedy_trace_token_identical_to_jax_engine(pair, windowed, form,
                                                    mode):
    """Seven greedy requests of mixed lengths through 3 slots (backfills,
    a chunked prompt, two per prefill batch): every row of the port's
    engine equals the JAX engine's and the port's generate."""
    jf, pf = windowed if form == "rolling" else pair
    kw = dict(num_slots=3, max_len=24, rolling=form == "rolling",
              prefill_mode=mode, prefill_chunk=8, prefills_per_step=2)
    eng, jeng = ServingEngine(pf, **kw), JEngine(jf, **kw)
    hs = [eng.submit(p, s) for p, s in TRACE]
    jhs = [jeng.submit(p, s) for p, s in TRACE]
    eng.run_until_idle()
    jeng.run_until_idle()
    for h, jh in zip(hs, jhs):
        np.testing.assert_array_equal(h.result(), jh.result())
        np.testing.assert_array_equal(
            h.result(), _want(pf, h, max_len=24, rolling=kw["rolling"]))
    assert eng.stats["requests_completed"] == len(TRACE)
    assert sorted(eng._free) == [0, 1, 2]


# ---------------------------------------------------------------------------
# hot-path discipline: no eager forward, one transfer each way
# ---------------------------------------------------------------------------

def test_no_eager_forward_in_bucketed_hot_path(fitted, monkeypatch):
    """With prefill_mode="bucketed" the engine never calls the
    module-level eager ``_forward`` — only the eager reference does."""
    def bomb(*a, **k):
        raise AssertionError("eager _forward reached the bucketed hot "
                             "path")

    monkeypatch.setattr(serving, "_forward", bomb)
    eng = ServingEngine(fitted, num_slots=2, max_len=24, prefill_chunk=4)
    h = eng.submit(PROMPT, 4)
    hl = eng.submit((np.arange(1, 12, dtype=np.int32) * 7) % VOCAB, 4)
    eng.run_until_idle()  # both the batch and the chunked path: no bomb
    assert h.done and hl.done
    eager = ServingEngine(fitted, num_slots=1, max_len=24,
                          prefill_mode="eager")
    eager.submit(PROMPT, 2)
    with pytest.raises(AssertionError, match="hot path"):
        eager.run_until_idle()


def test_decode_iteration_transfer_discipline(fitted):
    """Steady-state decode: zero host→device uploads and exactly one
    device→host readback per iteration (an upload during those iterations
    would fail the test at once)."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24).warmup()
    h = eng.submit(PROMPT, 14)
    eng.step()  # admission iteration (uploads happen here, counted apart)
    put = eng._put

    def no_upload(x):
        raise AssertionError("a decode-only iteration uploaded")

    eng._put = no_upload
    h0, d0 = eng.stats["h2d_transfers"], eng.stats["d2h_transfers"]
    for _ in range(6):
        eng.step()
    assert eng.stats["h2d_transfers"] - h0 == 0
    assert eng.stats["d2h_transfers"] - d0 == 6
    eng._put = put
    eng.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))


def test_lookahead_flushes_at_idle(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    h = eng.submit(PROMPT, 5)
    eng.run_until_idle()
    assert h.done and len(h.tokens) == 5
    assert not eng._pending and not eng._prefilling
    assert not eng.step()  # truly idle


def test_long_prompt_admission_does_not_stall_decode(fitted):
    """While a 12-token prompt chunk-prefills at prefill_chunk=4, the
    running request keeps decoding EVERY iteration."""
    eng = ServingEngine(fitted, num_slots=2, max_len=32, prefill_chunk=4)
    a = eng.submit(PROMPT, 20)
    while not a.tokens:
        eng.step()
    steps0 = eng.stats["decode_steps"]
    a0 = len(a.tokens)
    b = eng.submit((np.arange(1, 13, dtype=np.int32) * 3) % VOCAB, 4)
    iters = 0
    while not b.tokens and iters < 20:
        eng.step()
        iters += 1
    assert eng.stats["prefill_chunks"] == 3        # 4 + 4 + final 4
    decoded = eng.stats["decode_steps"] - steps0
    assert decoded >= 3 and decoded == iters
    assert len(a.tokens) - a0 >= 3
    assert iters <= 5
    eng.run_until_idle()
    np.testing.assert_array_equal(a.result(), _want(fitted, a, max_len=32))
    np.testing.assert_array_equal(b.result(), _want(fitted, b, max_len=32))


# ---------------------------------------------------------------------------
# the decode step's graph
# ---------------------------------------------------------------------------

def test_no_new_capture_after_warmup(fitted, graphed):
    """warmup() captures the step once; traffic through every bucket and
    the chunked path then replays it once per decode step and captures
    nothing more, and the tokens are generate's."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24, prefill_chunk=4,
                        prefills_per_step=2).warmup()
    assert graphed.captures == 1 and eng.stats["graph_captures"] == 1
    h1 = eng.submit(np.array([2, 3, 4], np.int32), 3, temperature=0.9,
                    seed=2)
    h2 = eng.submit((np.arange(1, 12, dtype=np.int32)) % VOCAB, 3)
    eng.run_until_idle()
    assert graphed.captures == 1 and eng.stats["graph_captures"] == 1
    assert eng.stats["graph_replays"] == eng.stats["decode_steps"] > 0
    for h in (h1, h2):
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=24))


def test_capture_mid_traffic_puts_the_warm_up_back(fitted, graphed):
    """Without warmup() the first decode step captures: its warm-up run
    advanced the active rows, whose tokens and positions are put back,
    so the stream is generate's, greedy and sampled."""
    eng = ServingEngine(fitted, num_slots=3, max_len=24)
    hs = [eng.submit(PROMPT, 9), eng.submit(PROMPT[::-1].copy(), 7,
                                            temperature=0.8, seed=4)]
    eng.run_until_idle()
    assert graphed.captures == 1
    for h in hs:
        np.testing.assert_array_equal(h.result(),
                                      _want(fitted, h, max_len=24))


def test_graph_and_uncaptured_engines_agree_over_a_trace(windowed,
                                                         monkeypatch):
    """The same mixed greedy/sampled trace through the graph route and the
    uncaptured step gives the same tokens (rolling pool, chunked
    prompts)."""
    _, pw = windowed
    reqs = [(p, s, dict(temperature=0.7, seed=i) if i % 2 else {})
            for i, (p, s) in enumerate(TRACE)]
    rows = []
    for graph in (False, True):
        if graph:
            monkeypatch.setattr(serving, "_uses_graph", lambda device: True)
            monkeypatch.setattr(serving, "_capture_graph",
                                lambda step, device: RecordingGraph(step))
        eng = ServingEngine(pw, num_slots=3, max_len=24, rolling=True,
                            prefill_chunk=8).warmup()
        hs = [eng.submit(p, s, **kw) for p, s, kw in reqs]
        eng.run_until_idle()
        rows.append([h.result() for h in hs])
        assert eng.stats["graph_replays"] == (eng.stats["decode_steps"]
                                              if graph else 0)
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)


def test_failed_capture_raises_without_fallback(fitted, monkeypatch):
    def broken(step, device):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(serving, "_uses_graph", lambda device: True)
    monkeypatch.setattr(serving, "_capture_graph", broken)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        ServingEngine(fitted, num_slots=1, max_len=24).warmup()
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 4)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        eng.run_until_idle()
    assert h.finish == "error" and eng.stats["decode_steps"] == 0


def test_eager_mode_is_never_captured(fitted, graphed):
    eng = ServingEngine(fitted, num_slots=2, max_len=24,
                        prefill_mode="eager").warmup()
    h = eng.submit(PROMPT, 5)
    eng.run_until_idle()
    assert graphed.captures == 0 and eng.stats["graph_replays"] == 0
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))


def test_warmup_runs_every_program_once(fitted, monkeypatch):
    """warmup() runs the decode step, every bucket's prefill and the
    chunk programs (each forward goes through ``core.decode._forward``)
    and writes nothing: a request after it is generate's."""
    widths = []
    orig = pdec._forward

    def counting(model, caches, toks, pos, *a, **k):
        widths.append(toks.shape[1])
        return orig(model, caches, toks, pos, *a, **k)

    monkeypatch.setattr(pdec, "_forward", counting)
    eng = ServingEngine(fitted, num_slots=2, max_len=24, prefill_chunk=16)
    eng.warmup()
    assert sorted(widths) == [1, 8, 8, 8, 16, 16, 16]
    h = eng.submit(PROMPT, 5)
    eng.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))


def test_warmup_refuses_mid_prefill_engine(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=32, prefill_chunk=4)
    eng.submit((np.arange(1, 13, dtype=np.int32)) % VOCAB, 4)
    eng.step()
    assert eng._prefilling
    with pytest.raises(RuntimeError, match="active"):
        eng.warmup()


def test_pow2_bucket_ladder():
    assert _pow2_buckets(32) == [8, 16, 32]
    assert _pow2_buckets(100) == [8, 16, 32, 64, 100]
    assert _pow2_buckets(8) == [8]
    assert _pow2_buckets(5) == [5]


def test_prefill_knob_validation(fitted):
    with pytest.raises(ValueError, match="prefill_mode"):
        ServingEngine(fitted, num_slots=1, max_len=24,
                      prefill_mode="turbo")
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(fitted, num_slots=1, max_len=24, prefill_chunk=0)


def test_respawn_clone_carries_prefill_knobs(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24,
                        prefill_mode="eager", prefill_chunk=16)
    clone = eng.respawn_clone()
    assert clone.prefill_mode == "eager"
    assert clone.prefill_chunk == 16
    assert clone.caches[2]["k"].data_ptr() != eng.caches[2]["k"].data_ptr()


def test_load_snapshot_tracks_the_engine(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24, queue_capacity=5)
    assert eng.load()["slots_free"] == 2 and eng.load()["queue_depth"] == 0
    eng.submit(PROMPT, 6)
    eng.submit(PROMPT, 6)
    assert eng.load()["queue_depth"] == 2
    eng.step()
    snap = eng.load()
    assert snap["active"] == 1 and snap["slots_free"] == 1
    eng.run_until_idle()
    snap = eng.load()
    assert snap["requests_completed"] == 2 and snap["tokens_generated"] == 12
    assert snap["slots_free"] == 2 and not snap["dead"]
    assert eng.kv_pool_bytes == eng.stats["kv_pool_bytes"] > 0
