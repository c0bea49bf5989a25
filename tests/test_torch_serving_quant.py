"""Quantization in the port's serving engine (``ServingEngine(quantize=,
kv_dtype=)``) against the JAX package's engines, ``generate`` and the
decode layer.

The contract pinned here:

 - ``quantize="int8"`` serves the tokens of ``generate`` on the
   quantized model and of the JAX int8 engine; ``quantize="bf16"``
   computes in the model's compute dtype (f32 here) on bf16-rounded
   weights, as the JAX engine does; both quantize into copies (the
   caller's model stays as it is), once, idempotently;
 - ``kv_dtype="int8"`` pools hold codes + per-entry scales: the byte
   formulas equal the JAX engine's, ``serving_quant_capacity_slots`` is
   bench.py's number, and each int8 engine equals its own JAX counterpart
   token for token — the dense one prefills in full precision and
   quantizes on commit, the paged one prefills through the int8 arena
   (as ``decode_step`` token by token does).  The two rules differ, and
   at this tiny width the difference flips an argmax (the JAX package's
   ``test_paged_pool_byte_accounting`` compares the two and fails), so
   neither is held against the other;
 - speculation composes with both knobs, and ``respawn_clone`` carries
   them; without them the engine is the plain one, counters at 0.

The int8-pool tests use the JAX serving tests' own model (PRNGKey(0)
weights, vocab 17, d_model 16, 2 heads, 2 layers, f32), whose weights
cross as the flat ``get_weights()`` list; the rest use the numpy weight
set of the other serving tests.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.core.model import FittedModel as JFitted
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu_torch import FittedModel, transformer_lm
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.core import quant as pquant
from distkeras_tpu_torch.serving import ServingEngine, _quantize_weights
from test_torch_serving_fastpath import CFG, PROMPT, VOCAB, _want, both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return both()


@pytest.fixture(scope="module")
def fitted(pair):
    return pair[1]


@pytest.fixture(scope="module")
def jax_init():
    """The JAX serving tests' model: its own PRNGKey(0) weights, in both
    packages."""
    jm = jax_lm(**CFG)
    params = jm.init(jax.random.PRNGKey(0), (32,))
    pm = FittedModel(transformer_lm(**CFG, device="cpu"))
    return JFitted(jm, params), pm.set_weights(
        [np.asarray(w) for w in jm.get_weights(params)])


def _rows(engine, f, reqs, **kw):
    eng = engine(f, **kw)
    hs = [eng.submit(p, n) for p, n in reqs]
    eng.run_until_idle()
    return [h.result() for h in hs], eng


LONG = (np.arange(1, 12, dtype=np.int32) * 2) % VOCAB   # 11 tokens


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_weight_quant_int8_matches_quantized_generate_and_jax(pair):
    """quantize="int8" routes construction through quantize_params: the
    engine equals generate on the quantized model and the JAX int8
    engine, and its kernels are QuantizedTensors."""
    jf, pf = pair
    reqs = [(PROMPT, 8), (LONG, 6)]
    rows, eng = _rows(ServingEngine, pf, reqs, num_slots=2, max_len=24,
                      quantize="int8", prefill_chunk=8)
    jrows, _ = _rows(JEngine, jf, reqs, num_slots=2, max_len=24,
                     quantize="int8", prefill_chunk=8)
    q = pf.quantize()
    for (p, n), row, jrow in zip(reqs, rows, jrows):
        np.testing.assert_array_equal(row, jrow)
        np.testing.assert_array_equal(
            row, q.generate(p[None], n, max_len=24).numpy()[0])
    assert pquant.is_quantized(eng.model)
    assert isinstance(eng.model.layers[2].attn.wq, pquant.QuantizedTensor)


def test_weight_quant_bf16_matches_jax_and_computes_f32(pair, jax_init):
    """quantize="bf16" rounds every float parameter to bf16 and keeps the
    f32 compute dtype: the forward equals the f32 model on bf16-rounded
    weights exactly, and the engine's tokens equal the JAX bf16 engine's
    (on two weight sets)."""
    jf, pf = pair
    eng = ServingEngine(pf, num_slots=2, max_len=24, quantize="bf16")
    assert eng.model.compute_dtype == "float32"
    assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
    rounded = FittedModel(transformer_lm(**CFG, device="cpu")).set_weights(
        [w.astype(np.float32) for w in
         (np.asarray(torch.as_tensor(w).to(torch.bfloat16).float())
          for w in pf.get_weights())])
    x = torch.as_tensor(np.stack([PROMPT, PROMPT[::-1].copy()]))
    with torch.no_grad():
        torch.testing.assert_close(eng.model(x), rounded.model(x),
                                   rtol=0, atol=0)
    for j, p in (pair, jax_init):
        reqs = [(PROMPT, 8), (LONG, 6)]
        rows, _ = _rows(ServingEngine, p, reqs, num_slots=2, max_len=24,
                        quantize="bf16")
        jrows, _ = _rows(JEngine, j, reqs, num_slots=2, max_len=24,
                         quantize="bf16")
        for row, jrow in zip(rows, jrows):
            np.testing.assert_array_equal(row, jrow)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantize_leaves_the_callers_model_and_is_idempotent(fitted, mode):
    """The engine quantizes into a copy: the caller's model keeps its f32
    parameters and no QuantizedTensor; quantizing the copy again returns
    it as it is (no second copy), and a self-draft shares the target's
    copy."""
    before = [w.copy() for w in fitted.get_weights()]
    eng = ServingEngine(fitted, num_slots=1, max_len=24, quantize=mode,
                        spec_draft=fitted, spec_len=2)
    assert eng.model is not fitted.model
    assert eng._draft_model is eng.model
    assert not pquant.is_quantized(fitted.model)
    assert all(p.dtype == torch.float32 for p in fitted.model.parameters())
    for a, b in zip(before, fitted.get_weights()):
        np.testing.assert_array_equal(a, b)
    assert _quantize_weights(eng.model, mode) is eng.model
    again = ServingEngine(eng.model, num_slots=1, max_len=24, quantize=mode)
    assert again.model is eng.model


# ---------------------------------------------------------------------------
# the int8 KV pools, each against its own JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,chunk", [(1, 128), (2, 128), (3, 1)])
def test_kv_int8_dense_engine_equals_jax_dense_engine(jax_init, slots,
                                                      chunk):
    """The dense int8 engine prefills in a full-precision row and
    quantizes on commit, as the JAX dense engine: the same tokens
    (bucketed and one-token chunks), and a rule of its own (the prompt's
    deeper-layer K/V come from attention over unquantized entries)."""
    jf, pf = jax_init
    kw = dict(num_slots=slots, max_len=24, kv_dtype="int8",
              prefill_chunk=chunk)
    rows, eng = _rows(ServingEngine, pf, [(PROMPT, 6)], **kw)
    jrows, jeng = _rows(JEngine, jf, [(PROMPT, 6)], **kw)
    np.testing.assert_array_equal(rows[0], jrows[0])
    np.testing.assert_array_equal(rows[0],
                                  [3, 4, 5, 6, 16, 14, 12, 12, 7, 14])
    assert eng.kv_pool_bytes == jeng.kv_pool_bytes
    assert eng.caches[2]["k"].dtype == torch.int8
    assert set(eng.caches[2]) == {"k", "v", "ks", "vs"}


def _decode_step_tokens(model, caches, steps, paged=None):
    """Greedy tokens of PROMPT fed token by token through ``decode_step``
    (each position written, then attended, through the int8 cache)."""
    toks = [int(t) for t in PROMPT]
    for t in range(len(PROMPT) + steps - 1):
        logits, caches = pdec.decode_step(
            model, caches, torch.tensor([toks[t]], dtype=torch.int32),
            torch.tensor([t]), paged=paged)
        if t >= len(PROMPT) - 1:
            toks.append(int(logits.argmax(-1)))
    return toks


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_kv_int8_paged_engine_equals_jax_paged_and_decode_step(jax_init,
                                                                block_size):
    """The paged int8 engine prefills through the int8 arena (its prompt
    attends over dequantized entries): the JAX paged int8 engine's tokens,
    and those of decode_step fed token by token on an int8 arena (and on
    a dense int8 cache, the same rule)."""
    jf, pf = jax_init
    kw = dict(num_slots=2, max_len=24, kv_dtype="int8", paged=True,
              block_size=block_size)
    rows, eng = _rows(ServingEngine, pf, [(PROMPT, 6)], **kw)
    jrows, jeng = _rows(JEngine, jf, [(PROMPT, 6)], **kw)
    np.testing.assert_array_equal(rows[0], jrows[0])
    blocks = -(-24 // block_size)
    arena = pdec.init_paged_arena(pf.model, blocks, block_size,
                                  kv_dtype="int8")
    table = torch.arange(blocks + 1)[None]      # the last column: null
    ref = _decode_step_tokens(pf.model, arena, 6,
                              pdec.PagedView(table, block_size, 24))
    np.testing.assert_array_equal(rows[0], ref)
    dense = pdec.init_cache(pf.model, 1, 24, kv_dtype="int8")
    np.testing.assert_array_equal(rows[0],
                                  _decode_step_tokens(pf.model, dense, 6))
    assert eng.kv_pool_bytes == jeng.kv_pool_bytes
    assert eng.kv_blocks_in_use == 0 and eng._pool.check_conservation()


@pytest.mark.parametrize("rolling", [False, True])
def test_kv_int8_chunked_and_rolling_commits_equal_jax(rolling):
    """Quantize-on-commit on the chunked final commit and the rolling
    ring commit (dense and paged): each int8 engine equals its JAX
    counterpart on a trace with a chunked prompt."""
    jw, pw = both(seed=1, attention_window=6) if rolling else both()
    reqs = [(PROMPT, 7), (LONG, 6), (np.array([2, 9], np.int32), 5)]
    for knobs in ({}, {"paged": True, "block_size": 4}):
        kw = dict(num_slots=2, max_len=24, kv_dtype="int8", rolling=rolling,
                  prefill_chunk=4, **knobs)
        rows, _ = _rows(ServingEngine, pw, reqs, **kw)
        jrows, _ = _rows(JEngine, jw, reqs, **kw)
        for row, jrow in zip(rows, jrows):
            np.testing.assert_array_equal(row, jrow)


def test_kv_int8_pool_bytes_and_capacity(fitted, pair):
    """The capacity math, byte-accounted: the int8 pool's bytes equal the
    JAX engine's (dense; paged: kv_block_bytes × (kv_blocks + 1)), it
    sustains >= 1.5x the slots of the f32 pool at fixed bytes, and
    bench.py's serving_quant_capacity_slots (f32 pool bytes over the int8
    pool's per-slot bytes, 4 slots) is the JAX engine's number."""
    jf, pf = pair
    kw = dict(num_slots=4, max_len=24)
    fp, q8 = ServingEngine(pf, **kw), ServingEngine(pf, kv_dtype="int8",
                                                    **kw)
    jfp, jq8 = JEngine(jf, **kw), JEngine(jf, kv_dtype="int8", **kw)
    assert (fp.kv_pool_bytes, q8.kv_pool_bytes) == \
        (jfp.kv_pool_bytes, jq8.kv_pool_bytes)
    slots = fp.kv_pool_bytes // (q8.kv_pool_bytes // q8.num_slots)
    assert slots == jfp.kv_pool_bytes // (jq8.kv_pool_bytes
                                          // jq8.num_slots)
    assert slots >= int(1.5 * fp.num_slots)
    # per entry: 2 codes of Dh bytes + 2 f32 scales against 2 x Dh x 4
    dh = 8
    assert q8.kv_pool_bytes * (2 * dh * 4) == fp.kv_pool_bytes * (2 * dh
                                                                  + 8)
    paged = ServingEngine(pf, paged=True, block_size=4, kv_dtype="int8",
                          **kw)
    blk = pquant.kv_block_bytes(paged.caches, 4)
    assert blk * (paged.kv_blocks + 1) == paged.kv_pool_bytes
    assert paged.kv_pool_bytes == JEngine(
        jf, paged=True, block_size=4, kv_dtype="int8", **kw).kv_pool_bytes
    assert paged.stats["kv_pool_bytes"] == paged.kv_pool_bytes


@pytest.mark.parametrize("paged", [False, True])
def test_spec_with_int8_kv_and_weights_equals_jax(pair, paged):
    """Speculation over int8 pools (both quantized) and int8 weights: the
    greedy rows and the speculation stats equal the JAX engine's with the
    same knobs."""
    jf, pf = pair
    knobs = dict(paged=True, block_size=4) if paged else {}
    reqs = [(PROMPT, 8), (LONG, 6)]
    kw = dict(num_slots=2, max_len=24, kv_dtype="int8", quantize="int8",
              spec_len=3, prefill_chunk=8, **knobs)
    rows, eng = _rows(ServingEngine, pf, reqs, spec_draft=pf, **kw)
    jrows, jeng = _rows(JEngine, jf, reqs, spec_draft=jf, **kw)
    for row, jrow in zip(rows, jrows):
        np.testing.assert_array_equal(row, jrow)
    keys = ("drafted", "accepted", "verify_calls", "target_calls")
    assert {k: eng.stats[k] for k in keys} == \
        {k: jeng.stats[k] for k in keys}
    assert eng.stats["verify_calls"] >= 1
    assert "ks" in eng.d_caches[2]


# ---------------------------------------------------------------------------
# respawn, defaults
# ---------------------------------------------------------------------------

def test_respawn_clone_carries_spec_and_quant_state(pair):
    """The supervisor contract: a respawned clone carries the draft,
    spec_len and both quantization knobs, shares the already quantized
    models (nothing quantized twice), warms up and serves; the greedy
    spec clone equals generate."""
    jf, pf = pair
    draft = both(seed=99)[1]
    eng = ServingEngine(pf, num_slots=2, max_len=24, spec_draft=draft,
                        spec_len=2, quantize="bf16", kv_dtype="int8")
    clone = eng.respawn_clone().warmup()
    assert clone.spec_len == 2 and clone.quantize == "bf16"
    assert clone.kv_dtype == "int8"
    assert clone.model is eng.model
    assert clone._draft_model is eng._draft_model
    assert clone.caches[2]["k"].data_ptr() != eng.caches[2]["k"].data_ptr()
    h = clone.submit(PROMPT, 4)
    clone.run_until_idle()
    j = JEngine(jf, num_slots=2, max_len=24, spec_draft=both(seed=99)[0],
                spec_len=2, quantize="bf16", kv_dtype="int8")
    jh = j.submit(PROMPT, 4)
    j.run_until_idle()
    np.testing.assert_array_equal(h.result(), jh.result())

    eng2 = ServingEngine(pf, num_slots=2, max_len=24, spec_draft=pf)
    clone2 = eng2.respawn_clone()
    assert clone2._draft_model is pf.model
    h2 = clone2.submit(PROMPT, 8)
    clone2.run_until_idle()
    np.testing.assert_array_equal(h2.result(), _want(pf, h2, max_len=24))


def test_defaults_unchanged_no_spec_counters_move(fitted):
    """spec_draft / quantize / kv_dtype at their defaults: the plain
    engine — pools in the compute dtype, no draft pool, the model the
    caller's, the speculation counters present and 0."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    assert "ks" not in eng.caches[2] and eng.d_caches is None
    assert eng.model is fitted.model and eng._draft_model is None
    assert eng.spec_len == 4 and eng.quantize is None
    assert eng.kv_dtype is None and eng._dev_dbt is None
    h = eng.submit(PROMPT, 8)
    eng.run_until_idle()
    np.testing.assert_array_equal(h.result(), _want(fitted, h, max_len=24))
    for k in ("drafted", "accepted", "verify_calls", "target_calls"):
        assert eng.stats[k] == 0
