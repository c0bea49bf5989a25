"""The port's dense-cache decode layer against the JAX package's.

Every attention hook of ``dot_product_attention`` (scalar and per-row), the
per-row ``apply_rope``, ``init_cache``, the cached step against the full
forward, greedy ``generate`` token for token (full cache, GQA, rolling
rings, eos/pad), the sampling filters, ``decode_step``/``jit_decode_step``
and the validation errors.  The models are small ``transformer_lm``s at
f32 with one numpy weight set loaded into both packages; sampled paths
are compared by their properties, since torch's generators and JAX's
threefry never draw the same bits.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.core import decode as jdec
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.ops import rope as jrope
from distkeras_tpu_torch import Sequential, transformer_lm
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.core.layers import Conv2D, Embedding, TransformerBlock
from distkeras_tpu_torch.ops import rope as prope

jatt = importlib.import_module("distkeras_tpu.ops.attention")
patt = importlib.import_module("distkeras_tpu_torch.ops.attention")

torch.set_num_threads(1)

V = 32
SMALL = dict(vocab_size=V, seq_len=32, d_model=32, num_heads=4,
             num_layers=2, mlp_dim=64, compute_dtype="float32")
FORMS = {"full": dict(), "gqa": dict(num_kv_heads=2),
         "rope_window": dict(positional="rope", attention_window=6,
                             num_kv_heads=2)}


def numpy_weights(jm, params, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
             if w.ndim == 2 else 0.1 * rng.standard_normal(w.shape)
             + (w == 1.0)).astype(np.float32)
            for w in jm.get_weights(params)]


def both(form, seed=0, **over):
    """(JAX model, JAX params, port model) holding one numpy weight set."""
    cfg = {**SMALL, **FORMS[form], **over}
    jm = jax_lm(**cfg)
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm, params, seed)
    pm = transformer_lm(**cfg, device="cpu")
    pm.set_weights(weights)
    return jm, jm.set_weights(params, weights), pm


@pytest.fixture(scope="module")
def models():
    return {form: both(form) for form in FORMS}


def prompt_of(seed, b=2, p=5):
    return np.random.default_rng(seed).integers(0, V, (b, p)).astype(
        np.int32)


# -- attention hooks ---------------------------------------------------------

B, SQ, SK, H, HKV, D = 2, 3, 10, 4, 2, 8
HOOKS = {
    "q_offset": dict(q_offset=4),
    "q_offset_kv_length": dict(q_offset=4, kv_length=7),
    "window": dict(q_offset=6, kv_length=9, window=3),
    "kv_positions": dict(q_offset=8, window=5,
                         kv_positions=np.array([8, 9, 10, 11, 2, 3, 4, 5, 6,
                                                7]) - 2),
    "kv_positions_empty": dict(q_offset=3, kv_positions=np.array(
        [0, 1, 2, 3, 4, 5, -6, -5, -4, -3])),
    "row_q_offset": dict(q_offset=np.array([2, 7])),
    "row_kv_length": dict(q_offset=np.array([2, 5]),
                          kv_length=np.array([5, 8])),
    "row_kv_positions": dict(q_offset=np.array([3, 9]), window=4,
                             kv_positions=np.stack([
                                 np.arange(10) - 4,
                                 np.array([10, 11, 2, 3, 4, 5, 6, 7, 8,
                                           9])])),
    "q_positions": dict(q_positions=np.array([[1, 2, 2], [5, 6, 7]]),
                        kv_length=np.array([3, 8])),
}


@pytest.mark.parametrize("case", sorted(HOOKS))
def test_attention_hooks_match_jax(case):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, SQ, H, D)).astype(np.float32)
    k = rng.standard_normal((B, SK, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, SK, HKV, D)).astype(np.float32)
    kw = HOOKS[case]
    want = jatt.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()})
    got = patt.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, **{n: (torch.from_numpy(x) if isinstance(x, np.ndarray)
                            else x) for n, x in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_attention_hook_refusals():
    x = torch.zeros(1, 4, 2, 4)
    with pytest.raises(ValueError, match="kv_positions"):
        patt.dot_product_attention(x, x, x, kv_positions=torch.arange(4))
    with pytest.raises(ValueError, match="window"):
        patt.dot_product_attention(x, x, x, window=2)


def test_per_row_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    pos = rng.integers(0, 100, (3, 5))
    for theta, scale in ((10000.0, 1.0), (500.0, 4.0)):
        want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                scale)
        got = prope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta, scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # row r of the per-row form is the shared form at row r's positions
    for r in range(3):
        one = prope.apply_rope(torch.from_numpy(x[r:r + 1]),
                               torch.from_numpy(pos[r]))
        np.testing.assert_array_equal(
            prope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
            [r:r + 1].numpy(), one.numpy())


# -- caches ----------------------------------------------------------------------

def test_init_cache_shapes_dtypes_and_ring_slack(models):
    jm, _, pm = models["rope_window"]
    for kw in (dict(), dict(rolling=True), dict(rolling=True, ring_slack=3),
               dict(kv_dtype="int8"), dict(rolling=True, kv_dtype="int8")):
        want = jdec.init_cache(jm, 3, 20, **kw)
        got = pdec.init_cache(pm, 3, 20, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert sorted(g) == sorted(w)
            for name in w:
                assert tuple(g[name].shape) == w[name].shape
                assert str(g[name].dtype).split(".")[-1] == str(
                    w[name].dtype)
                assert not g[name].any()
    ring = pdec.init_cache(pm, 1, 20, rolling=True, ring_slack=3)
    assert {c["k"].shape[1] for c in ring if c is not None} == {9}
    bf16 = transformer_lm(**{**SMALL, "compute_dtype": "bfloat16"},
                          device="cpu")
    assert pdec.init_cache(bf16, 1, 4)[2]["k"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="kv_dtype"):
        pdec.init_cache(pm, 1, 4, kv_dtype="int4")
    with pytest.raises(ValueError, match="positional"):
        pdec.init_cache(models["full"][2], 1, 40)
    with pytest.raises(ValueError, match="rolling"):
        pdec.init_cache(models["full"][2], 1, 8, rolling=True)


@pytest.mark.parametrize("form", ["full", "gqa"])
def test_stepwise_logits_match_full_forward(models, form):
    jm, params, pm = models[form]
    toks = prompt_of(1, p=12)
    full = pm(torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_allclose(full, np.asarray(jm.apply(params, toks)),
                               atol=2e-5)
    caches = pdec.init_cache(pm, 2, 12)
    step = pdec.jit_decode_step(pm)
    for pos in range(12):
        logits, caches = step(caches, toks[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos], atol=2e-5,
                                   rtol=2e-5)


def test_per_row_and_multi_token_steps_match_jax(models):
    """The per-row (B,) position paths (dense and rolling with ring slack,
    L = 1 and L = 3) and the int8 KV cache give JAX's logits."""
    jm, params, pm = models["rope_window"]
    toks = prompt_of(2, p=12)
    for rolling, kv_dtype in ((False, None), (True, None), (False, "int8")):
        jc = jdec.init_cache(jm, 2, 12, rolling=rolling, kv_dtype=kv_dtype,
                             ring_slack=2)
        pc = pdec.init_cache(pm, 2, 12, rolling=rolling, kv_dtype=kv_dtype,
                             ring_slack=2)
        for start, length in ((0, 3), (3, 1), (4, 3), (7, 3), (10, 2)):
            pos = np.array([start, start])
            chunk = toks[:, start:start + length]
            want, jc = jdec._forward(jm, params, jc, jnp.asarray(chunk),
                                     jnp.asarray(pos), rolling)
            got, pc = pdec._forward(pm, pc, torch.from_numpy(chunk),
                                    torch.from_numpy(pos), rolling)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=2e-5)
        for g, w in zip(pc, jc):
            if w is not None:
                for name in w:
                    np.testing.assert_allclose(
                        g[name].numpy().astype(np.float32),
                        np.asarray(w[name], np.float32), atol=1e-5)
    # a write past the cache's end drops, as the JAX scatter drops it
    pc = pdec.init_cache(pm, 2, 4)
    _, pc = pdec._forward(pm, pc, torch.from_numpy(toks[:, :3]),
                          torch.tensor([2, 0]))
    assert pc[2]["k"][0, 2:].abs().sum() > 0
    assert not pc[2]["k"][0, :2].any() and not pc[2]["k"][1, 3].any()


def test_ring_from_prefill_matches_to_ring():
    rng = np.random.default_rng(5)
    full = torch.from_numpy(rng.standard_normal((3, 9, 2, 4)).astype(
        np.float32))
    for w in (4, 9, 12):
        lens = np.array([9, 5, 2])
        got = pdec.ring_from_prefill(full, lens, w)
        want = jdec.ring_from_prefill(jnp.asarray(full.numpy()),
                                      jnp.asarray(lens), w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for r, n in enumerate(lens):
            np.testing.assert_array_equal(
                got[r:r + 1].numpy(),
                pdec._to_ring(full[r:r + 1, :n], int(n), w).numpy())


# -- generate ------------------------------------------------------------------

@pytest.mark.parametrize("form", ["full", "gqa"])
def test_greedy_generate_matches_jax(models, form):
    jm, params, pm = models[form]
    prompt = prompt_of(6)
    want = np.asarray(jdec.generate(jm, params, prompt, 14))
    got = pdec.generate(pm, prompt, 14)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 19)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p_len,steps", [(3, 14), (6, 9), (9, 10)])
def test_rolling_generate_matches_jax_and_full(models, p_len, steps):
    jm, params, pm = models["rope_window"]
    prompt = prompt_of(7, p=p_len)
    want = np.asarray(jdec.generate(jm, params, prompt, steps,
                                    rolling=True))
    got = pdec.generate(pm, prompt, steps, rolling=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, pdec.generate(pm, prompt, steps).numpy())


def test_eos_and_pad_match_jax(models):
    jm, params, pm = models["gqa"]
    prompt = prompt_of(8)
    free = np.asarray(jdec.generate(jm, params, prompt, 12))
    eos = int(free[0, 8])  # a token row 0 emits mid-continuation
    for pad in (None, (eos + 1) % V):
        want = np.asarray(jdec.generate(jm, params, prompt, 12, eos_id=eos,
                                        pad_id=pad))
        got = pdec.generate(pm, prompt, 12, eos_id=eos, pad_id=pad).numpy()
        np.testing.assert_array_equal(got, want)
        first = list(got[0, 5:]).index(eos) + 5
        assert (got[0, first + 1:] == (eos if pad is None else pad)).all()


def test_filter_logits_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((4, 3, V)).astype(np.float32)
    logits[0, 0, :4] = 2.5  # ties at the cut
    for top_k, top_p in ((1, None), (5, None), (99, None), (None, 0.3),
                         (None, 0.9), (None, 1.0), (4, 0.7), (None, 1e-9)):
        want = np.asarray(jdec._filter_logits(jnp.asarray(logits), top_k,
                                              top_p))
        got = pdec._filter_logits(torch.from_numpy(logits), top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), want)
    # closed form: nucleus at 0.6 over (0.5, 0.25, 0.15, 0.1) keeps two
    small = torch.log(torch.tensor([[0.5, 0.25, 0.15, 0.1]]))
    out = pdec._filter_logits(small, None, 0.6)
    assert torch.isfinite(out[0, :2]).all() and torch.isinf(out[0, 2:]).all()


def test_sampling_properties(models):
    """Sampled paths: one seed gives one path, top_k=1 (or a tiny nucleus)
    is greedy, only top-k tokens are drawn, and a generator and its int
    seed are the same rng."""
    _, _, pm = models["rope_window"]
    prompt = prompt_of(10)
    greedy = pdec.generate(pm, prompt, 8)
    g = torch.Generator().manual_seed(7)
    a = pdec.generate(pm, prompt, 8, temperature=1.0, rng=g)
    assert torch.equal(a, pdec.generate(pm, prompt, 8, temperature=1.0,
                                        rng=7))
    assert torch.equal(a, pdec.generate(pm, prompt, 8, temperature=1.0,
                                        rng=g, rolling=True))
    assert not torch.equal(a, pdec.generate(pm, prompt, 8, temperature=1.0,
                                            rng=8))
    for kw in (dict(top_k=1), dict(top_p=1e-9)):
        assert torch.equal(greedy, pdec.generate(
            pm, prompt, 8, temperature=2.0, rng=3, **kw))
    # every draw lies in the top 3 of its own step's logits
    out = pdec.generate(pm, prompt, 8, temperature=5.0, rng=4, top_k=3)
    logits = pm(out[:, :-1]).detach()[:, prompt.shape[1] - 1:]
    top3 = torch.topk(logits, 3, dim=-1).indices
    drawn = out[:, prompt.shape[1]:].long()
    assert (top3 == drawn[..., None]).any(-1).all()
    assert not torch.equal(out, greedy)


def test_jit_decode_step_drives_a_hand_loop(models):
    jm, params, pm = models["full"]
    prompt = np.array([[5, 3, 9]], np.int32)
    steps = 6
    want = pdec.generate(pm, prompt, steps).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jdec.generate(jm, params, prompt, steps)))
    caches = pdec.init_cache(pm, batch=1, max_len=3 + steps)
    step = pdec.jit_decode_step(pm)
    for pos in range(3):
        logits, caches = step(caches, prompt[:, pos], pos)
    toks = [int(torch.argmax(logits[0]))]
    for pos in range(3, 3 + steps - 1):
        logits, caches = step(caches, [toks[-1]], pos)
        toks.append(int(torch.argmax(logits[0])))
    np.testing.assert_array_equal(want[0, 3:], toks)
    # decode_step is the same function
    c2 = pdec.init_cache(pm, 1, 4)
    l2, _ = pdec.decode_step(pm, c2, torch.tensor([5]), 0)
    l1, _ = step(pdec.init_cache(pm, 1, 4), [5], 0)
    assert torch.equal(l1, l2)
    with pytest.raises(ValueError, match="unsupported layer"):
        pdec.jit_decode_step(Sequential([Conv2D(4, 3)], input_shape=(8, 8, 1),
                                        device="cpu"))


def test_validation_errors(models):
    _, _, pm = models["full"]
    prompt = np.zeros((1, 3), np.int32)
    cases = [
        (dict(num_steps=2, temperature=1.0), "rng"),
        (dict(num_steps=2, top_k=5), "temperature"),
        (dict(num_steps=2, temperature=1.0, rng=0, top_k=0), "top_k"),
        (dict(num_steps=2, temperature=1.0, rng=0, top_p=1.5), "top_p"),
        (dict(num_steps=4, max_len=5), "max_len"),
        (dict(num_steps=-2), "num_steps"),
        (dict(num_steps=0, max_len=2), "max_len"),
        (dict(num_steps=0, rolling=True), "rolling"),
        (dict(num_steps=2, pad_id=0), "pad_id"),
        (dict(num_steps=2, eos_id=V), "eos_id"),
        (dict(num_steps=2, eos_id=1, pad_id=V), "pad_id"),
        (dict(num_steps=40), "positional"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            pdec.generate(pm, prompt, **kw)
    np.testing.assert_array_equal(pdec.generate(pm, prompt, 0).numpy(),
                                  prompt)
    enc = Sequential([Embedding(16, 32), TransformerBlock(4, 8, 64)],
                     input_shape=(8,), compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="causal"):
        pdec.init_cache(enc, 1, 8)
    with pytest.raises(ValueError, match="single-token"):
        c = pdec.init_cache(models["rope_window"][2], 1, 12, rolling=True)
        pdec._forward(models["rope_window"][2], c,
                      torch.zeros(1, 2, dtype=torch.int32), 0, rolling=True)
    with pytest.raises(ValueError, match="ring"):
        c = pdec.init_cache(models["rope_window"][2], 1, 12, rolling=True)
        pdec._forward(models["rope_window"][2], c,
                      torch.zeros(1, 3, dtype=torch.int32), torch.tensor([0]),
                      rolling=True)
    with pytest.raises(TypeError, match="int8"):
        c = pdec.init_cache(pm, 1, 8, kv_dtype="int8")
        pdec.decode_step(pm, c, torch.tensor([1]), 0)
