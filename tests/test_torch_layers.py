"""Each layer of the port's serving slice against its JAX counterpart.

The same numpy weights (drawn from a seed, in the JAX layout) go into both
packages, the same numpy inputs go through both, and at f32 compute the
outputs agree to atol 1e-5 (only the order of f32 sums differs).  Also
checked per layer: the parameter leaf order and names (JAX pytree order,
dict keys sorted) and the config JSON, both ways.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.core import layers as jl
from distkeras_tpu.ops import rope as jrope
from distkeras_tpu_torch.core import layers as tl
from distkeras_tpu_torch.core.layers import layer_leaves
from distkeras_tpu_torch.ops import rope as trope

torch.set_num_threads(1)

ATOL = 1e-5


def jax_paths(params):
    """'/'-joined dict-key paths of a JAX params dict, in leaf order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return ["/".join(str(k.key) for k in path) for path, _ in flat]


def build_pair(jlayer, tlayer, in_shape, seed):
    """Init the JAX layer, overwrite its params with numpy draws, load the
    same arrays into the port layer; returns the JAX params."""
    params, _ = jlayer.init(jax.random.PRNGKey(0), in_shape)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    arrays = [(0.3 * rng.standard_normal(np.shape(l))
               + (1.0 if np.ndim(l) == 1 else 0.0)).astype(np.float32)
              for l in leaves]
    params = jax.tree_util.tree_unflatten(treedef,
                                          [jnp.asarray(a) for a in arrays])
    tlayer.build(in_shape, torch.Generator().manual_seed(0), "cpu")
    port = list(layer_leaves(tlayer))
    assert [p for p, _ in port] == jax_paths(params)
    with torch.no_grad():
        for (_, p), a in zip(port, arrays):
            assert tuple(p.shape) == a.shape
            p.copy_(torch.from_numpy(a))
    return params


def run_both(jlayer, tlayer, params, x, dtype="float32"):
    jdt = jnp.dtype(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jlayer.apply(params, jnp.asarray(x), compute_dtype=jdt)
    with torch.inference_mode():
        got = tlayer(torch.from_numpy(x), tdt)
    return np.asarray(want.astype(jnp.float32)), got.to(torch.float32).numpy()


def assert_same_config(jlayer, tlayer):
    jcfg = jlayer.get_config()
    assert json.dumps(tlayer.get_config()) == json.dumps(jcfg)
    # a JAX config (defaults omitted) rebuilds the same port layer
    back = tl.Layer.from_config(json.loads(json.dumps(jcfg)))
    assert type(back) is type(tlayer)
    assert json.dumps(back.get_config()) == json.dumps(jcfg)


def features(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kw", [dict(units=12, activation="relu"),
                                dict(units=7, use_bias=False,
                                     activation="gelu"),
                                dict(units=5, activation="softmax")])
def test_dense(kw):
    j, t = jl.Dense(**kw), tl.Dense(**kw)
    params = build_pair(j, t, (16,), 1)
    want, got = run_both(j, t, params, features(2, (5, 16)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_same_config(j, t)


def test_dense_bf16_keeps_f32_matmul_output():
    """bf16 operands, f32 product: the JAX dot_general's
    preferred_element_type=f32.  A bf16 matmul output would be off by a
    bf16 ulp (~4e-3 relative); here only the f32 sum order differs."""
    j, t = jl.Dense(32), tl.Dense(32)
    params = build_pair(j, t, (64,), 3)
    x = features(4, (6, 64))
    want, got = run_both(j, t, params, x, dtype="bfloat16")
    with torch.inference_mode():
        assert t(torch.from_numpy(x), torch.bfloat16).dtype == torch.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_embedding():
    j, t = jl.Embedding(50, 16), tl.Embedding(50, 16)
    params = build_pair(j, t, (10,), 5)
    ids = np.random.default_rng(6).integers(0, 50, (3, 10)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        want, got = run_both(j, t, params, ids, dtype)
        np.testing.assert_array_equal(got, want)
    assert_same_config(j, t)


def test_positional_embedding():
    j, t = jl.PositionalEmbedding(20), tl.PositionalEmbedding(20)
    params = build_pair(j, t, (10, 16), 7)
    want, got = run_both(j, t, params, features(8, (2, 10, 16)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_same_config(j, t)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tl.PositionalEmbedding(4).build((10, 16), torch.Generator(), "cpu")


def test_layer_normalization():
    j, t = jl.LayerNormalization(), tl.LayerNormalization()
    params = build_pair(j, t, (10, 16), 9)
    x = 3.0 + 2.0 * features(10, (2, 10, 16))
    want, got = run_both(j, t, params, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_same_config(j, t)


MHA_CASES = {
    "mha": dict(num_heads=4, key_dim=8),
    "gqa_causal": dict(num_heads=4, key_dim=8, causal=True, num_kv_heads=2),
    "rope": dict(num_heads=2, key_dim=8, causal=True, rope=True,
                 rope_theta=500.0, rope_scale=2.0),
    "window_mqa": dict(num_heads=4, key_dim=4, causal=True, num_kv_heads=1,
                       attention_window=3),
    "no_bias": dict(num_heads=2, key_dim=8, causal=True, use_bias=False),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_multi_head_attention(case):
    kw = MHA_CASES[case]
    j, t = jl.MultiHeadAttention(**kw), tl.MultiHeadAttention(**kw)
    params = build_pair(j, t, (12, 16), 11)
    want, got = run_both(j, t, params, features(12, (2, 12, 16)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_same_config(j, t)


BLOCK_CASES = {
    "learned": dict(num_heads=4, key_dim=8, mlp_dim=24, causal=True),
    "gqa_rope_window": dict(num_heads=4, key_dim=8, mlp_dim=24, causal=True,
                            num_kv_heads=2, rope=True, attention_window=5),
    "relu_noncausal": dict(num_heads=2, key_dim=16, mlp_dim=8,
                           activation="relu"),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_transformer_block(case):
    kw = BLOCK_CASES[case]
    j, t = jl.TransformerBlock(**kw), tl.TransformerBlock(**kw)
    params = build_pair(j, t, (12, 32), 13)
    want, got = run_both(j, t, params, features(14, (2, 12, 32)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert_same_config(j, t)


def test_layer_validation_matches():
    for kw in (dict(num_heads=4, key_dim=8, num_kv_heads=3),
               dict(num_heads=2, key_dim=8, attention_window=4),
               dict(num_heads=2, key_dim=7, causal=True, rope=True),
               dict(num_heads=2, key_dim=8, rope_theta=5.0)):
        with pytest.raises(ValueError):
            jl.MultiHeadAttention(**kw)
        with pytest.raises(ValueError):
            tl.MultiHeadAttention(**kw)
    # every layer kind of the JAX package is ported; a kind that neither
    # package has is still refused, naming the ported kinds
    assert set(tl.Layer._REGISTRY) == set(jl.Layer._REGISTRY)
    with pytest.raises(ValueError, match="not ported"):
        tl.Layer.from_config({"kind": "LSTM", "units": 3})


@pytest.mark.parametrize("theta,scale,offset", [(10000.0, 1.0, 0),
                                                (500.0, 4.0, 37)])
def test_apply_rope(theta, scale, offset):
    x = features(15, (2, 10, 3, 8))
    pos = np.arange(10) + offset
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, scale)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    ang_j = jrope.rope_angles(jnp.asarray(pos), 8, theta, scale)
    ang_t = trope.rope_angles(torch.from_numpy(pos), 8, theta, scale)
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), rtol=1e-6)
    bf = trope.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(pos), theta, scale)
    assert bf.dtype == torch.bfloat16


def test_rope_helpers_match():
    assert trope.ntk_theta(4.0, 64) == jrope.ntk_theta(4.0, 64)
    assert trope.validate_rope_scaling(500, 2) == \
        jrope.validate_rope_scaling(500, 2)
    for bad in ((0.0, 1.0), (1.0, 0.5)):
        with pytest.raises(ValueError):
            trope.validate_rope_scaling(*bad)
    with pytest.raises(ValueError):
        trope.validate_rope_dim(5)
    # the per-row (B, S) positions form, one row per request
    x = np.random.default_rng(2).standard_normal((2, 3, 1, 4)).astype(
        np.float32)
    pos = np.array([[0, 1, 2], [7, 8, 9]])
    np.testing.assert_allclose(
        trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-6)
