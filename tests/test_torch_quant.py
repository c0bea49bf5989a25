"""The port's int8 quantization (``core/quant.py``) against the JAX
package's.

Weight codes and scales, and KV codes and scales, are bit-identical to
JAX's from the same numpy arrays (both round ``w / scale`` computed in f32
half to even); a quantized model's leaves come out in JAX's order and
equal JAX's ``quantize_params`` leaf for leaf; the byte counts are equal;
quantized greedy ``generate`` gives JAX's quantized tokens; a quantized
model refuses to serialize, and quantizing twice changes nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.core import decode as jdec
from distkeras_tpu.core import quant as jq
from distkeras_tpu.core.layers import Conv2D as JConv2D
from distkeras_tpu.core.layers import Dense as JDense
from distkeras_tpu.core.layers import Flatten as JFlatten
from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu_torch import (Conv2D, Dense, FittedModel, Flatten,
                                 Sequential, transformer_lm)
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.core import quant as pq

torch.set_num_threads(1)

LM = dict(vocab_size=32, seq_len=32, d_model=32, num_heads=4, num_kv_heads=2,
          num_layers=2, mlp_dim=64, compute_dtype="float32")


def numpy_weights(weights, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
             if w.ndim >= 2 else 0.1 * rng.standard_normal(w.shape)
             + (w == 1.0)).astype(np.float32) for w in weights]


@pytest.fixture(scope="module")
def lm_pair():
    jm = jax_lm(**LM)
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm.get_weights(params), 1)
    pm = transformer_lm(**LM, device="cpu")
    pm.set_weights(weights)
    return JaxFitted(jm, jm.set_weights(params, weights)), FittedModel(pm)


def test_weight_codes_and_scales_bit_identical():
    rng = np.random.default_rng(0)
    shapes = [(64, 32), (3, 3, 4, 8), (5, 7)]
    for i, shape in enumerate(shapes):
        w = (rng.standard_normal(shape) * np.exp(rng.standard_normal(
            shape[-1:]))).astype(np.float32)
        if i == 2:
            w[:, 3] = 0.0                       # a zero channel: scale 1
            w[0, 0] = 0.0
        want = jq.quantize_tensor(jnp.asarray(w))
        got = pq.quantize_tensor(torch.from_numpy(w))
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        assert tuple(got.shape) == shape and got.ndim == len(shape)
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            np.testing.assert_array_equal(
                got.astype(dtype).to(torch.float32).numpy(),
                np.asarray(want.astype(jdtype), np.float32))
    # halves round to even, as jnp.round
    w = np.array([[0.5, 1.5, 2.5, -0.5], [127.0, 127.0, 127.0, 127.0]],
                 np.float32)
    np.testing.assert_array_equal(
        pq.quantize_tensor(torch.from_numpy(w)).q.numpy(),
        np.asarray(jq.quantize_tensor(jnp.asarray(w)).q))


def test_kv_codes_and_scales_bit_identical():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    x[0, 1] = 0.0                               # never-written entries
    want_q, want_s = jq.quantize_kv(jnp.asarray(x))
    got_q, got_s = pq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_s[0, 1] == 0).all()
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            pq.dequantize_kv(got_q, got_s, dtype).to(torch.float32).numpy(),
            np.asarray(jq.dequantize_kv(want_q, want_s, jdtype), np.float32))
    assert (pq.dequantize_kv(got_q, got_s, torch.float32)[0, 1] == 0).all()


def test_quantized_leaves_and_bytes_match_jax(lm_pair):
    jfit, pfit = lm_pair
    jq_fit, pq_fit = jfit.quantize(), pfit.quantize()
    want = jq_fit.get_weights()
    got = pq_fit.get_weights()
    assert len(got) == len(want) > len(pfit.get_weights())
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert pq.quantized_bytes(pq_fit.model) == jq.quantized_bytes(
        jq_fit.params)
    assert pq.quantized_bytes(pfit.model) == jq.quantized_bytes(jfit.params)
    assert pq_fit.count_params() == jq_fit.count_params() \
        == pfit.count_params() == jfit.count_params()
    # the original stays full precision
    assert not pq.is_quantized(pfit.model) and pq.is_quantized(pq_fit.model)
    # dequantize_params gives JAX's dequantized leaves
    back = pq.dequantize_params(pq_fit.model)
    jback = jq.dequantize_params(jq_fit.params)
    for a, b in zip(FittedModel(back).get_weights(),
                    jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_quantized_generate_matches_jax(lm_pair):
    jfit, pfit = lm_pair
    jq_fit, pq_fit = jfit.quantize(), pfit.quantize()
    prompt = np.random.default_rng(3).integers(0, 32, (2, 6)).astype(np.int32)
    want = np.asarray(jq_fit.generate(prompt, 16))
    got = pq_fit.generate(prompt, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # the quantized forward is JAX's quantized forward
    np.testing.assert_allclose(
        pq_fit.predict(got.numpy()), jq_fit.predict(np.asarray(got)),
        atol=2e-5)


def test_kv_cache_bytes_match_jax(lm_pair):
    jfit, pfit = lm_pair
    for kw in (dict(), dict(kv_dtype="int8"), dict(rolling=False,
                                                   kv_dtype="int8")):
        jc = jdec.init_cache(jfit.model, 4, 32, **kw)
        pc = pdec.init_cache(pfit.model, 4, 32, **kw)
        assert pq.kv_cache_bytes(pc) == jq.kv_cache_bytes(jc)
        for bs in (1, 16):
            assert pq.kv_block_bytes(pc, bs) == jq.kv_block_bytes(jc, bs)
    fp = pdec.init_cache(pfit.model, 4, 32)
    q8 = pdec.init_cache(pfit.model, 4, 32, kv_dtype="int8")
    assert pq.kv_cache_bytes(fp) >= 1.5 * pq.kv_cache_bytes(q8)


def test_conv_and_dense_models_quantize_as_jax():
    """Conv2D and Dense kernels are the matmul sites outside the LM: the
    quantized forward reads them through the same accessor."""
    def stack(m):
        return [m.Conv2D(4, 3), m.Flatten(), m.Dense(5)]

    class J:
        Conv2D, Flatten, Dense = JConv2D, JFlatten, JDense

    class P:
        Conv2D, Flatten, Dense = Conv2D, Flatten, Dense

    jm = JaxSequential(stack(J), input_shape=(6, 6, 2),
                       compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm.get_weights(params), 4)
    pm = Sequential(stack(P), input_shape=(6, 6, 2), compute_dtype="float32",
                    device="cpu")
    pm.set_weights(weights)
    jfit = JaxFitted(jm, jm.set_weights(params, weights)).quantize()
    pfit = FittedModel(pm).quantize()
    x = np.random.default_rng(5).standard_normal((3, 6, 6, 2)).astype(
        np.float32)
    np.testing.assert_allclose(pfit.predict(x), jfit.predict(x), atol=1e-5)
    assert isinstance(pfit.model.layers[0].kernel, pq.QuantizedTensor)
    assert not isinstance(pfit.model.layers[0].bias, pq.QuantizedTensor)


def test_serialize_refuses_and_quantize_is_idempotent(lm_pair):
    _, pfit = lm_pair
    qfit = pfit.quantize()
    with pytest.raises(ValueError, match="quantize"):
        qfit.serialize()
    again = qfit.quantize()
    for a, b in zip(again.get_weights(), qfit.get_weights()):
        np.testing.assert_array_equal(a, b)
    assert again.count_params() == pfit.count_params()
    pfit.serialize()  # the unquantized model still serializes
