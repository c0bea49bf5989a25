"""The port's ConvNet layers against the JAX package's, one layer at a
time: Conv2D, MaxPooling2D, AveragePooling2D, GlobalAveragePooling2D,
Flatten, Reshape, Activation and BatchNormalization.

Each layer sits alone in a ``Sequential`` on both sides, with the same
numpy-drawn weights (through ``get_weights``/``load_jax_weights``) and the
same numpy inputs; the loss is ``sum(y * G)`` with a random G, so the
output's cotangent is random.  At f32 the outputs and the gradients of the
input and of every parameter agree within rtol/atol 1e-5 (both compute in
f32 and differ only in the order of sums).  At bf16 the convolution's
forward is the f32 product of bf16-rounded operands on both sides, and its
backward runs in bf16 on both sides (``_conv_f32_acc``'s contract): the
outputs agree within 1e-5 of their largest value and the gradients within
one bf16 ulp (2**-8) of their largest value.  Measured on this suite's
cases: forward 0, input and kernel gradients 0, bias gradients (f32 sums)
up to 3.4e-7 of their largest value.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.core.layers import _nchw, _window_pads, layer_leaves
from distkeras_tpu_torch.core.model import (Sequential, jax_leaves,
                                            load_jax_weights)

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_OUT_OF_MAX = 1e-5
BF16_GRAD_OF_MAX = 2.0 ** -8
IMAGE = (9, 10, 3)  # odd and even sides: SAME pads both ways


def draw_weights(weights, rng):
    """Random weights of the given shapes; BatchNorm variances positive."""
    return [(rng.standard_normal(w.shape) * 0.5
             + (1.5 if np.all(w == 1.0) else 0.0)).astype(np.float32)
            for w in weights]


def run_pair(jax_layer, port_layer, in_shape, dtype="float32", train=False,
             seed=0, batch=2):
    """Outputs and gradients (input first, then every trained leaf in JAX
    leaf order) of one layer on both sides, as numpy f32 arrays."""
    jm = JaxSequential([jax_layer], input_shape=in_shape,
                       compute_dtype=dtype)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    weights = draw_weights(jm.get_weights(params), rng)
    params = jm.set_weights(params, weights)
    pm = Sequential([port_layer], input_shape=in_shape, compute_dtype=dtype,
                    device="cpu")
    load_jax_weights(pm, weights)
    x = rng.standard_normal((batch,) + tuple(in_shape)).astype(np.float32)
    jy = np.asarray(jm.apply(params, x, train=train), np.float32)
    g = rng.standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = jax.grad(
        lambda p, a: jnp.sum(jm.apply(p, a, train=train).astype(jnp.float32)
                             * g), argnums=(0, 1))(params, x)
    trained = [path for path, t in jax_leaves(pm) if t.requires_grad]
    want_grads = [np.asarray(jgx)] + [
        np.asarray(a) for (path, _), a in zip(
            jax_leaves(pm), jax.tree_util.tree_leaves(jgp))
        if path in trained]
    tx = torch.from_numpy(x).requires_grad_()
    leaves = dict(jax_leaves(pm))
    py = pm(tx, train=train)
    got_grads = torch.autograd.grad(
        (py.to(torch.float32) * torch.from_numpy(g)).sum(),
        [tx] + [leaves[p] for p in trained])
    return ((py.detach().to(torch.float32).numpy(), jy),
            [(a.to(torch.float32).numpy(), b)
             for a, b in zip(got_grads, want_grads)])


def assert_pair(outputs, grads, dtype):
    got, want = outputs
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        for a, b in grads:
            np.testing.assert_allclose(a, b, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_OUT_OF_MAX * np.abs(want).max())
        for a, b in grads:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=BF16_GRAD_OF_MAX * np.abs(b).max())


CONV_CASES = list(itertools.product(["SAME", "VALID"], [1, 2], [3, 4],
                                   [True, False]))


@pytest.mark.parametrize("padding,stride,kernel,use_bias", CONV_CASES)
def test_conv2d_matches_jax_f32(padding, stride, kernel, use_bias):
    outputs, grads = run_pair(
        jl.Conv2D(5, kernel, stride, padding, use_bias=use_bias),
        pl.Conv2D(5, kernel, stride, padding, use_bias=use_bias), IMAGE,
        seed=stride * 10 + kernel)
    assert len(grads) == (3 if use_bias else 2)
    assert_pair(outputs, grads, "float32")


@pytest.mark.parametrize("padding,stride,kernel", [
    ("SAME", 1, 3), ("SAME", 2, 4), ("VALID", 2, 3), ("VALID", 1, 4)])
def test_conv2d_matches_jax_bf16(padding, stride, kernel):
    """bf16: the f32-accumulated forward and the bf16 backward of
    ``_conv_f32_acc`` on both sides."""
    outputs, grads = run_pair(jl.Conv2D(5, kernel, stride, padding),
                              pl.Conv2D(5, kernel, stride, padding), IMAGE,
                              dtype="bfloat16", seed=kernel)
    assert_pair(outputs, grads, "bfloat16")


def test_conv2d_forward_is_f32_and_backward_in_compute_dtype():
    """The forward output is f32 from bf16 operands; the backward hands
    the kernel a gradient taken from bf16 convolutions: it equals the
    same-dtype convolution of the cotangent rounded once to bf16."""
    layer = pl.Conv2D(4, 3)
    model = Sequential([layer], input_shape=(6, 6, 2),
                       compute_dtype="bfloat16", device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 2)).astype(
        np.float32))
    y = model(x)
    assert y.dtype == torch.float32
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32))
    (dk,) = torch.autograd.grad((y * g).sum(), [layer.kernel])
    want = torch.nn.grad.conv2d_weight(
        x.to(torch.bfloat16).permute(0, 3, 1, 2),
        (4, 2, 3, 3), g.to(torch.bfloat16).permute(0, 3, 1, 2),
        padding=1).permute(2, 3, 1, 0).to(torch.float32)
    torch.testing.assert_close(dk, want, atol=0, rtol=0)


@pytest.mark.parametrize("kind,padding,pool,stride", [
    (kind, padding, pool, stride) for kind in ("Max", "Average")
    for padding in ("SAME", "VALID") for pool, stride in ((2, None), (3, 2))])
def test_pooling_matches_jax(kind, padding, pool, stride):
    """Max pools pad SAME with -inf, average pools with zeros and divide
    by the full window, as the JAX layers' ``reduce_window`` does."""
    name = f"{kind}Pooling2D"
    outputs, grads = run_pair(getattr(jl, name)(pool, stride, padding),
                              getattr(pl, name)(pool, stride, padding),
                              IMAGE, seed=pool)
    assert_pair(outputs, grads, "float32")


@pytest.mark.parametrize("name,args,in_shape", [
    ("GlobalAveragePooling2D", (), IMAGE),
    ("Flatten", (), IMAGE),
    ("Reshape", ((5, 18, 3),), IMAGE),
    ("Activation", ("relu",), IMAGE),
    ("Activation", ("softmax",), (7,)),
    ("Activation", ("tanh",), (7,)),
])
def test_shape_and_activation_layers_match_jax(name, args, in_shape):
    outputs, grads = run_pair(getattr(jl, name)(*args),
                              getattr(pl, name)(*args), in_shape)
    assert_pair(outputs, grads, "float32")


def test_flatten_keeps_the_nhwc_feature_order():
    """The Dense after a Flatten reads NHWC features: channel fastest."""
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    flat = pl.Flatten()(x)
    assert flat.shape == (2, 60)
    torch.testing.assert_close(flat[0, :5], x[0, 0, 0, :])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_jax(train, dtype):
    """Eval mode normalizes with the running statistics, train mode with
    the batch's (biased variance), in f32, cast back to the input dtype
    (f32 here: the layer sees the f32 input)."""
    outputs, grads = run_pair(jl.BatchNormalization(),
                              pl.BatchNormalization(), (5, 6, 4),
                              dtype=dtype, train=train, batch=3)
    assert len(grads) == 3  # the input, offset and scale; never the stats
    assert_pair(outputs, grads, "float32")


def test_batchnorm_apply_with_stats_matches_jax():
    """The train forward's EMA of the running statistics, Keras's
    momentum * moving + (1 - momentum) * batch, and the statistics'
    place in the JAX leaf order (offset, scale, stats/mean, stats/var)."""
    jlayer, player = jl.BatchNormalization(0.9, 1e-3), pl.BatchNormalization(
        0.9, 1e-3)
    params, _ = jlayer.init(jax.random.PRNGKey(0), (4, 4, 3))
    rng = np.random.default_rng(5)
    weights = draw_weights(jax.tree_util.tree_leaves(params), rng)
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), weights)
    player.build((4, 4, 3), torch.Generator(), "cpu")
    leaves = list(layer_leaves(player))
    assert [p for p, _ in leaves] == ["offset", "scale", "stats/mean",
                                      "stats/var"]
    assert [t.requires_grad for _, t in leaves] == [True, True, False,
                                                    False]
    with torch.no_grad():
        for (_, t), w in zip(leaves, weights):
            t.copy_(torch.from_numpy(w))
    x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    jy, jstats = jlayer.apply_with_stats(params, x)
    py, pstats = player.apply_with_stats(torch.from_numpy(x))
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               **F32_TOL)
    assert sorted(pstats) == ["mean", "var"]
    for name in ("mean", "var"):
        assert not pstats[name].requires_grad
        np.testing.assert_allclose(pstats[name].numpy(),
                                   np.asarray(jstats[name]), **F32_TOL)


@pytest.mark.parametrize("name,args", [
    ("Conv2D", (8, (3, 2), 2, "same", "relu", False, "glorot_uniform")),
    ("MaxPooling2D", (3, 2, "same")),
    ("AveragePooling2D", (2,)),
    ("GlobalAveragePooling2D", ()),
    ("Flatten", ()),
    ("Reshape", ((2, 3),)),
    ("Activation", ("gelu",)),
    ("BatchNormalization", (0.9, 1e-4)),
])
def test_layer_config_json_equals_jax_and_round_trips(name, args):
    """The same config JSON as the JAX layer, and back through
    ``from_config`` to an equal config."""
    import json
    port = getattr(pl, name)(*args)
    assert json.dumps(port.get_config()) == json.dumps(
        getattr(jl, name)(*args).get_config())
    back = pl.Layer.from_config(json.loads(json.dumps(port.get_config())))
    assert type(back) is type(port)
    assert back.get_config() == port.get_config()


def test_same_padding_puts_the_odd_row_at_the_end():
    """XLA's SAME: an even kernel, or a stride that does not divide the
    side, pads one more row and column after than before."""
    assert _window_pads((9, 10), (3, 3), (1, 1), "SAME") == (1, 1, 1, 1)
    assert _window_pads((9, 10), (4, 4), (1, 1), "SAME") == (1, 2, 1, 2)
    assert _window_pads((9, 10), (3, 3), (2, 2), "SAME") == (1, 1, 0, 1)
    assert _window_pads((9, 10), (3, 3), (2, 2), "VALID") == (0, 0, 0, 0)
    with pytest.raises(ValueError, match="SAME"):
        _window_pads((9, 10), (3, 3), (1, 1), "FULL")


def test_nhwc_activations_reach_the_convolution_as_channels_last():
    """An NHWC-contiguous activation is an NCHW view in channels_last
    memory: cuDNN gets NHWC without a layout copy."""
    x = torch.randn(2, 9, 10, 3)
    view = _nchw(x, (0, 0, 0, 0), 0.0)
    assert view.shape == (2, 3, 9, 10)
    assert view.is_contiguous(memory_format=torch.channels_last)
    assert view.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("dtype,allowed", [(torch.bfloat16, True),
                                           (torch.float16, True),
                                           (torch.float32, False)])
def test_convolutions_set_cudnn_tf32_by_operand_dtype(dtype, allowed,
                                                      monkeypatch):
    """TF32 products are exact for 16-bit-rounded operands and would round
    f32 ones, so a convolution sets cuDNN's switch from its operands'
    dtype, forward and backward, and restores the caller's setting."""
    seen = []
    real_conv = torch.nn.functional.conv2d

    def conv(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_conv(*args, **kwargs)
    monkeypatch.setattr(torch.nn.functional, "conv2d", conv)
    real_weight = torch.nn.grad.conv2d_weight

    def weight(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_weight(*args, **kwargs)
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", weight)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not allowed)
    layer = pl.Conv2D(3, 3)
    model = Sequential([layer], input_shape=(5, 5, 2),
                       compute_dtype=str(dtype).split(".")[-1],
                       device="cpu")
    x = torch.randn(2, 5, 5, 2, dtype=torch.float32)
    torch.autograd.grad(model(x).sum(), [layer.kernel])
    assert seen and all(flag == allowed for flag in seen)
    assert torch.backends.cudnn.allow_tf32 == (not allowed)
