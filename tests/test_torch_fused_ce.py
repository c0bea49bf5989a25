"""The port's fused softmax cross-entropy against the JAX package.

The plain versions of the port's two kernels (``ops/fused_ce.py``) are held
against the JAX Pallas kernels run in interpret mode outside ``shard_map``,
as tests/test_fused_ce.py runs them on the CPU: the value over that file's
shape list, the gradient under a weighted cotangent, bf16 and f16 logits,
extreme logits, one vocab block, labels outside [0, V) and int64 labels.
Losses at the JAX test's rtol/atol 1e-5, gradients at rtol 1e-4/atol 1e-5,
half-precision gradients within one rounding of their dtype.  The kernels
themselves run only on the card (``chip_smoke.py``); here the CUDA
wrappers are driven with fake tensors and a recording launcher.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distkeras_tpu.ops.fused_ce import _fwd_call
from distkeras_tpu.ops.fused_ce import fused_softmax_cross_entropy as jax_ce
from distkeras_tpu_torch import kernels

ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")

torch.set_num_threads(1)

ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}


def rand(t, v, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(t, v)) * scale).astype(np.float32)
    labels = rng.integers(0, v, size=(t,)).astype(np.int32)
    return logits, labels


def jax_fwd(logits, labels, block_t, block_v):
    """The JAX forward kernel's (loss, lse) in interpret mode."""
    loss, lse = _fwd_call(jnp.asarray(logits), jnp.asarray(labels), block_t,
                          block_v, True)
    return np.asarray(loss), np.asarray(lse)


def port_ce(logits, labels, **kw):
    return ce.fused_softmax_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels), **kw)


@pytest.mark.parametrize("t,v", [(8, 16), (256, 512), (300, 1000),
                                 (7, 130), (64, 50257 % 2048)])
def test_value_and_lse_match_the_pallas_kernel(t, v):
    logits, labels = rand(t, v, seed=t + v)
    want_loss, want_lse = jax_fwd(logits, labels, 64, 128)
    loss, lse = ce.fused_ce_fwd(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    assert loss.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port_ce(logits, labels).numpy(), want_loss,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,v", [(32, 64), (100, 300)])
def test_weighted_gradient_matches_the_pallas_kernel(t, v):
    logits, labels = rand(t, v, seed=3)
    w = np.random.default_rng(1).normal(size=(t,)).astype(np.float32)
    want = jax.grad(lambda lg: jnp.sum(jnp.asarray(w) * jax_ce(
        lg, jnp.asarray(labels), block_t=32, block_v=64, interpret=True)))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = ce.fused_softmax_cross_entropy(x, torch.from_numpy(labels),
                                          block_t=32, block_v=64)
    (g,) = torch.autograd.grad((loss * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_logits_loss_f32_and_gradient_in_their_dtype(dtype):
    logits, labels = rand(64, 128, seed=5)
    jl = jnp.asarray(logits, JAX_DTYPE[dtype])
    want_loss = jax_ce(jl, jnp.asarray(labels), interpret=True)
    want_grad = jax.grad(lambda lg: jnp.sum(jax_ce(
        lg, jnp.asarray(labels), interpret=True)))(jl)
    assert want_grad.dtype == JAX_DTYPE[dtype]
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    loss = ce.fused_softmax_cross_entropy(x, torch.from_numpy(labels))
    assert loss.dtype == torch.float32
    (g,) = torch.autograd.grad(loss.sum(), x)
    assert g.dtype == dtype
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-5)
    # both compute in f32 and round once to the dtype: one ulp apart at most
    np.testing.assert_allclose(g.float().numpy(),
                               np.asarray(want_grad, np.float32),
                               rtol=ULP[dtype], atol=1e-6)


def test_extreme_logits_are_stable():
    logits = np.array([[1e4, 0.0, -1e4, 5.0] * 32] * 8, np.float32)
    labels = np.zeros(8, np.int32)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), block_v=32,
                  interpret=True)
    x = torch.from_numpy(logits).requires_grad_()
    loss = ce.fused_softmax_cross_entropy(x, torch.from_numpy(labels),
                                          block_v=32)
    (g,) = torch.autograd.grad(loss.sum(), x)
    assert torch.isfinite(loss).all() and torch.isfinite(g).all()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_one_vocab_block():
    logits, labels = rand(16, 32, seed=9)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), interpret=True)
    np.testing.assert_allclose(port_ce(logits, labels).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_out_of_range_labels_pick_nothing():
    """A label outside [0, V) adds nothing (loss = lse) and marks no
    column of the gradient, as the Pallas kernel's one-hot sum does.  (The
    Pallas kernel differs for a label in the padding of its last vocab
    tile, [V, ceil(V / block_v) * block_v): it picks its own -inf mask
    there and returns inf, which depends on block_v; the port takes no
    tile size and gives lse for every label outside [0, V), see the next
    test.)"""
    t, v = 12, 40
    logits, labels = rand(t, v, seed=13)
    labels[:4] = [-1, 48, 1000, -100]  # past the last 16-wide tile too
    w = np.linspace(0.5, 1.5, t).astype(np.float32)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    want = jax_ce(jl, jlab, block_v=16, interpret=True)
    want_grad = jax.grad(lambda lg: jnp.sum(jnp.asarray(w) * jax_ce(
        lg, jlab, block_v=16, interpret=True)))(jl)
    x = torch.from_numpy(logits).requires_grad_()
    loss, lse = ce.fused_ce_fwd(x.detach(), torch.from_numpy(labels))
    np.testing.assert_allclose(loss[:4].numpy(), lse[:4].numpy(), rtol=0,
                               atol=0)
    got = ce.fused_softmax_cross_entropy(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_grad), rtol=1e-4,
                               atol=1e-5)
    assert (g[:4] > 0).all()  # no -1 anywhere in those rows


def test_labels_past_the_vocab_give_the_lse_whatever_the_tile():
    logits, labels = rand(6, 40, seed=15)
    labels[:] = [40, 41, 47, 63, 64, 2 ** 31 - 1]
    x = torch.from_numpy(logits)
    loss, lse = ce.fused_ce_fwd(x, torch.from_numpy(labels))
    torch.testing.assert_close(loss, lse, rtol=0, atol=0)
    torch.testing.assert_close(lse, torch.logsumexp(x, -1), rtol=1e-6,
                               atol=1e-6)
    p = torch.softmax(x, -1)
    got = ce.fused_ce_bwd(x, torch.from_numpy(labels), lse, torch.ones(6))
    torch.testing.assert_close(got, p, rtol=1e-6, atol=1e-7)


def test_int64_labels_are_taken_as_int32():
    logits, labels = rand(20, 50, seed=17)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), interpret=True)
    as64 = ce.fused_softmax_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels).long())
    torch.testing.assert_close(as64, port_ce(logits, labels), rtol=0, atol=0)
    np.testing.assert_allclose(as64.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("block_t,block_v", [(1, 1), (1024, 4096)])
def test_tile_sizes_change_no_result(block_t, block_v):
    logits, labels = rand(24, 70, seed=21)
    torch.testing.assert_close(
        port_ce(logits, labels, block_t=block_t, block_v=block_v),
        port_ce(logits, labels), rtol=0, atol=0)


def test_function_gradient_equals_autograd_of_log_softmax():
    logits, labels = rand(30, 90, seed=23)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=30)
                         .astype(np.float32))
    grads = []
    for fn in (lambda x: ce.fused_softmax_cross_entropy(
                   x, torch.from_numpy(labels)),
               lambda x: -torch.log_softmax(x, -1).gather(
                   1, torch.from_numpy(labels).long()[:, None])[:, 0]):
        x = torch.from_numpy(logits).requires_grad_()
        grads.append(torch.autograd.grad((fn(x) * w).sum(), x)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)


def test_function_gradcheck():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(6, 11, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    labels = torch.tensor([0, 3, 10, -1, 11, 5])
    assert torch.autograd.gradcheck(
        lambda a: ce.FusedCrossEntropyFunction.apply(a, ce.as_labels(labels)),
        (x,))


# ---------------------------------------------------------------------------
# the CUDA wrappers, with fake tensors and a recording launcher
# ---------------------------------------------------------------------------

@pytest.fixture()
def launcher(monkeypatch):
    """Record the C launches instead of making them."""
    calls = []

    def launch(name, ptrs, logits):
        calls.append((name, len(ptrs), tuple(logits.shape), logits.dtype))
    monkeypatch.setattr(ce, "_launch", launch)
    for fn in (ce.fused_ce_fwd, ce.fused_ce_bwd):
        monkeypatch.setattr(fn, "launches", 0)
    with warnings.catch_warnings():  # a fake tensor's data_ptr warns
        warnings.simplefilter("ignore", UserWarning)
        yield calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_tensors_launch_each_kernel_once(launcher, dtype):
    """On CUDA tensors the forward and the backward launch their kernels,
    each counted once, with int64 labels converted to int32; nothing runs
    the plain version."""
    with FakeTensorMode():
        logits = torch.empty(64, 1000, dtype=dtype, device="cuda")
        labels = torch.zeros(64, dtype=torch.int64, device="cuda")
        loss, lse = ce.fused_ce_fwd(logits, labels)
        assert loss.shape == lse.shape == (64,)
        assert loss.dtype == lse.dtype == torch.float32 and loss.is_cuda
        dlogits = ce.fused_ce_bwd(logits, labels, lse, torch.ones_like(lse))
        assert dlogits.shape == logits.shape and dlogits.dtype == dtype
        assert dlogits.is_cuda
        ce.fused_softmax_cross_entropy(logits, labels)  # no grad: forward
    assert launcher == [("fused_ce_fwd", 4, (64, 1000), dtype),
                        ("fused_ce_bwd", 5, (64, 1000), dtype),
                        ("fused_ce_fwd", 4, (64, 1000), dtype)]
    assert ce.fused_ce_fwd.launches == 2 and ce.fused_ce_bwd.launches == 1


@pytest.mark.parametrize("bad,error", [
    ("f64_logits", TypeError), ("int_logits", TypeError),
    ("1d_logits", ValueError), ("labels_length", ValueError),
    ("noncontiguous_logits", ValueError), ("labels_on_cpu", ValueError),
    ("lse_dtype", ValueError), ("ct_shape", ValueError)])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(launcher, bad,
                                                           error):
    with FakeTensorMode():
        cuda = dict(device="cuda")
        logits = torch.empty(32, 48, **cuda)
        labels = torch.zeros(32, dtype=torch.int32, **cuda)
        lse = ct = torch.empty(32, **cuda)
        if bad == "f64_logits":
            logits = logits.double()
        elif bad == "int_logits":
            logits = logits.int()
        elif bad == "1d_logits":
            logits = torch.empty(48, **cuda)
        elif bad == "labels_length":
            labels = torch.zeros(31, dtype=torch.int32, **cuda)
        elif bad == "noncontiguous_logits":
            logits = torch.empty(48, 32, **cuda).t()
        elif bad == "lse_dtype":
            lse = lse.half()
        elif bad == "ct_shape":
            ct = torch.empty(32, 1, **cuda)
    if bad == "labels_on_cpu":
        labels = torch.zeros(32, dtype=torch.int32)
    with FakeTensorMode(allow_non_fake_inputs=True):
        with pytest.raises(error):
            if bad in ("lse_dtype", "ct_shape"):
                ce.fused_ce_bwd(logits, labels, lse, ct)
            else:
                ce.fused_ce_fwd(logits, labels)
    assert launcher == []


def test_fused_ce_source_is_built_for_sm90a_without_compiling():
    assert "fused_ce" in kernels.KERNELS
    src = kernels.source_path("fused_ce")
    text = src.read_text()
    for entry in ("fused_ce_fwd", "fused_ce_bwd"):
        assert f'extern "C" int {entry}(' in text
    cmd = kernels.nvcc_command("fused_ce", kernels.library_path("fused_ce"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(src) and "-shared" in cmd
