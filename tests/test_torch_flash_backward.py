"""The port's flash-attention training path against the JAX package.

The plain versions of the port's training kernels (the forward with its
lse, the dq and dk/dv backward) are held against the JAX Pallas kernels
run in interpret mode, the way tests/test_flash_attention.py runs them on
the CPU, with 16-row blocks so that tiles are skipped: out and lse at f32
atol 1e-5, gradients at 1e-4 (the JAX package's own flash-gradient
tolerance), on a loss ``sum(out * R)`` with a random R, so dO is random.
The JAX kernel takes equal head counts (its dispatcher repeats k and v),
so it gets the repeated k/v and its dk/dv are summed over each kv head's
query heads, which the port's backward does inside.  The kernels
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

from distkeras_tpu.ops.flash_attention import _flash_forward
from distkeras_tpu.ops.flash_attention import flash_attention as jax_flash
from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import dot_product_attention

flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

B, S, H = 2, 48, 4


def make_inputs(seed, hkv, d):
    rng = np.random.default_rng(seed)
    q, r = (rng.standard_normal((B, S, H, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, S, hkv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, r


@pytest.mark.parametrize("causal,window,hkv,d", [
    (False, None, 4, 16),
    (True, None, 4, 16),
    (True, 5, 4, 16),     # window smaller than a 16-row block
    (True, 24, 4, 16),    # window spanning blocks: out-of-window skipping
    (True, None, 2, 16),  # GQA
    (True, 9, 1, 16),     # MQA + window
    (True, None, 4, 8),
    (False, None, 2, 32),
])
def test_plain_forward_and_backward_match_pallas_kernels(causal, window,
                                                         hkv, d):
    q, k, v, r = make_inputs(hkv * 100 + d + (window or 0), hkv, d)
    g = H // hkv
    jq, jk, jv = (jnp.asarray(a) for a in
                  (q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)))
    scale = 1.0 / np.sqrt(d)
    jout, jlse = _flash_forward(jq, jk, jv, scale, causal, 16, 16, True,
                                save_residuals=True, window=window)
    loss = lambda a, b_, c: jnp.sum(
        jax_flash(a, b_, c, causal, None, 16, 16, True, window) * r)
    jdq, jdk, jdv = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    group = lambda t: np.asarray(t).reshape(B, S, hkv, g, d).sum(3)

    tq, tk, tv, tr = (torch.from_numpy(a) for a in (q, k, v, r))
    out, lse = flash_mod.flash_attention_reference(tq, tk, tv, causal, None,
                                                   window, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse)[..., 0].reshape(B, H, S), atol=1e-5)
    dq, dk, dv = flash_mod.flash_attention_backward_reference(
        tq, tk, tv, out, lse, tr, causal, None, window)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=1e-4)
    np.testing.assert_allclose(dk.numpy(), group(jdk), atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), group(jdv), atol=1e-4)
    # the two halves are the dq and dk/dv kernels' own plain versions
    dq2, delta = flash_mod.flash_attention_bwd_dq_reference(
        tq, tk, tv, out, lse, tr, causal, None, window)
    dk2, dv2 = flash_mod.flash_attention_bwd_dkv_reference(
        tq, tk, tv, lse, tr, delta, causal, None, window)
    for a, b_ in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a, b_, atol=0, rtol=0)
    np.testing.assert_allclose(delta.numpy(),
                               np.einsum("bshd,bshd->bhs", r, out.numpy()),
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                               (True, 7, 1),
                                               (False, None, 4)])
def test_function_matches_autograd_of_the_plain_path(causal, window, hkv):
    """On CPU tensors the autograd Function runs the plain versions; its
    gradients equal autograd through the port's dot_product_attention."""
    q, k, v, r = make_inputs(40 + hkv, hkv, 16)
    flash_mod.flash_attention_forward.launches = 0
    grads = []
    for fn in (lambda a, b_, c: flash_mod.flash_attention(
                   a, b_, c, causal, None, window),
               lambda a, b_, c: dot_product_attention(
                   a, b_, c, causal=causal, window=window)):
        t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*t)
        grads.append(torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                         t))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=0)
    assert flash_mod.flash_attention_forward.launches == 0


@pytest.mark.parametrize("causal,window,hkv", [(True, 3, 1), (False, None, 2)])
def test_function_gradcheck(causal, window, hkv):
    gen = torch.Generator().manual_seed(hkv)
    q, k, v = (torch.randn(1, 8, n, 4, dtype=torch.float64, generator=gen,
                           requires_grad=True) for n in (2, hkv, hkv))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: flash_mod.FlashAttentionFunction.apply(
            a, b_, c, causal, None, window), (q, k, v))


def fake_cuda(*shapes, dtype=torch.bfloat16):
    return tuple(torch.empty(*s, dtype=dtype, device="cuda") for s in shapes)


@pytest.fixture()
def launcher(monkeypatch):
    """Record the C launches instead of making them."""
    calls = []

    def launch(name, ptrs, q, hkv, scale, causal, window):
        calls.append((name, len(ptrs), ptrs[-1] is None, tuple(q.shape),
                      hkv, causal, window))
    monkeypatch.setattr(flash_mod, "_launch", launch)
    for fn, attrs in ((flash_mod.flash_attention, ("launches",)),
                      (flash_mod.flash_attention_forward, ("launches",)),
                      (flash_mod.flash_attention_backward,
                       ("dq_launches", "dkv_launches"))):
        for attr in attrs:
            monkeypatch.setattr(fn, attr, 0)
    for fn in (flash_mod.flash_attention, flash_mod.flash_attention_forward):
        monkeypatch.setattr(fn, "launches_by_variant",
                            dict.fromkeys(flash_mod.FORWARD_VARIANTS, 0))
    for attr in ("dq_launches_by_variant", "dkv_launches_by_variant"):
        monkeypatch.setattr(flash_mod.flash_attention_backward, attr,
                            dict.fromkeys(flash_mod.BACKWARD_VARIANTS, 0))
    with warnings.catch_warnings():  # a fake tensor's data_ptr warns
        warnings.simplefilter("ignore", UserWarning)
        yield calls


def test_cuda_training_path_launches_each_kernel_once(launcher):
    """On CUDA tensors the training forward launches the forward with an
    lse buffer (the inference form passes none), and the backward launches
    the dq kernel, then the dk/dv kernel, each counted once.  bf16 at
    D 32 takes the tensor-core variants of the forward and the backward."""
    with FakeTensorMode():
        q, k, v = fake_cuda((2, 64, 8, 32), (2, 64, 2, 32), (2, 64, 2, 32))
        out, lse = flash_mod.flash_attention_forward(q, k, v, True, None, 16)
        assert lse.shape == (2, 8, 64) and lse.dtype == torch.float32
        dq, dk, dv = flash_mod.flash_attention_backward(
            q, k, v, out, lse, torch.empty_like(out), True, None, 16)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
        flash_mod.flash_attention(q, k, v, causal=True)
    assert [c[0] for c in launcher] == [
        "flash_attention_fwd_sm90", "flash_attention_bwd_dq_sm90",
        "flash_attention_bwd_dkv_sm90", "flash_attention_fwd_sm90"]
    assert launcher[0][1:] == (5, False, (2, 64, 8, 32), 2, True, 16)
    assert launcher[1][1] == launcher[2][1] == 8
    assert launcher[3][1:3] == (5, True)  # inference: a null lse
    assert flash_mod.flash_attention_forward.launches == 1
    assert flash_mod.flash_attention_backward.dq_launches == 1
    assert flash_mod.flash_attention_backward.dkv_launches == 1
    assert flash_mod.flash_attention.launches == 1
    for fn in (flash_mod.flash_attention, flash_mod.flash_attention_forward):
        assert fn.launches_by_variant == {"sm90": 1, "simt": 0}
    bwd = flash_mod.flash_attention_backward
    assert bwd.dq_launches_by_variant == {"sm90": 1, "simt": 0}
    assert bwd.dkv_launches_by_variant == {"sm90": 1, "simt": 0}


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "dout_dtype",
                                 "delta_shape"])
def test_cuda_backward_refuses_bad_operands(launcher, bad):
    with FakeTensorMode():
        q, k, v, out, dout = fake_cuda((2, 64, 8, 32), (2, 64, 2, 32),
                                       (2, 64, 2, 32), (2, 64, 8, 32),
                                       (2, 64, 8, 32))
        lse, delta = fake_cuda((2, 8, 64), (2, 8, 64), dtype=torch.float32)
        if bad == "lse_shape":
            lse = fake_cuda((2, 64, 8), dtype=torch.float32)[0]
        elif bad == "lse_dtype":
            lse = lse.to(torch.bfloat16)
        elif bad == "dout_dtype":
            dout = dout.to(torch.float16)
        else:
            delta = fake_cuda((2, 8, 32), dtype=torch.float32)[0]
        with pytest.raises(ValueError, match=bad.split("_")[0]):
            if bad == "delta_shape":
                flash_mod.flash_attention_bwd_dkv(q, k, v, lse, dout, delta,
                                                  True)
            else:
                flash_mod.flash_attention_bwd_dq(q, k, v, out, lse, dout,
                                                 True)
    assert launcher == []


def test_backward_source_is_built_for_sm90a_without_compiling():
    assert "flash_attention_bwd" in kernels.KERNELS
    src = kernels.source_path("flash_attention_bwd")
    assert src.exists()
    text = src.read_text()
    for entry in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert f'extern "C" int {entry}(' in text
    cmd = kernels.nvcc_command("flash_attention_bwd", kernels.library_path(
        "flash_attention_bwd"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(src) and "-shared" in cmd
