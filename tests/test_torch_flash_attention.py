"""The port's flash attention and attention dispatch against the JAX package.

The plain version of the port's CUDA kernel (``flash_attention_reference``)
is held against the JAX Pallas kernel run in interpret mode, the way
tests/test_flash_attention.py runs it on the CPU, at f32 atol 1e-5: both
are f32 inside, so they differ only in the order of f32 sums.  The port's
plain attention path is held against JAX ``attention(impl="xla")`` at f32
(atol 1e-5) and bf16 (atol 2e-2: a bf16 ulp of the unit-scale outputs is
2**-8, and the two frameworks may round an output differently where their
f32 sums land on either side of a bf16 rounding boundary).  The kernel
itself runs only on the card (``chip_smoke.py``); here its source and
build line are checked without compiling.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distkeras_tpu.ops.attention import attention as jax_attention
from distkeras_tpu.ops.flash_attention import flash_attention as jax_flash
from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import (_cuda_eligible, attention,
                                               dot_product_attention)
from distkeras_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)

# the ops package re-exports functions under the modules' names
attention_mod = importlib.import_module("distkeras_tpu_torch.ops.attention")
flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)


def make_qkv(seed, b=2, s=64, h=4, hkv=4, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def to_torch(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("causal,window,hkv,d", [
    (False, None, 4, 16),
    (True, None, 4, 16),
    (True, 5, 4, 16),     # window smaller than a 16-row block
    (True, 24, 4, 16),    # window spanning blocks: out-of-window skipping
    (True, None, 2, 16),  # GQA
    (True, 9, 1, 16),     # MQA + window
    (True, None, 4, 8),
    (True, None, 2, 32),
    (False, None, 2, 32),
])
def test_reference_matches_pallas_kernel(causal, window, hkv, d):
    q, k, v = make_qkv(hkv * 100 + d, hkv=hkv, d=d)
    g = q.shape[2] // hkv
    # the JAX kernel takes equal head counts: its dispatcher repeats k/v;
    # the port indexes kv head h // g instead
    want = jax_flash(jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=2)),
                     jnp.asarray(np.repeat(v, g, axis=2)), causal, None, 16,
                     16, True, window)
    got = flash_attention_reference(*to_torch(q, k, v), causal, None, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_reference_ragged_sequence_matches_xla():
    """A sequence no block size divides (the TPU kernel refuses it; the CUDA
    kernel masks the ragged edge): the plain version still equals the JAX
    XLA path, which at f32 computes the same function."""
    q, k, v = make_qkv(3, s=50, hkv=2)
    for causal, window in ((True, None), (True, 7), (False, None)):
        want = jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, impl="xla", window=window)
        got = flash_attention_reference(*to_torch(q, k, v), causal, None,
                                        window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_reference_explicit_scale_and_dtype():
    q, k, v = make_qkv(4, hkv=2)
    want = jax_flash(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, axis=2)),
                     jnp.asarray(np.repeat(v, 2, axis=2)), True, 0.3, 16, 16,
                     True)
    got = flash_attention_reference(*to_torch(q, k, v), True, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    bf = flash_attention_reference(*to_torch(q, k, v, dtype=torch.bfloat16),
                                   True)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal,window,hkv", [(False, None, 4),
                                               (True, None, 2),
                                               (True, 7, 2),
                                               (True, 64, 1)])
def test_attention_matches_jax_xla(dtype, atol, causal, window, hkv):
    q, k, v = make_qkv(7 + hkv, s=48, hkv=hkv)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jax_attention(*(jnp.asarray(a, dtype=jdt) for a in (q, k, v)),
                         causal=causal, impl="xla", window=window)
    got = attention(*to_torch(q, k, v, dtype=tdt), causal=causal,
                    impl="xla", window=window)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, dtype=np.float32), atol=atol)
    # dot_product_attention is the same path
    direct = dot_product_attention(*to_torch(q, k, v, dtype=tdt),
                                   causal=causal, window=window)
    torch.testing.assert_close(direct, got, atol=0, rtol=0)


def test_cpu_tensors_take_plain_version_without_launching():
    q, k, v = to_torch(*make_qkv(11, hkv=2))
    flash_attention.launches = 0
    with torch.inference_mode():
        out = flash_attention(q, k, v, causal=True, window=9)
        routed = attention(q, k, v, causal=True, impl="pallas", window=9)
        default = attention(q, k, v, causal=True, window=9)
    want = flash_attention_reference(q, k, v, True, None, 9)
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    torch.testing.assert_close(routed, want, atol=0, rtol=0)
    torch.testing.assert_close(default, want, atol=1e-5, rtol=0)
    assert flash_attention.launches == 0
    assert not _cuda_eligible(q, k, v)


def fake_cuda_qkv(sq, sk, d, dtype, h=8, hkv=2):
    """CUDA tensors that carry shape, dtype and device but no storage, so
    the dispatch can be driven here without a card."""
    return (torch.empty(2, sq, h, d, dtype=dtype, device="cuda"),
            torch.empty(2, sk, hkv, d, dtype=dtype, device="cuda"),
            torch.empty(2, sk, hkv, d, dtype=dtype, device="cuda"))


def forbid_plain_path(monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("CUDA self-attention reached the plain path")
    monkeypatch.setattr(attention_mod, "dot_product_attention", plain)


@pytest.mark.parametrize("d,dtype", [(32, torch.bfloat16),
                                     (16, torch.bfloat16),
                                     (96, torch.float16),
                                     (200, torch.float32)])
def test_cuda_self_attention_takes_the_kernel(monkeypatch, d, dtype):
    """On the card, self-attention of any head dim and model dtype goes to
    the kernel (the reference's rule: only Sq == Sk), never quietly to the
    plain path; cross-attention takes the plain path, as on the TPU."""
    forbid_plain_path(monkeypatch)
    calls = []

    def kernel(q, k, v, causal=False, scale=None, window=None):
        calls.append((tuple(q.shape), q.dtype, causal, window))
        return torch.empty_like(q)
    monkeypatch.setattr(flash_mod, "flash_attention", kernel)
    with FakeTensorMode():
        q, k, v = fake_cuda_qkv(64, 64, d, dtype)
        assert _cuda_eligible(q, k, v)
        attention(q, k, v, causal=True, window=16)
        assert not _cuda_eligible(*fake_cuda_qkv(64, 32, d, dtype)[:1],
                                  *fake_cuda_qkv(32, 32, d, dtype)[1:])
    assert calls == [((2, 64, 8, d), dtype, True, 16)]


@pytest.mark.parametrize("d,dtype,error,match", [
    # a head dim past the SIMT kernels' 65535 chunks of 128 columns
    (65535 * 256 + 8, torch.bfloat16, ValueError, "grid limit"),
    (32, torch.float64, TypeError, "one dtype among"),
])
def test_cuda_tensors_the_kernel_cannot_take_raise(monkeypatch, d, dtype,
                                                   error, match):
    """What the kernel is not built for raises before any build or launch,
    instead of running the plain path on the card."""
    forbid_plain_path(monkeypatch)
    flash_attention.launches = 0
    with FakeTensorMode():
        q, k, v = fake_cuda_qkv(64, 64, d, dtype)
        with pytest.raises(error, match=match):
            attention(q, k, v, causal=True)
    assert flash_attention.launches == 0


def test_flash_wrapper_refuses_gradients():
    """The wrapper once refused gradients; with the backward ported it
    takes the autograd Function when a gradient is wanted, and refuses to
    record one (the inference form, no graph) when it is not."""
    q, k, v = to_torch(*make_qkv(12))
    q.requires_grad_(True)
    with torch.no_grad():
        assert flash_attention(q, k, v, causal=True).grad_fn is None
    out = flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    (grad,) = torch.autograd.grad(out.sum(), q)
    want = flash_mod.flash_attention_backward_reference(
        q.detach(), k, v, out.detach(),
        flash_attention_reference(q.detach(), k, v, True,
                                  return_lse=True)[1],
        torch.ones_like(out), True)[0]
    torch.testing.assert_close(grad, want, atol=0, rtol=0)


def test_dispatch_rules():
    q, k, v = to_torch(*make_qkv(13, s=16, hkv=2))
    # a window covering every key is plain causal
    torch.testing.assert_close(
        attention(q, k, v, causal=True, impl="xla", window=16),
        attention(q, k, v, causal=True, impl="xla"), atol=0, rtol=0)
    with pytest.raises(ValueError, match="segment_ids"):
        attention(q, k, v, causal=True, impl="pallas",
                  segment_ids=torch.ones(2, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, k, v, impl="triton")
    with pytest.raises(ValueError, match="requires causal"):
        attention(q, k, v, window=4)
    # the decode hook kv_length (ported with the decode layer) hides the
    # key slots >= 8: below that the causal mask already does
    got = dot_product_attention(q, k, v, causal=True, kv_length=8)
    torch.testing.assert_close(
        got[:, :8], dot_product_attention(q, k, v, causal=True)[:, :8],
        atol=0, rtol=0)
    torch.testing.assert_close(
        got[:, 8:], dot_product_attention(q[:, 8:], k[:, :8], v[:, :8]),
        atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        dot_product_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v)


def test_kernel_source_and_build_command():
    src = kernels.source_path("flash_attention_fwd")
    assert src.exists() and src.parent == kernels.CSRC_DIR
    # the source with the header of TF32 helpers it shares with the backward
    text = src.read_text() + (kernels.CSRC_DIR / "simt_mma.cuh").read_text()
    assert '#include "simt_mma.cuh"' in text
    assert 'extern "C" int flash_attention_fwd' in text
    assert "distkeras_tpu/ops/flash_attention.py :: _flash_kernel" in text
    for banned in ("cublas", "cudnn", "scaled_dot_product", "torch/"):
        assert banned not in text.lower()
    # both products on the TF32 tensor cores, summed without atomics
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert re.search(r"atomic\w*\s*\(|\batom\.|\bred\.", text) is None
    assert "flash_attention_fwd" in kernels.KERNELS
    cmd = kernels.nvcc_command("flash_attention_fwd", Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
    assert cmd[-1] == str(src)
    lib = kernels.library_path("flash_attention_fwd")
    assert lib.parent == kernels.BUILD_DIR
    assert kernels.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    # the kernel takes every model dtype and pads every head dim up to 256
    for instantiation in ("launch<T, 32>", "launch<T, 64>", "launch<T, 128>",
                          "launch<T, kWhole>", "dispatch_dim<float>",
                          "dispatch_dim<__nv_bfloat16>",
                          "dispatch_dim<__half>"):
        assert instantiation in text
    assert "constexpr int kWhole = 256;" in text
    # and takes wider head dims in chunks of 128 columns
    assert 'launch<T, kChunk, true>' in text
    assert "constexpr int kChunk = 128;" in text
    assert flash_mod.SIMT_HEAD_DIM_CHUNK == 128
    assert set(flash_mod.KERNEL_DTYPES) == {torch.float32, torch.bfloat16,
                                            torch.float16}
