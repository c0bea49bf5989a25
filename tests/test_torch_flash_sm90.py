"""The forward's tensor-core variant (``csrc/flash_attention_fwd_sm90.cu``)
as far as a machine without a card can check it.

- The variant rule, ``_forward_variant(dtype, head_dim)``: bf16 and f16
  with a head dim that is a multiple of 8 take ``"sm90"``, f32 and every
  other 16-bit head dim the SIMT kernel.
- The wrappers on fake CUDA tensors: each launch goes to its variant's
  entry point with the right operands and is counted once, in
  ``launches`` and ``launches_by_variant``; what no kernel takes raises,
  and so does a failed tensor-map encode or launch.
- The build: the source is in ``KERNELS`` and compiles for ``sm_90a``.
- The kernel's arithmetic, modelled in plain torch (16-bit operands with
  f32 products, the scale applied after the product, exp2 with log2(e)
  folded in, the online softmax over 128-key tiles, P split into hi and
  lo for two 16-bit P.V products), held against the JAX Pallas kernel in
  interpret mode within ``chip_smoke.py``'s per-element ``KERNEL_TOL``
  (one output ulp + 1e-5); P rounded once to 16 bits must miss it, which
  is why the kernel splits P.
"""

import contextlib
import importlib
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distkeras_tpu.ops.flash_attention import flash_attention as jax_flash
from distkeras_tpu_torch import kernels

flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

# chip_smoke.py's per-element tolerance of the forward against its plain
# version: |got - want| <= rel * |want| + 1e-5
KERNEL_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5),
              torch.float16: (2.0 ** -10, 1e-5)}
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("dtype,d", (
    [(dt, d) for dt in (torch.bfloat16, torch.float16)
     for d in (8, 16, 32, 64, 96, 128, 200, 256)]))
def test_16bit_head_dims_that_are_multiples_of_8_take_sm90(dtype, d):
    assert flash_mod._forward_variant(dtype, d) == "sm90"


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 33),
                                     (torch.bfloat16, 100),
                                     (torch.float32, 32),
                                     (torch.float32, 64)])
def test_f32_and_other_head_dims_take_simt(dtype, d):
    assert flash_mod._forward_variant(dtype, d) == "simt"


def fake_cuda(*shapes, dtype=torch.bfloat16):
    return tuple(torch.empty(*s, dtype=dtype, device="cuda") for s in shapes)


@pytest.fixture()
def launcher(monkeypatch):
    """Record the C launches instead of making them, from zeroed counts."""
    calls = []

    def launch(name, ptrs, q, hkv, scale, causal, window):
        calls.append(dict(name=name, n_ptrs=len(ptrs), lse=ptrs[4] is not None,
                          shape=tuple(q.shape), dtype=q.dtype, hkv=hkv,
                          scale=scale, causal=causal, window=window))
    monkeypatch.setattr(flash_mod, "_launch", launch)
    for fn in (flash_mod.flash_attention, flash_mod.flash_attention_forward):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_variant",
                            dict.fromkeys(flash_mod.FORWARD_VARIANTS, 0))
    with warnings.catch_warnings():  # a fake tensor's data_ptr warns
        warnings.simplefilter("ignore", UserWarning)
        yield calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_forward_launches_the_sm90_entry_once(launcher, dtype):
    with FakeTensorMode():
        q, k, v = fake_cuda((2, 128, 8, 64), (2, 128, 2, 64),
                            (2, 128, 2, 64), dtype=dtype)
        out = flash_mod.flash_attention(q, k, v, causal=True, window=32)
        out2, lse = flash_mod.flash_attention_forward(q, k, v, True, 0.5)
        assert out.shape == out2.shape == q.shape and out.dtype == dtype
        assert lse.shape == (2, 8, 128) and lse.dtype == torch.float32
    assert [c["name"] for c in launcher] == ["flash_attention_fwd_sm90"] * 2
    inference, training = launcher
    assert inference == dict(name="flash_attention_fwd_sm90", n_ptrs=5,
                             lse=False, shape=(2, 128, 8, 64), dtype=dtype,
                             hkv=2, scale=0.125, causal=True, window=32)
    assert training["lse"] and training["scale"] == 0.5
    assert training["window"] is None
    for fn in (flash_mod.flash_attention, flash_mod.flash_attention_forward):
        assert fn.launches == 1
        assert fn.launches_by_variant == {"sm90": 1, "simt": 0}


def test_f32_and_odd_head_dims_launch_the_simt_entry(launcher):
    with FakeTensorMode():
        q, k, v = fake_cuda((1, 64, 4, 32), (1, 64, 4, 32), (1, 64, 4, 32),
                            dtype=torch.float32)
        flash_mod.flash_attention(q, k, v, causal=True)
        q, k, v = fake_cuda((1, 64, 4, 36), (1, 64, 4, 36), (1, 64, 4, 36))
        flash_mod.flash_attention_forward(q, k, v, True)
    assert [c["name"] for c in launcher] == ["flash_attention_fwd"] * 2
    assert [c["lse"] for c in launcher] == [False, True]
    assert flash_mod.flash_attention.launches_by_variant == {"sm90": 0,
                                                            "simt": 1}
    assert flash_mod.flash_attention_forward.launches_by_variant == {
        "sm90": 0, "simt": 1}


@pytest.mark.parametrize("d,dtype,error,match", [
    # a head dim past the SIMT kernels' 65535 chunks of 128 columns
    (65535 * 256 + 8, torch.bfloat16, ValueError, "grid limit"),
    (32, torch.float64, TypeError, "one dtype among"),
])
def test_what_no_kernel_takes_raises(launcher, d, dtype, error, match):
    with FakeTensorMode():
        q, k, v = fake_cuda((1, 64, 4, d), (1, 64, 4, d), (1, 64, 4, d),
                            dtype=dtype)
        with pytest.raises(error, match=match):
            flash_mod.flash_attention_forward(q, k, v, True)
    assert launcher == []
    assert flash_mod.flash_attention_forward.launches == 0


@pytest.mark.parametrize("rc,match", [(-1, "TMA tensor maps"),
                                      (-701, "TMA tensor maps"),
                                      (1, "launch failed: CUDA error 1")])
def test_failed_encode_or_launch_raises_without_counting(monkeypatch, rc,
                                                         match):
    """The C entry's error code raises: a refused tensor map (negative) or
    launch (a cudaError_t); nothing falls back or counts."""
    seen = []

    def entry(*args):
        seen.append(args)
        return rc
    monkeypatch.setattr(flash_mod, "_entry", lambda name: (seen.append(name),
                                                           entry)[1])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("Stream", (), {"cuda_stream": 0}))
    monkeypatch.setattr(flash_mod.flash_attention, "launches", 0)
    monkeypatch.setattr(flash_mod.flash_attention, "launches_by_variant",
                        dict.fromkeys(flash_mod.FORWARD_VARIANTS, 0))
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        q, k, v = fake_cuda((1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))
        with pytest.raises(RuntimeError, match=match):
            flash_mod.flash_attention(q, k, v, causal=True)
    assert seen[0] == "flash_attention_fwd_sm90"
    # pointers, then B, S, H, Hkv, D, dtype code, scale, causal, window, stream
    assert seen[1][5:] == (1, 64, 4, 2, 32, 1, 1 / 32 ** 0.5, 1, 0, 0)
    assert flash_mod.flash_attention.launches == 0
    assert flash_mod.flash_attention.launches_by_variant["sm90"] == 0


def test_sm90_source_is_built_for_sm90a():
    name = flash_mod.FORWARD_VARIANTS["sm90"]
    assert name in kernels.KERNELS
    assert flash_mod.FORWARD_VARIANTS["simt"] in kernels.KERNELS
    src = kernels.source_path(name)
    assert src.exists() and src.parent == kernels.CSRC_DIR
    text = src.read_text()
    assert f'extern "C" int {name}(' in text
    assert "distkeras_tpu/ops/flash_attention.py :: _flash_kernel" in text
    # the PTX wrappers and tensor maps live in the header it includes
    assert '#include "sm90_common.cuh"' in text
    text += (kernels.CSRC_DIR / "sm90_common.cuh").read_text()
    for piece in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                  "mbarrier.try_wait.parity", "cuTensorMapEncodeTiled",
                  "__grid_constant__"):
        assert piece in text
    for banned in ("cublas", "cudnn", "scaled_dot_product", "torch/",
                   "cute/", "cutlass/"):
        assert banned not in text.lower()
    cmd = kernels.nvcc_command(name, Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
    assert cmd[-1] == str(src)


# ---------------------------------------------------------------------------
# the kernel's arithmetic against the Pallas kernel
# ---------------------------------------------------------------------------

def kernel_model(q, k, v, causal, window, split=True, block_k=128):
    """The sm90 kernel's arithmetic in plain torch: (B, S, H, D) 16-bit q
    and (B, S, Hkv, D) k, v; f32 scores of the 16-bit operands, scaled by
    scale * log2(e) after the product; per 128-key tile the masks, the
    running max (0 while a row is all -inf), p = exp2(s - m), and P.V as
    rn(P).V + rn(P - rn(P)).V (``split``) or rn(P).V, in f32; O / l
    (l == 0 taken as 1) rounded to the input dtype."""
    dt = q.dtype
    b, s, h, d = q.shape
    g = h // k.shape[2]
    q32 = q.float()
    k32 = k.float().repeat_interleave(g, dim=2)
    v32 = v.float().repeat_interleave(g, dim=2)
    c = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    m = torch.full((b, h, s), float("-inf"))
    l = torch.zeros(b, h, s)
    o = torch.zeros(b, h, s, d)
    pos = torch.arange(s)
    for k0 in range(0, s, block_k):
        kk = pos[k0:k0 + block_k]
        sc = torch.einsum("bqhd,bkhd->bhqk", q32, k32[:, k0:k0 + block_k]) * c
        if causal:
            hide = kk[None, :] > pos[:, None]
            if window is not None:
                hide = hide | (kk[None, :] <= pos[:, None] - window)
            sc = sc.masked_fill(hide, float("-inf"))
        new_m = torch.maximum(m, sc.amax(-1))
        safe = torch.where(new_m == float("-inf"), torch.zeros_like(new_m),
                           new_m)
        corr = torch.exp2(m - safe)
        p = torch.exp2(sc - safe[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(dt).float()
        parts = [hi, (p - hi).to(dt).float()] if split else [hi]
        vt = v32[:, k0:k0 + block_k]
        pv = sum(torch.einsum("bhqk,bkhd->bhqd", part, vt) for part in parts)
        o = o * corr[..., None] + pv
        m = new_m
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / l[..., None]).transpose(1, 2).to(dt)


def share_of_tol(got, want, dtype):
    rel, atol = KERNEL_TOL[dtype]
    g, w = got.float(), want.float()
    return ((g - w).abs() / (rel * w.abs() + atol)).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("case,causal,window,hkv", [
    ("causal", True, None, 4),
    ("window", True, 96, 4),
    ("gqa_noncausal", False, None, 1),
])
def test_split_p_model_matches_pallas_within_kernel_tol(case, causal, window,
                                                        hkv, d, dtype):
    rng = np.random.default_rng(d * 10 + hkv)
    s, h = 256, 4
    q = rng.standard_normal((1, s, h, d)).astype(np.float32)
    k = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    g = h // hkv
    want = jax_flash(jnp.asarray(q, jdt),
                     jnp.asarray(np.repeat(k, g, axis=2), jdt),
                     jnp.asarray(np.repeat(v, g, axis=2), jdt),
                     causal, None, 64, 64, True, window)
    want = torch.from_numpy(np.asarray(want, dtype=np.float32))
    got = kernel_model(tq, tk, tv, causal, window)
    assert got.dtype == dtype
    assert share_of_tol(got, want, dtype) <= 1.0
    # the usual tensor-core flash, P rounded once, is not the same function
    once = kernel_model(tq, tk, tv, causal, window, split=False)
    assert share_of_tol(once, want, dtype) > 1.0
