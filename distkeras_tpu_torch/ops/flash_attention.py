"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the ``torch.autograd.Function`` that joins them.

Port of ``distkeras_tpu/ops/flash_attention.py :: flash_attention``, the
``jax.custom_vjp`` over three Pallas kernels:

- ``_flash_kernel`` in its inference form (``flash_attention`` outside a
  gradient) and its training form, which also writes the per-row f32
  logsumexp (``flash_attention_forward``), in two variants chosen by
  :func:`_forward_variant` from the inputs' dtype and head dim:
  ``csrc/flash_attention_fwd_sm90.cu`` (``"sm90"``: wgmma tensor-core
  products on TMA-fed tiles, bf16 and f16 with D a multiple of 8) and
  ``csrc/flash_attention_fwd.cu`` (``"simt"``: f32 on the CUDA cores, for
  f32 and any other 16-bit head dim, above 256 included);
- ``_dq_kernel`` and ``_dkv_kernel`` (``flash_attention_backward``), in
  two variants chosen by :func:`_backward_variant`:
  ``csrc/flash_attention_bwd_sm90.cu`` (``"sm90"``: wgmma tensor-core
  products on TMA-fed tiles, bf16 and f16 with D a multiple of 8 up to
  128) and ``csrc/flash_attention_bwd.cu`` (``"simt"``: f32 on the CUDA
  cores, for f32 and any other head dim).

The kernels are CUDA C++ for Hopper (``sm_90a``), built by ``nvcc`` at
first use and bound with ``ctypes``; each source's header says what bounds
it on the H100 and what its design does about it.

Contract (the JAX kernels'): (B, S, H, D) q and (B, S, Hkv, D) k, v in the
BSHD layout; causal and sliding-window masks, with whole tiles in the
causal future or behind the window skipped; f32 arithmetic with the
all-masked-row guards; outputs in the inputs' dtype, lse f32 in a (B, H, S)
layout (the TPU kernel's 128-lane broadcast of it is TPU layout and is not
carried over).  Grouped-query attention reads kv head ``h // (H / Hkv)``
instead of repeating k and v, and the backward sums dk and dv over the
query heads of each kv head inside the kernel.

The SIMT kernels take any head dim: above ``SIMT_HEAD_DIM_CHUNK`` (256)
their tiles hold one 256-column chunk at a time, and the grid gets one
block per output chunk on its z axis (each source's header says how).

Every wrapper launches its kernel for CUDA tensors (or raises: a dtype
other than f32/bf16/f16, bad shapes, a failed build or launch) and runs
its plain version only for CPU tensors.  The wrappers take contiguous
operands; the public :func:`flash_attention` first copies a CUDA view
that is not contiguous, or does not start on a 16-byte boundary, into a
fresh tensor (``kernels.kernel_operand``: a layout copy, after which the
kernel still launches).  Each counts its
launches in a ``launches`` attribute (``flash_attention_backward`` in
``dq_launches`` and ``dkv_launches``, one per kernel); the two forward
wrappers also count them by variant in ``launches_by_variant``, the
backward in ``dq_launches_by_variant`` and ``dkv_launches_by_variant``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..kernels import kernel_operand
from .attention import validate_window

#: the SIMT kernels' tile width in the head dim: up to it the .cu files pad
#: the head dim to 32, 64, 128 or 256; above it they take it in chunks of
#: this many columns, one block per chunk on the grid's z axis (at most
#: 65535 chunks)
SIMT_HEAD_DIM_CHUNK = 256
#: the largest head dim of the forward's sm90 variant (its wgmma N and TMA
#: box width)
SM90_FORWARD_MAX_HEAD_DIM = 256
#: the dtypes the kernels take (codes of the C calls)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: q rows (both forward variants, dq) and keys (dk/dv) per thread block;
#: the grid's tile axis holds at most 65535
_BLOCK = 64
#: the forward's variants: C entry point (and source) of each
FORWARD_VARIANTS = {"sm90": "flash_attention_fwd_sm90",
                    "simt": "flash_attention_fwd"}
#: the backward's variants: the C entry points of the dq and dk/dv kernels
BACKWARD_VARIANTS = {
    "sm90": {"dq": "flash_attention_bwd_dq_sm90",
             "dkv": "flash_attention_bwd_dkv_sm90"},
    "simt": {"dq": "flash_attention_bwd_dq", "dkv": "flash_attention_bwd_dkv"},
}
#: the largest head dim of the backward's sm90 variant: its dK and dV
#: accumulators take D f32 registers per thread of one warpgroup
SM90_BACKWARD_MAX_HEAD_DIM = 128

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: each C entry point: (library, argument types after the pointers)
_ENTRIES = {
    "flash_attention_fwd": ("flash_attention_fwd", 5),
    "flash_attention_fwd_sm90": ("flash_attention_fwd_sm90", 5),
    "flash_attention_bwd_dq": ("flash_attention_bwd", 8),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", 8),
    "flash_attention_bwd_dq_sm90": ("flash_attention_bwd_sm90", 8),
    "flash_attention_bwd_dkv_sm90": ("flash_attention_bwd_sm90", 8),
}
_fns = {}  # entry name -> bound C function, loaded at first launch


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ..kernels import load
        lib_name, n_ptrs = _ENTRIES[name]
        fn = getattr(load(lib_name), name)
        # pointers, then B, S, H, Hkv, D, dtype, scale, causal, window, stream
        fn.argtypes = ([_PTR] * n_ptrs + [_INT] * 6
                       + [_FLOAT, _INT, _INT, _PTR])
        fn.restype = _INT
        _fns[name] = fn
    return fn


def _launch(name: str, ptrs, q: torch.Tensor, hkv: int, scale: float,
            causal: bool, window: Optional[int]) -> None:
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):  # launch on the tensors' card
        rc = _entry(name)(
            *ptrs, b, s, h, hkv, d, KERNEL_DTYPES[q.dtype], float(scale),
            int(causal), window or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"{name}: the TMA tensor maps could not be made "
                           f"(code {rc}: -1 cuTensorMapEncodeTiled not "
                           f"found, else -CUresult)")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _forward_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which forward kernel serves these inputs, a rule about the inputs
    alone (no fallback: the chosen kernel launches or raises).  bf16 and
    f16 with a head dim that is a multiple of 8 (the TMA tensor maps need
    16-byte strides) and at most ``SM90_FORWARD_MAX_HEAD_DIM`` take
    ``"sm90"``, the tensor-core kernel; f32, whose 2e-5 tolerance TF32
    products would break, and any other 16-bit head dim take ``"simt"``,
    the f32 CUDA-core kernel."""
    if (dtype in (torch.bfloat16, torch.float16) and head_dim % 8 == 0
            and head_dim <= SM90_FORWARD_MAX_HEAD_DIM):
        return "sm90"
    return "simt"


def _backward_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which pair of backward kernels serves these inputs, a rule about
    the inputs alone (no fallback).  bf16 and f16 with a head dim that is a
    multiple of 8 (the TMA maps' 16-byte strides) and at most
    ``SM90_BACKWARD_MAX_HEAD_DIM`` (the dK and dV accumulators of one
    warpgroup take D f32 registers per thread, D / 2 each) take
    ``"sm90"``, the tensor-core kernels; f32 and any other head dim take
    ``"simt"``, the f32 CUDA-core kernels."""
    if (dtype in (torch.bfloat16, torch.float16) and head_dim % 8 == 0
            and head_dim <= SM90_BACKWARD_MAX_HEAD_DIM):
        return "sm90"
    return "simt"


def _launch_forward(q, k, v, out, lse, scale, causal, window) -> str:
    """Launch the forward variant that :func:`_forward_variant` picks
    (lse None: the inference form); returns the variant."""
    variant = _forward_variant(q.dtype, q.shape[-1])
    if variant == "sm90":
        _check_tma(q, k, v)
    _launch(FORWARD_VARIANTS[variant],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr()),
            q, k.shape[2], _scale(q, scale), causal, window)
    return variant


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale


# ---------------------------------------------------------------------------
# plain versions (f32, with the (S, S) scores materialised)
# ---------------------------------------------------------------------------

def _plain_scores(q, k, causal, scale, window, prescale):
    """f32 (f64 for f64 inputs) scores of every query head against its kv
    head, masked to -inf: (B, H, S, S), plus the repeated k.  The forward
    scales q before the product (``_flash_kernel``), the backward scales
    the product (``_dq_kernel``/``_dkv_kernel``)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"num_heads {h} not divisible by kv heads {hkv}")
    acc = torch.promote_types(q.dtype, torch.float32)
    k32 = k.to(acc).repeat_interleave(h // hkv, dim=2)
    if prescale:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc) * scale, k32)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k32) * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        hide = pos[None, :] > pos[:, None]
        if window is not None:
            hide = hide | (pos[None, :] <= pos[:, None] - window)
        scores = scores.masked_fill(hide, float("-inf"))
    return scores, k32


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None,
                              window: Optional[int] = None,
                              return_lse: bool = False):
    """The forward kernel's function in plain PyTorch, with the (S, S) f32
    scores materialised: q·kᵀ·scale, masks, the ``safe`` row max, f32
    probabilities times f32 v, ``l == 0 → 1``, cast to q's dtype.  With
    ``return_lse`` also the (B, H, S) logsumexp ``safe_m + log(l)`` of the
    training form."""
    window = validate_window(window, causal)
    scores, _ = _plain_scores(q, k, causal, _scale(q, scale), window,
                              prescale=True)
    h = q.shape[2]
    v32 = v.to(scores.dtype).repeat_interleave(h // k.shape[2], dim=2)
    m = scores.amax(dim=-1, keepdim=True)
    safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - safe)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v32).to(q.dtype)
    if not return_lse:
        return out
    return out, (safe + torch.log(l)).squeeze(-1)


def _plain_backward_terms(q, k, v, lse, dout, delta, causal, scale,
                          window):
    """p = exp(s − lse) and ds = p∘(dO·vᵀ − Δ)·scale, (B, H, S, S), with the
    repeated k in the working dtype."""
    scores, k32 = _plain_scores(q, k, causal, scale, window, prescale=False)
    acc = scores.dtype
    p = torch.exp(scores - lse.to(acc)[..., None])
    v32 = v.to(acc).repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(acc), v32)
    ds = p * (dp - delta.to(acc)[..., None]) * scale
    return p, ds, k32


def flash_attention_bwd_dq_reference(q, k, v, out, lse, dout, causal=False,
                                     scale=None, window=None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel's function in plain PyTorch (``_dq_kernel``'s
    recompute in f32 with the scores materialised): (dq = ds·k in q's
    dtype, Δ = rowsum(dO∘O) in f32 (B, H, S), from O as stored)."""
    window = validate_window(window, causal)
    acc = torch.promote_types(q.dtype, torch.float32)
    delta = (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)
    _, ds, k32 = _plain_backward_terms(q, k, v, lse, dout, delta, causal,
                                       _scale(q, scale), window)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k32).to(q.dtype), delta


def flash_attention_bwd_dkv_reference(q, k, v, lse, dout, delta,
                                      causal=False, scale=None, window=None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch (``_dkv_kernel``'s
    recompute in f32 with the scores materialised): dk = dsᵀ·q and
    dv = pᵀ·dO, summed over the query heads of each kv head, in k's and
    v's dtype."""
    window = validate_window(window, causal)
    p, ds, _ = _plain_backward_terms(q, k, v, lse, dout, delta, causal,
                                     _scale(q, scale), window)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.to(p.dtype))
    group = lambda t: t.reshape(b, s, hkv, h // hkv, d).sum(3)
    return group(dk).to(k.dtype), group(dv).to(v.dtype)


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, causal: bool = False,
        scale: Optional[float] = None, window: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch: the recompute
    schedule of ``_dq_kernel``/``_dkv_kernel`` in f32 with the scores
    materialised.  p = exp(s − lse), Δ = rowsum(dO∘O) from O as stored,
    ds = p∘(dO·vᵀ − Δ)·scale; dq = ds·k, dk = dsᵀ·q and dv = pᵀ·dO, the
    last two summed over the query heads of each kv head; each cast to its
    input's dtype."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, out, lse, dout,
                                                 causal, scale, window)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, lse, dout, delta,
                                               causal, scale, window)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention on (B, S, H, D) q and (B, S, Hkv, D) k, v.

    When a gradient is wanted (grad enabled, an input that requires it),
    this is :class:`FlashAttentionFunction`: the training forward, then the
    backward kernels.  Otherwise it is the inference form, as the JAX
    primal is: a CUDA tensor launches the forward variant of
    :func:`_forward_variant` without the lse and counts one launch in
    ``flash_attention.launches`` and one in its variant's entry of
    ``flash_attention.launches_by_variant``; a CPU tensor runs the plain
    version.  A CUDA operand that is a non-contiguous or misaligned view is
    first copied into a fresh tensor (gradients come back in the view's
    shape and strides, through autograd)."""
    window = validate_window(window, causal)
    q, k, v = kernel_operand(q), kernel_operand(k), kernel_operand(v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, window)
    _check(q, k, v)
    out = torch.empty_like(q)
    variant = _launch_forward(q, k, v, out, None, scale, causal, window)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(FORWARD_VARIANTS, 0)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = False,
                            scale: Optional[float] = None,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training form of the forward (the JAX ``_fwd``): (out, lse),
    lse f32 (B, H, S).  A CUDA tensor launches the forward variant of
    :func:`_forward_variant` with its lse output and counts one launch in
    ``flash_attention_forward.launches`` and in ``launches_by_variant``;
    a CPU tensor runs the plain version."""
    window = validate_window(window, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, window,
                                         return_lse=True)
    _check(q, k, v)
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    variant = _launch_forward(q, k, v, out, lse, scale, causal, window)
    flash_attention_forward.launches += 1
    flash_attention_forward.launches_by_variant[variant] += 1
    return out, lse


flash_attention_forward.launches = 0
flash_attention_forward.launches_by_variant = dict.fromkeys(FORWARD_VARIANTS,
                                                            0)


def flash_attention_bwd_dq(q, k, v, out, lse, dout, causal=False, scale=None,
                           window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel (``_dq_kernel``): (dq, Δ), Δ f32 (B, H, S).  A CUDA
    tensor launches the variant of :func:`_backward_variant` and counts one
    launch in ``flash_attention_backward.dq_launches`` and in its variant's
    entry of ``dq_launches_by_variant``; a CPU tensor runs the plain
    version."""
    window = validate_window(window, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, out, lse, dout,
                                                causal, scale, window)
    _check(q, k, v)
    b, s, h, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        _check_like(name, t, q.shape, q.dtype, q.device)
    _check_like("lse", lse, (b, h, s), torch.float32, q.device)
    variant = _backward_variant(q.dtype, q.shape[-1])
    if variant == "sm90":
        _check_tma(q, k, v, out, dout)
    dq = torch.empty_like(q)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    _launch(BACKWARD_VARIANTS[variant]["dq"],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr()),
            q, k.shape[2], _scale(q, scale), causal, window)
    flash_attention_backward.dq_launches += 1
    flash_attention_backward.dq_launches_by_variant[variant] += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, lse, dout, delta, causal=False,
                            scale=None, window=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel (``_dkv_kernel``): (dk, dv) in k's and v's dtype,
    summed over the query heads of each kv head, from Δ as the dq kernel
    wrote it.  A CUDA tensor launches the variant of
    :func:`_backward_variant` and counts one launch in
    ``flash_attention_backward.dkv_launches`` and in its variant's entry of
    ``dkv_launches_by_variant``; a CPU tensor runs the plain version."""
    window = validate_window(window, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, lse, dout, delta,
                                                 causal, scale, window)
    _check(q, k, v)
    b, s, h, _ = q.shape
    _check_like("dout", dout, q.shape, q.dtype, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        _check_like(name, t, (b, h, s), torch.float32, q.device)
    variant = _backward_variant(q.dtype, q.shape[-1])
    if variant == "sm90":
        _check_tma(q, k, v, dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(BACKWARD_VARIANTS[variant]["dkv"],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k.shape[2], _scale(q, scale), causal, window)
    flash_attention_backward.dkv_launches += 1
    flash_attention_backward.dkv_launches_by_variant[variant] += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, dout, causal=False,
                             scale=None, window=None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) from the forward's saved (q, k, v, out, lse) and the
    output's gradient (the JAX ``_bwd``): on the card the dq kernel, then
    the dk/dv kernel on the same stream (it reads the Δ that the dq kernel
    writes), both of the variant of :func:`_backward_variant`; on the CPU
    the plain version."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal, scale, window)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, causal,
                                       scale, window)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, dout, delta, causal,
                                     scale, window)
    return dq, dk, dv


flash_attention_backward.dq_launches = 0
flash_attention_backward.dkv_launches = 0
flash_attention_backward.dq_launches_by_variant = dict.fromkeys(
    BACKWARD_VARIANTS, 0)
flash_attention_backward.dkv_launches_by_variant = dict.fromkeys(
    BACKWARD_VARIANTS, 0)


class FlashAttentionFunction(torch.autograd.Function):
    """The counterpart of the ``jax.custom_vjp``: the forward saves
    (q, k, v, out, lse), never an (S, S) tensor, and the backward runs the
    dq and dk/dv kernels on them (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        out, lse = flash_attention_forward(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, kernel_operand(dout), *ctx.args)
        return dq, dk, dv, None, None, None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse what the kernels do not take, before any pointer is passed."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must all lie on the "
                         "same CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v are on different "
                         "devices")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one dtype among "
                        f"{list(KERNEL_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants (B, S, H, D) q and equal "
                         f"(B, S, Hkv, D) k, v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"flash_attention is self-attention: k/v "
                         f"{tuple(k.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"num_heads {h} not divisible by kv heads "
                         f"{k.shape[2]}")
    if d < 1:
        raise ValueError(f"flash_attention kernel needs a head dim >= 1, "
                         f"got {d}")
    if -(-d // SIMT_HEAD_DIM_CHUNK) > 65535:
        raise ValueError(f"head dim {d} exceeds the kernel's grid limit of "
                         f"{65535 * SIMT_HEAD_DIM_CHUNK}")
    if -(-s // _BLOCK) > 65535:
        raise ValueError(f"sequence length {s} exceeds the kernel's grid "
                         f"limit of {65535 * _BLOCK}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")


def _check_tma(*tensors: torch.Tensor) -> None:
    """Refuse what the sm90 variants' TMA tensor maps and 16-byte loads do
    not take: a head dim that is not a multiple of 8, or data that does not
    start on a 16-byte boundary (a contiguous view at an odd offset).
    Raises rather than reroutes: the variant is a rule about dtype and head
    dim alone."""
    d = tensors[0].shape[-1]
    if d % 8:
        raise ValueError(f"flash_attention sm90 kernels need a head dim that "
                         f"is a multiple of 8, got {d}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("flash_attention sm90 kernels need every operand "
                             "to start on a 16-byte boundary; got one at "
                             f"offset {t.data_ptr() % 16}")


def _check_like(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Refuse a backward operand that is not a contiguous ``shape`` tensor
    of ``dtype`` on ``device``."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"flash_attention backward wants a contiguous "
                         f"{name} of shape {tuple(shape)} and dtype {dtype} "
                         f"on {device}; got {tuple(t.shape)}, {t.dtype}, "
                         f"{t.device}")
