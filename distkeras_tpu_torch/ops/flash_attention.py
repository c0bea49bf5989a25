"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``distkeras_tpu/ops/flash_attention.py :: flash_attention`` on its
inference path (``_flash_forward(save_residuals=False)`` → ``pallas_call``
on ``_flash_kernel``).  The kernel itself is
``distkeras_tpu_torch/csrc/flash_attention_fwd.cu``: CUDA C++ for Hopper
(``sm_90a``), built by ``nvcc`` at first use and bound with ``ctypes``.  Its
header says what bounds it on the H100 and what the design does about it.

Contract (the JAX kernel's): (B, S, H, D) q and (B, S, Hkv, D) k, v in the
BSHD layout; causal and sliding-window masks, with whole k tiles in the
causal future or behind the window skipped; an f32 online-softmax
recurrence with the all-masked-row guards; the output in q's dtype.
Grouped-query attention reads kv head ``h // (H / Hkv)`` in the kernel
instead of repeating k and v, which gives the same numbers.

:func:`flash_attention` launches the kernel for CUDA tensors (or raises:
a head dim above 256 or a dtype other than f32/bf16/f16, bad shapes, a
failed build or launch) and
runs :func:`flash_attention_reference`, the plain version, only for CPU
tensors.  It is forward-only: asking for a gradient raises.  The backward
kernels and the ``torch.autograd.Function`` arrive with training.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .attention import validate_window

#: what the kernel is built for: any head dim up to this one (the .cu
#: pads it up to 32, 64, 128 or 256), in these dtypes (codes of the C call)
KERNEL_MAX_HEAD_DIM = 256
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: q rows per thread block; the grid's q-tile axis holds at most 65535
_BLOCK_Q = 64

_KERNEL = "flash_attention_fwd"
_lib = None  # the loaded library, built at first launch


def _library():
    global _lib
    if _lib is None:
        from ..kernels import load
        lib = load(_KERNEL)
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the (S, S) f32 scores
    materialised: f32 q·kᵀ·scale, masks, the ``safe`` row max, f32
    probabilities times f32 v, ``l == 0 → 1``, cast to q's dtype."""
    window = validate_window(window, causal)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"num_heads {h} not divisible by kv heads {hkv}")
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    g = h // hkv
    q32 = q.to(torch.float32) * scale
    k32 = k.to(torch.float32).repeat_interleave(g, dim=2)
    v32 = v.to(torch.float32).repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k32)
    if causal:
        pos = torch.arange(s, device=q.device)
        hide = pos[None, :] > pos[:, None]
        if window is not None:
            hide = hide | (pos[None, :] <= pos[:, None] - window)
        scores = scores.masked_fill(hide, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(scores - safe)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v32)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Flash attention forward on (B, S, H, D) q and (B, S, Hkv, D) k, v.

    A CUDA tensor launches the kernel and counts one launch in
    ``flash_attention.launches``; a CPU tensor runs the plain version."""
    window = validate_window(window, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention is forward-only: its backward kernels are not "
            "ported yet (run under torch.inference_mode(), or use "
            "impl='xla' for gradients)")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, window)
    _check(q, k, v)
    b, s, h, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):  # launch on the tensors' card
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], d, KERNEL_DTYPES[q.dtype], float(scale),
            int(causal), window or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse what the kernel does not take, before any pointer is passed."""
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
    if not 1 <= d <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel is built for head dims up "
                         f"to {KERNEL_MAX_HEAD_DIM}, got {d}")
    if -(-s // _BLOCK_Q) > 65535:
        raise ValueError(f"sequence length {s} exceeds the kernel's grid "
                         f"limit of {65535 * _BLOCK_Q}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
