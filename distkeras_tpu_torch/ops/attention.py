"""Attention ops: plain PyTorch path + dispatch, port of
``distkeras_tpu/ops/attention.py``.

Layout is BSHD ``(batch, seq, heads, head_dim)`` throughout, as in the JAX
package.  ``impl``: ``"xla"`` — the plain tensor path
(:func:`dot_product_attention`, the counterpart of the JAX package's XLA
path, which trains through autograd); ``"pallas"`` — the hand-written
flash kernels (``ops/flash_attention.py``: the forward, and under a
gradient the forward with its lse and the dq and dk/dv backward kernels;
the name is kept so serialized configs interchange with the JAX
package); ``None`` — the kernels for CUDA self-attention
(:func:`_cuda_eligible`), else the plain path.  A CUDA call the kernels
cannot take (a dtype other than f32/bf16/f16) raises rather than running
the plain path unannounced; a CUDA view they cannot read as it lies
(strided, or off a 16-byte boundary) is copied for them first.

The decode hooks of the JAX function (``q_offset``, ``kv_length``,
``kv_positions``, ``q_positions``, ``segment_ids``) arrive with the decode
slice; until then passing one raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = float("-inf")


def validate_window(window: Optional[int], causal: bool) -> Optional[int]:
    """The single sliding-window rule, shared by every attention entry
    point (plain, flash, layers): requires causal, must be >= 1."""
    if window is None:
        return None
    if not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          scale: Optional[float] = None,
                          q_offset=None, kv_length=None,
                          window: Optional[int] = None,
                          kv_positions=None, segment_ids=None,
                          q_positions=None) -> torch.Tensor:
    """Softmax(q·kᵀ)·v with f32 scores and softmax.

    q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh) with Hkv dividing H
    (grouped-query attention: query head h reads kv head h // (H/Hkv)).
    As in the JAX package, the probabilities are cast to ``v.dtype``
    before the P·V product, whose output comes back in ``v.dtype``.
    ``window`` (requires ``causal``): query p sees keys in (p - window, p].
    """
    hooks = dict(q_offset=q_offset, kv_length=kv_length,
                 kv_positions=kv_positions, segment_ids=segment_ids,
                 q_positions=q_positions)
    passed = sorted(n for n, val in hooks.items() if val is not None)
    if passed:
        raise NotImplementedError(
            f"dot_product_attention: {passed} (decode / packing hooks) are "
            "not ported yet")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if h % hkv:
        raise ValueError(f"num_heads {h} not divisible by kv heads {hkv}")
    window = validate_window(window, causal)
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    # bf16 operands multiply exactly in f32, so upcasting before the
    # product gives the JAX einsum's preferred_element_type=f32 result
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        mask = k_pos[None, :] > q_pos[:, None]          # (Sq, Sk): True = hide
        if window is not None:
            mask = mask | (k_pos[None, :] <= q_pos[:, None] - window)
        scores = scores.masked_fill(mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.reshape(b, sq, h, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None,
              impl: Optional[str] = None, window: Optional[int] = None,
              segment_ids=None) -> torch.Tensor:
    """Dispatching entry point used by the MultiHeadAttention layer."""
    window = validate_window(window, causal)
    if window is not None and window >= k.shape[1]:
        window = None  # covers every key: mathematically plain causal
    if segment_ids is not None and impl == "pallas":
        raise ValueError("segment_ids (sequence packing) is not supported "
                         "by the flash kernel — use impl='xla' (or leave "
                         "impl unset)")
    if impl is None:
        impl = ("pallas" if segment_ids is None and _cuda_eligible(q, k, v)
                else "xla")
    if impl == "xla":
        return dot_product_attention(q, k, v, causal=causal, scale=scale,
                                     window=window, segment_ids=segment_ids)
    if impl == "pallas":
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)
    raise ValueError(f"unknown attention impl {impl!r}")


def _cuda_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The reference's own rule on the card: self-attention (Sq == Sk) on
    the accelerator takes the kernel; cross-attention takes the plain path,
    as it took XLA on the TPU.  The kernel masks a ragged sequence edge
    itself, so the TPU's divisibility condition on S goes.  Head dim and
    dtype are not conditions: the wrapper raises for what it cannot take."""
    return (q.is_cuda and k.is_cuda and v.is_cuda
            and q.shape[1] == k.shape[1])
