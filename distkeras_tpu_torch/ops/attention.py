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

The hooks of the JAX function are those of the plain path:
``segment_ids`` (sequence packing, ``data/packing.py``) and the KV-cache
decoding hooks ``q_offset``, ``kv_length``, ``kv_positions`` and
``q_positions`` (``core/decode.py``), each in its scalar and its per-row
form.  The dispatcher never hands a packed batch to the flash kernels.
"""

from __future__ import annotations

import math
import numbers
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


def _hook(value, device):
    """A hook as the masks use it: an integer stays a Python int (it
    broadcasts in place; a copy of it to the card would wait for the
    card), a numpy array or tensor becomes a tensor on ``device``."""
    if isinstance(value, numbers.Integral):
        return int(value)
    return torch.as_tensor(value, device=device)


def _column(value):
    """A per-row hook as a (B, 1) column (an int broadcasts as it is)."""
    return value.reshape(-1, 1) if isinstance(value, torch.Tensor) else value


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

    The hooks, as in the JAX function (its docstring has the why):
    ``q_offset`` places query i at absolute position ``q_offset + i`` for
    the causal mask; ``kv_length`` hides key slots >= it;
    ``kv_positions`` gives each key slot its absolute position (ring
    caches; negative = an empty slot; requires ``causal``);
    ``q_positions`` (B, Sq) gives each query its position.  ``q_offset``
    and ``kv_length`` may be (B,) and ``kv_positions`` (B, Sk): one row
    per request, each at its own position.  ``segment_ids`` (B, S):
    queries and keys attend only within equal ids (sequence packing;
    self-attention only).  Every mask sets its scores to ``NEG_INF``; a
    fully masked row gives NaN, as in the JAX package (the causal mask
    always leaves a query its own key).
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if h % hkv:
        raise ValueError(f"num_heads {h} not divisible by kv heads {hkv}")
    window = validate_window(window, causal)
    if kv_positions is not None and not causal:
        raise ValueError("kv_positions (rolling-cache slot positions) "
                         "requires causal=True — its empty-slot masking "
                         "lives in the causal mask")
    if segment_ids is not None and sk != sq:
        raise ValueError("segment_ids (sequence packing) is a "
                         "self-attention feature: Sq must equal Sk, got "
                         f"{sq} vs {sk}")
    dev = q.device
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    # bf16 operands multiply exactly in f32, so upcasting before the
    # product gives the JAX einsum's preferred_element_type=f32 result
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    k_pos = (torch.arange(sk, device=dev) if kv_positions is None
             else _hook(kv_positions, dev))
    per_row = (q_positions is not None or k_pos.ndim == 2
               or getattr(q_offset, "ndim", 0) >= 1
               or getattr(kv_length, "ndim", 0) >= 1)
    if causal:
        if per_row:
            # batched masks: row r is a request at its own position
            if q_positions is not None:
                q_pos = _hook(q_positions, dev)
            else:
                q_off = _hook(0 if q_offset is None else q_offset, dev)
                q_pos = torch.arange(sq, device=dev)[None, :] + _column(q_off)
            kp = k_pos if k_pos.ndim == 2 else k_pos[None, :]  # (B|1, Sk)
            mask = kp[:, None, :] > q_pos[:, :, None]          # (B, Sq, Sk)
            if window is not None:
                mask = mask | (kp[:, None, :] <= q_pos[:, :, None] - window)
            if kv_positions is not None:
                mask = mask | (kp[:, None, :] < 0)  # negative = empty slot
            scores = scores.masked_fill(mask[:, None, None], NEG_INF)
        else:
            q_pos = torch.arange(sq, device=dev)
            if q_offset is not None:
                q_pos = q_pos + _hook(q_offset, dev)
            mask = k_pos[None, :] > q_pos[:, None]  # (Sq, Sk): True = hide
            if window is not None:
                mask = mask | (k_pos[None, :] <= q_pos[:, None] - window)
            if kv_positions is not None:
                mask = mask | (k_pos[None, :] < 0)  # negative = empty slot
            scores = scores.masked_fill(mask, NEG_INF)
    if kv_length is not None:
        kl = _hook(kv_length, dev)
        if per_row:
            kp = k_pos if k_pos.ndim == 2 else k_pos[None, :]
            hide = ~(kp < _column(kl))                       # (B|1, Sk)
            scores = scores.masked_fill(hide[:, None, None, None], NEG_INF)
        else:
            scores = scores.masked_fill(~(k_pos < kl), NEG_INF)
    if segment_ids is not None:
        seg = _hook(segment_ids, dev)
        cross = seg[:, :, None] != seg[:, None, :]        # (B, Sq, Sk)
        scores = scores.masked_fill(cross[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.reshape(b, sq, h, d)


# ---------------------------------------------------------------------------
# paged-KV (block-table) forms: the serving engine's paged slot pool
# ---------------------------------------------------------------------------

def paged_gather(arena: torch.Tensor, block_tables: torch.Tensor,
                 page_size: int, view_len: int) -> torch.Tensor:
    """Gather a per-row logical K/V view out of a flat paged arena.

    ``arena``: (A, ...), a flat pool of fixed-size blocks along axis 0
    (``A = (num_blocks + 1) * page_size``; the trailing block is the null
    block that junk writes go to).  ``block_tables``: (B, T) int64, row
    r's logical block i at physical block ``block_tables[r, i]``; null
    entries read junk, which the caller's frontier masks.  Returns the
    (B, view_len, ...) logical view: entry (r, p) is the arena slot that
    holds row r's position p.  Logical blocks past the table read its
    last column (the engine keeps it null), so every index stays inside
    the arena.  The values equal a dense (B, view_len, ...) cache holding
    the same writes, so attention over the view is the dense path's."""
    page = int(page_size)
    idx = torch.arange(int(view_len), device=arena.device)
    blk = torch.clamp(idx // page, max=block_tables.shape[1] - 1)
    phys = block_tables[:, blk] * page + (idx % page)[None, :]
    return arena[phys]


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    page_size: int, view_len: int, *, q_positions=None,
                    q_offset=None, kv_length=None,
                    window: Optional[int] = None, kv_positions=None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``dot_product_attention`` over block-table-gathered K/V: each row's
    keys and values come out of ``k_arena``/``v_arena`` through its block
    table, then the per-row causal masks apply (``q_positions`` or
    ``q_offset`` place the queries, ``kv_length`` hides the unwritten
    tail, ``kv_positions`` carries ring layouts).  Quantized arenas are
    dequantized by the caller (``core/decode.py``)."""
    k = paged_gather(k_arena, block_tables, page_size, view_len)
    v = paged_gather(v_arena, block_tables, page_size, view_len)
    return dot_product_attention(q, k, v, causal=True, scale=scale,
                                 q_positions=q_positions, q_offset=q_offset,
                                 kv_length=kv_length, window=window,
                                 kv_positions=kv_positions)


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
