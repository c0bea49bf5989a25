"""Ring attention, port of ``distkeras_tpu/parallel/ring.py`` on a
sequence axis of size 1.

The JAX ring keeps each device's q shard resident, rotates the k/v shards
with ``ppermute`` and accumulates the output with an f32 online softmax
over the blocks as they arrive.  On one card the ring has one position:
the device attends its own block and no rotation happens, so what remains
is the online-softmax attend itself, here in plain PyTorch (the JAX
package runs it as XLA; no kernel is reached), trained through autograd.
A sequence axis of any other size raises (ROADMAP queue A item 7).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .mesh import Mesh, collective

SEQ_AXIS = "seq"


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = SEQ_AXIS, causal: bool = False,
                   scale: Optional[float] = None,
                   block_k: Optional[int] = None,
                   window: Optional[int] = None,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Attention over the sequence shard (B, S_local, H, Dh) ``q`` and
    (B, S_local, Hkv, Dh) ``k``, ``v`` (Hkv | H: grouped-query attention),
    returning (B, S_local, H, Dh) in q's dtype.

    The arithmetic is the JAX ring's: q prescaled in f32, scores against
    f32 k, the ``safe`` row max (0 while a row is still all -inf), the
    running numerator and denominator rescaled per block, ``den == 0 → 1``.
    ``block_k`` chunks the attend over key blocks of that size (the
    long-context memory knob: scores are (B, H, S_local, block_k));
    ``window`` (requires ``causal``) keeps keys in (p - window, p]."""
    from ..ops.attention import validate_window
    window = validate_window(window, causal)
    collective("ppermute", None, axis_name, mesh)  # a ring of one: no hop
    idx = 0  # this device's position on the ring
    b, s_loc, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"num_heads {h} not divisible by kv heads {hkv}")
    g = h // hkv
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if block_k is not None and s_loc % block_k:
        raise ValueError(f"S_local {s_loc} % block_k {block_k} != 0")

    q32 = (q.to(torch.float32) * scale).reshape(b, s_loc, hkv, g, d)
    q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)

    def attend_chunk(acc, k_blk, v_blk, k0):
        """One online-softmax update; ``k0`` is the global position of
        ``k_blk[:, 0]``."""
        num, den, mx = acc
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q32,
                              k_blk.to(torch.float32))
        if causal:
            k_pos = k0 + torch.arange(k_blk.shape[1], device=q.device)
            hide = k_pos[None, :] > q_pos[:, None]
            if window is not None:
                hide = hide | (k_pos[None, :] <= q_pos[:, None] - window)
            scores = scores.masked_fill(hide, float("-inf"))
        new_mx = torch.maximum(mx, scores.amax(dim=-1))
        safe = torch.where(torch.isneginf(new_mx), torch.zeros_like(new_mx),
                           new_mx)
        p = torch.exp(scores - safe[..., None])
        corr = torch.exp(mx - safe)
        num = num * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v_blk.to(torch.float32))
        den = den * corr + p.sum(dim=-1)
        return num, den, new_mx

    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=q.device)
    acc = (zeros(b, hkv, g, s_loc, d), zeros(b, hkv, g, s_loc),
           torch.full((b, hkv, g, s_loc), float("-inf"), device=q.device))
    if block_k is None:
        acc = attend_chunk(acc, k, v, idx * s_loc)
    else:
        for c in range(s_loc // block_k):
            sl = slice(c * block_k, (c + 1) * block_k)
            acc = attend_chunk(acc, k[:, sl], v[:, sl],
                               idx * s_loc + c * block_k)
    num, den, _ = acc
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    out = num / den[..., None]                               # (B,Hkv,G,S,Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s_loc, h, d).to(q.dtype)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh: Mesh, axis_name: str = SEQ_AXIS,
                        causal: bool = False, scale: Optional[float] = None,
                        block_k: Optional[int] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Global (B, S, H, Dh) tensors in, sequence-sharded over
    ``mesh[axis_name]``, ring attention, global tensor out.  On a sequence
    axis of size 1 the shard is the whole sequence."""
    return ring_attention(q, k, v, axis_name, causal, scale, block_k,
                          window, mesh=mesh)
