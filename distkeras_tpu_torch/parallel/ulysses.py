"""Ulysses-style sequence parallelism, port of
``distkeras_tpu/parallel/ulysses.py``.

The schedule reshards (B, S/sp, H, Dh) to (B, S, H/sp, Dh) with one tiled
``all_to_all`` (split heads, gather the sequence in rank order), attends
every local head over the whole sequence through the ``ops.attention``
dispatcher, and reshards back with a second.  The attend is the port's
dispatcher: on the card the hand-written flash kernels (forward with its
lse, dq and dk/dv under a gradient), which the ring's own online softmax
cannot use.  When ``Hkv % sp != 0`` each k/v head is first repeated
``sp / gcd(Hkv, sp)`` times, as the JAX schedule does.  On a sequence
axis of size 1 both reshards are the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .collective import all_to_all
from .mesh import Mesh, axis_size
from .ring import SEQ_AXIS


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = SEQ_AXIS, causal: bool = False,
                      scale: Optional[float] = None,
                      window: Optional[int] = None,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """All-to-all sequence-parallel attention on the shard (B, S_local, H,
    Dh) ``q`` and (B, S_local, Hkv, Dh) ``k``, ``v`` (Hkv | H); returns
    (B, S_local, H, Dh) in q's dtype.  Needs ``H % sp == 0``, as the JAX
    schedule does; a kv head count that does not split over ``sp`` is
    repeated to ``lcm(Hkv, sp)`` heads first."""
    from ..ops.attention import attention

    sp = axis_size(mesh, axis_name)
    h, hkv = q.shape[2], k.shape[2]
    if h % sp:
        raise ValueError(
            f"ulysses attention needs num_heads % seq-axis size == 0, got "
            f"{h} heads over sp={sp} (use the ring schedule otherwise)")
    if hkv % sp:
        r = sp // math.gcd(hkv, sp)
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    # (B, S/sp, H', Dh) -> (B, S, H'/sp, Dh): split heads, gather sequence
    q, k, v = (all_to_all(t, axis_name, 2, 1, mesh) for t in (q, k, v))
    out = attention(q, k, v, causal=causal, scale=scale, window=window)
    # (B, S, H/sp, Dh) -> (B, S/sp, H, Dh): split sequence, gather heads
    return all_to_all(out, axis_name, 1, 2, mesh)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: Mesh, axis_name: str = SEQ_AXIS,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """``ulysses_attention`` on a mesh whose sequence axis has size 1 (the
    same shape as ``ring.ring_self_attention``)."""
    return ulysses_attention(q, k, v, axis_name, causal, scale, window,
                             mesh=mesh)
