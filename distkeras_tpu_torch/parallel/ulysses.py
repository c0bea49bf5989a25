"""Ulysses-style sequence parallelism, port of
``distkeras_tpu/parallel/ulysses.py`` on a sequence axis of size 1.

The JAX schedule reshards (B, S/sp, H, Dh) to (B, S, H/sp, Dh) with one
``all_to_all``, attends every local head over the whole sequence through
the ``ops.attention`` dispatcher, and reshards back with a second.  On one
card both reshards are the identity, and the attend is the port's
dispatcher: on the card the hand-written flash kernels (forward with its
lse, dq and dk/dv under a gradient), which the ring's own online softmax
cannot use.  A sequence axis of any other size raises (ROADMAP queue A
item 7).
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh, axis_size, collective
from .ring import SEQ_AXIS


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = SEQ_AXIS, causal: bool = False,
                      scale: Optional[float] = None,
                      window: Optional[int] = None,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """All-to-all sequence-parallel attention on the shard (B, S_local, H,
    Dh) ``q`` and (B, S_local, Hkv, Dh) ``k``, ``v`` (Hkv | H); returns
    (B, S_local, H, Dh) in q's dtype.  Needs ``H % sp == 0``, as the JAX
    schedule does."""
    from ..ops.attention import attention

    sp = axis_size(mesh, axis_name)
    h = q.shape[2]
    if h % sp:
        raise ValueError(
            f"ulysses attention needs num_heads % seq-axis size == 0, got "
            f"{h} heads over sp={sp} (use the ring schedule otherwise)")
    # (B, S/sp, H', Dh) -> (B, S, H'/sp, Dh): split heads, gather sequence
    q, k, v = (collective("all_to_all", t, axis_name, mesh)
               for t in (q, k, v))
    out = attention(q, k, v, causal=causal, scale=scale, window=window)
    # (B, S, H/sp, Dh) -> (B, S/sp, H, Dh): split sequence, gather heads
    return collective("all_to_all", out, axis_name, mesh)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: Mesh, axis_name: str = SEQ_AXIS,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Global (B, S, H, Dh) tensors in, sequence-sharded over
    ``mesh[axis_name]``, all-to-all attention, global tensor out (the same
    shape as ``ring.ring_self_attention``)."""
    return ulysses_attention(q, k, v, axis_name, causal, scale, window,
                             mesh=mesh)
