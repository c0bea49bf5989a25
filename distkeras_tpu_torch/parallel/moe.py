"""Expert parallelism, port of ``distkeras_tpu/parallel/moe.py``: a
mixture-of-experts MLP whose experts are sharded over a mesh axis (each
rank owns ``E / n`` expert MLPs) and whose tokens travel to their expert's
rank with ``all_to_all``, the Switch-Transformer schedule:

  route (local) → dispatch → all_to_all → expert MLP →
  all_to_all back → combine → all_gather of the ranks' token slices

:func:`topk_routing` is the JAX router as it is: one-hot dispatch and
gate-weighted combine masks of shape (T, E, C), and the load-balance
statistics.  :func:`moe_mlp` dispatches and combines by index instead
(``dispatch="index"``, the default): each kept choice of a token names one
of the E·C expert slots, the dispatch is a gather of the tokens into
(E, C, D) slots and the combine a gate-weighted sum over each token's k
slots.  Each slot holds at most one token, so this is the einsum form's
function exactly, at O(T·k) memory instead of O(T·E·C) (at the parallel
LM's full width one (T, E, C) f32 mask is 2.15 GB).
``dispatch="onehot"`` runs the JAX einsums, as a reference.  The expert
products are batched matmuls under ``core/layers.py :: _project``'s rule:
16-bit operands, an f32 result.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .collective import all_gather, all_to_all, pvary
from .mesh import Mesh, axis_index, axis_size
from .tp import _gelu

EXPERT_AXIS = "model"  # experts ride the model axis by default


def _router(logits: torch.Tensor, k: int):
    """(stats, the k choices as (expert (T,), gate (T,)) by iterated
    masked argmax over the f32 softmax gates, the gate denominator)."""
    e = logits.shape[-1]
    if not 1 <= k <= e:
        raise ValueError(f"router k must be in [1, {e}], got {k}")
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    # Switch load-balance statistics on the first-choice assignment
    first = F.one_hot(gates.argmax(dim=-1), e).to(torch.float32)
    stats = {"fraction": first.mean(dim=0), "prob": gates.mean(dim=0)}
    choices = []
    masked = gates
    for _ in range(k):
        expert = masked.argmax(dim=-1)           # the first maximum, as JAX
        gate = masked.gather(-1, expert[:, None])[:, 0]
        choices.append((expert, gate))
        masked = masked * (1.0 - F.one_hot(expert, e).to(torch.float32))
    # k=1 keeps the raw probability (Switch); k>1 renormalizes over choices
    denom = (sum(g for _, g in choices) + 1e-9) if k > 1 else 1.0
    return stats, choices, denom


def topk_routing(logits: torch.Tensor, capacity: int, k: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Dict[str, torch.Tensor]]:
    """Top-k router with per-expert capacity and the load-balance
    statistics: logits (T, E) → (dispatch (T, E, C) one-hot, combine
    (T, E, C) gate-weighted, stats ``fraction`` and ``prob``, each (E,)).

    ``k=1`` is the Switch router (combine weight = the raw top-1
    probability); ``k=2`` also sends each token to its second choice,
    the two gate weights renormalized to sum to 1.  A choice lands at
    queue slot c of expert e only if fewer than ``capacity`` earlier
    choices (first-choice traffic first) picked e; overflow is dropped
    (an all-zero row: the caller's residual carries it).  ``fraction`` is
    the share of tokens whose first choice is e, ``prob`` the mean router
    probability of e."""
    stats, choices, denom = _router(logits, k)
    t, e = logits.shape
    dispatch = torch.zeros(t, e, capacity, dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros(e, dtype=torch.float32, device=logits.device)
    for expert, gate in choices:
        onehot = F.one_hot(expert, e).to(torch.float32)
        pos = torch.cumsum(onehot, dim=0) * onehot + counts * onehot
        keep = onehot * (pos <= capacity)
        # jax.nn.one_hot of an index outside [0, C) is a row of zeros
        idx = (pos - 1.0).to(torch.int64)
        inside = ((idx >= 0) & (idx < capacity)).to(torch.float32)
        slot = (F.one_hot(idx.clamp(0, capacity - 1), capacity)
                .to(torch.float32) * inside[..., None])
        d = keep[..., None] * slot
        dispatch = dispatch + d
        combine = combine + d * (gate / denom)[:, None, None]
        counts = counts + keep.sum(dim=0)
    return dispatch, combine, stats


def topk_slots(logits: torch.Tensor, capacity: int, k: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]:
    """:func:`topk_routing` by index: (slots (T, k) int64, weights (T, k)
    f32, stats).  Choice j of token t sits in expert slot ``slots[t, j] =
    e · C + c`` with combine weight ``weights[t, j]``; a dropped choice
    names slot ``E · C`` (past the last), with its weight kept as the
    gate's.  ``dispatch[t, e, c] == 1`` exactly where a slot names
    ``(e, c)``."""
    stats, choices, denom = _router(logits, k)
    t, e = logits.shape
    counts = torch.zeros(e, dtype=torch.int64, device=logits.device)
    slots, weights = [], []
    for expert, gate in choices:
        onehot = F.one_hot(expert, e)
        pos = (torch.cumsum(onehot, dim=0).gather(1, expert[:, None])[:, 0]
               + counts[expert])                      # 1-based queue place
        keep = pos <= capacity
        slots.append(torch.where(keep, expert * capacity + pos - 1,
                                 torch.full_like(pos, e * capacity)))
        weights.append(gate / denom)
        counts = counts + (onehot * keep[:, None]).sum(dim=0)
    return torch.stack(slots, 1), torch.stack(weights, 1), stats


def load_balance_loss(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Switch load-balance aux ``E · Σ_e f_e · P_e`` from router stats
    (1.0 for uniform routing, → E under full collapse).  Pass stats
    averaged over every shard for a loss that no sharding changes."""
    f, p = stats["fraction"], stats["prob"]
    return f.shape[-1] * torch.sum(f * p)


def top1_routing(logits: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_routing(k=1)`` without the load-balance stats."""
    dispatch, combine, _ = topk_routing(logits, capacity, k=1)
    return dispatch, combine


def moe_mlp(x: torch.Tensor, router_kernel: torch.Tensor, w1: torch.Tensor,
            b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
            axis_name: str = EXPERT_AXIS, capacity_factor: float = 1.25,
            activation=_gelu, compute_dtype=torch.bfloat16,
            router_top_k: int = 1, mesh: Optional[Mesh] = None,
            dispatch: str = "index"):
    """Expert-parallel MoE MLP on (B, S, D) ``x``, which every rank of
    ``axis_name`` holds alike.  Each rank routes only its 1/n slice of the
    tokens, ships each expert's buffer to the rank that owns the expert,
    runs its own ``E / n`` experts and ships the results back; the slices'
    outputs reunite with a tiled ``all_gather``, so every rank returns the
    whole (B, S, D) f32 output.

    router_kernel: (D, E), the same on every rank; w1 (E/n, D, F), b1
    (E/n, F), w2 (E/n, F, D), b2 (E/n, D): this rank's experts.  Capacity
    is GShard's ``ceil(capacity_factor · k · T_loc / E)``.  Returns
    ``(output, stats)``: the stats of :func:`topk_routing` over this
    rank's slice (to be averaged over every shard before
    ``load_balance_loss``), and ``dropped``, the share of the slice's
    choices that found no slot."""
    if dispatch not in ("index", "onehot"):
        raise ValueError(f"dispatch must be 'index' or 'onehot', got "
                         f"{dispatch!r}")
    n = axis_size(mesh, axis_name)
    rank = axis_index(mesh, axis_name)
    e_local = w1.shape[0]
    e_total = n * e_local
    b, s, d = x.shape
    t = b * s
    if t % n:
        raise ValueError(f"token count {t} not divisible by axis size {n}")
    t_loc = t // n
    # GShard capacity: k choices per token issue k·T_loc slots' traffic
    capacity = max(int(math.ceil(
        capacity_factor * router_top_k * t_loc / e_total)), 1)
    cdt = compute_dtype

    xt = pvary(x.reshape(t, d), axis_name, mesh)
    xl = xt[rank * t_loc:(rank + 1) * t_loc].to(torch.float32)  # my slice
    logits = xl @ router_kernel.to(torch.float32)
    if dispatch == "onehot":
        disp, comb, stats = topk_routing(logits, capacity, router_top_k)
        buf = torch.einsum("td,tec->ecd", xl, disp)
        kept = disp.sum()
    else:
        slots, weights, stats = topk_slots(logits, capacity, router_top_k)
        # the token of each slot (t_loc, a zero row, where none landed);
        # dropped choices all name the extra slot, which is cut off
        token = torch.arange(t_loc, device=x.device).repeat_interleave(
            router_top_k)
        owner = torch.full((e_total * capacity + 1,), t_loc,
                           dtype=torch.int64, device=x.device)
        owner = owner.scatter(0, slots.reshape(-1), token)[:-1]
        buf = torch.cat([xl, xl.new_zeros(1, d)])[owner]
        kept = (slots < e_total * capacity).sum()
    stats = dict(stats, dropped=1.0 - kept.to(torch.float32)
                 / (t_loc * router_top_k))

    # each expert's buffer to the rank that owns it
    buf = buf.reshape(n, e_local, capacity, d)
    buf = all_to_all(buf, axis_name, 0, 0, mesh)
    # (n, e_local, C, D): axis 0 is now the source rank
    buf = buf.transpose(0, 1).reshape(e_local, n * capacity, d)
    h = torch.bmm(buf.to(cdt).to(torch.float32),
                  w1.to(cdt).to(torch.float32))
    h = activation(h + b1[:, None, :]).to(cdt)
    out = torch.bmm(h.to(torch.float32), w2.to(cdt).to(torch.float32))
    out = out + b2[:, None, :]

    # every token back to its source rank, and my slice recombined
    out = out.reshape(e_local, n, capacity, d).transpose(0, 1)
    out = all_to_all(out, axis_name, 0, 0, mesh)
    # (n, e_local, C, D): axis 0 is the expert group again
    out = out.reshape(e_total * capacity, d)
    if dispatch == "onehot":
        yl = torch.einsum("ecd,tec->td",
                          out.reshape(e_total, capacity, d), comb)
    else:
        out = torch.cat([out, out.new_zeros(1, d)])
        yl = (out[slots] * weights[..., None]).sum(dim=1)
    # the whole token set from the ranks' slices
    y = all_gather(yl, axis_name, mesh, axis=0)
    return y.reshape(b, s, d), stats


__all__: List[str] = ["EXPERT_AXIS", "topk_routing", "topk_slots",
                      "load_balance_loss", "top1_routing", "moe_mlp"]
