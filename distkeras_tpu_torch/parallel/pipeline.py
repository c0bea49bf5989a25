"""Pipeline parallelism, port of ``distkeras_tpu/parallel/pipeline.py``:
the GPipe microbatch pipeline (:func:`pipeline_apply`) and the
one-forward-one-backward train schedule (:func:`pipeline_1f1b`) over a
mesh axis.

The layers are cut into ``n`` stages, one a position of the stage axis;
microbatches stream through them, and stage ``s`` runs the forward of
microbatch ``m`` at tick ``s + m``, as in JAX.  JAX runs one SPMD program
on every device: each device computes every tick, on garbage in the
fill and drain bubbles, and masks the results out.  Here each stage is a
process, and **a rank skips a tick whose microbatch is out of range,
with the send or receive that would have carried it**: each transfer is
this rank's part of the tick's ``ppermute`` (``collective.send_recv``,
the send and the receive posted together), and the two ranks of a pair
post their parts at the same tick, so every pair meets in one order.
The results are JAX's, whose bubble ticks add exact zeros.

JAX gets GPipe's backward from reverse-mode autodiff through the scan.
The port does not leave its order to autograd, which does not promise
that two ranks walk M independent chains of transfers alike (and gloo
pairs untagged messages between two ranks by order alone): the
pipeline is one ``autograd.Function`` whose backward runs the ticks in
reverse, one microbatch a tick, each through ``torch.autograd.grad`` of
that tick's stage graph.  Forward transfers carry tag 0, backward ones
tag 1.

``stage_params`` is a tensor, a list or tuple of tensors, or a dict of
them; ``stage_fn(stage_params, x)`` is shape-preserving and returns
``x``'s dtype, as the JAX scan's carry requires.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from .collective import send_recv
from .mesh import Mesh, axis_index, axis_size

STAGE_AXIS = "stage"
#: the tags of the two rings' transfers
FWD, BWD = 0, 1


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable]:
    """A tensor, a list/tuple or a dict of tensors → (leaves, rebuild)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return ([tree[k] for k in keys],
                lambda leaves: dict(zip(keys, leaves)))
    kind = type(tree)
    return list(tree), lambda leaves: kind(leaves)


def _leaves_for_grad(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """Fresh leaves over the same data, each wanting its gradient: a
    tick's graph then ends at them, not in the caller's graph."""
    return [t.detach().requires_grad_() for t in leaves]


class _GPipe(torch.autograd.Function):
    """The GPipe schedule: the forward tick by tick, keeping each tick's
    stage graph (O(M) activations, as autodiff through JAX's scan keeps
    them); the backward the same ticks in reverse."""

    @staticmethod
    def forward(ctx, pipe, x_micro, *leaves):
        stage_fn, rebuild, axis_name, mesh = pipe
        n, s = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
        m_total = x_micro.shape[0]
        like = x_micro[0]
        params = _leaves_for_grad(leaves)
        tree = rebuild(params)
        outputs = torch.zeros(x_micro.shape, dtype=torch.float32,
                              device=x_micro.device)
        ticks = []
        x = (send_recv(None, axis_name, None, s - 1, like, mesh, FWD)
             if s > 0 else None)
        for m in range(m_total):
            x_in = (x_micro[m] if s == 0 else x).detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(tree, x_in)
            ticks.append((x_in, y))
            # tick s + m: y on to stage s + 1, microbatch m + 1 in
            x = send_recv(y.detach(), axis_name,
                          s + 1 if s < n - 1 else None,
                          s - 1 if s > 0 and m + 1 < m_total else None,
                          like, mesh, FWD)
            if s == n - 1:
                outputs[m] = y.detach().to(torch.float32)
        ctx.state = (pipe, n, s, params, ticks, like)
        return outputs

    @staticmethod
    def backward(ctx, ct):
        (_, _, axis_name, mesh), n, s, params, ticks, like = ctx.state
        m_total = len(ticks)
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        dx_micro = torch.zeros((m_total,) + tuple(like.shape),
                               dtype=like.dtype, device=like.device)
        dy = (send_recv(None, axis_name, None, s + 1, like, mesh, BWD)
              if s < n - 1 else None)
        for m in reversed(range(m_total)):
            x_in, y = ticks[m]
            # the last stage's outputs are y in f32; elsewhere the
            # cotangent arrives from the next stage, in y's dtype
            dy_m = ct[m].to(y.dtype) if s == n - 1 else dy
            got = torch.autograd.grad(y, [*params, x_in], dy_m,
                                      allow_unused=True,
                                      materialize_grads=True)
            ticks[m] = None  # the tick's activations go with it
            grads = [g if acc is None else acc + g
                     for acc, g in zip(grads, got[:-1])]
            dx = got[-1]
            if s == 0:
                dx_micro[m] = dx
            dy = send_recv(dx, axis_name, s - 1 if s > 0 else None,
                           s + 1 if s < n - 1 and m > 0 else None,
                           like, mesh, BWD)
        return (None, dx_micro, *grads)


def pipeline_apply(stage_fn: Callable, stage_params: Any,
                   x_micro: torch.Tensor, axis_name: str = STAGE_AXIS,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Run microbatches through the stage pipeline (GPipe).

    ``stage_params``: this rank's stage parameters (the stage axis
    already split and squeezed).  ``x_micro``: (M, micro_b, ...)
    microbatches, meaningful on stage 0 (the other stages' are not
    read).  Returns (M, micro_b, ...) f32: the last stage's outputs
    there, zeros elsewhere; differentiable in ``stage_params`` and
    ``x_micro`` (every rank must take the backward: its transfers pair
    with its neighbours')."""
    leaves, rebuild = _flatten(stage_params)
    return _GPipe.apply((stage_fn, rebuild, axis_name, mesh), x_micro,
                        *leaves)


def pipeline_1f1b(stage_fn: Callable, stage_params: Any,
                  x_micro: torch.Tensor, labels_micro: torch.Tensor,
                  head_loss_fn: Callable, head_params: Any,
                  axis_name: str = STAGE_AXIS,
                  mesh: Optional[Mesh] = None):
    """The one-forward-one-backward pipeline train step.

    Stage ``s`` runs the forward of microbatch ``m`` at tick ``s + m``
    (under ``torch.no_grad``), keeping its *input* in a rotating buffer
    of ``2n - 1`` slots, and its backward at tick ``2(n-1) - s + m``,
    re-running the stage on the kept input with grad and taking
    ``torch.autograd.grad`` (the counterpart of ``jax.vjp``); the last
    stage back-propagates a microbatch in the tick it finishes its
    forward.  Activations flow forward, cotangents backward (in f32, cast
    to the compute dtype on arrival), in ``M + 2(n-1)`` ticks, and the
    activation memory is O(n), whatever M.

    ``x_micro`` (M, micro_b, ...): stage 0's inputs; ``labels_micro``
    (M, ...): the last stage's; ``head_loss_fn(head_params, y, labels)``
    the loss SUM over a microbatch of the last stage's outputs.  Returns
    ``(loss_sum, dstage, dhead, dx_micro)``: ``loss_sum`` and ``dhead``
    real on the last stage (zeros elsewhere), ``dx_micro`` (M, ...) f32
    real on stage 0 (zeros elsewhere), ``dstage`` this stage's gradient;
    all outside autograd."""
    n, s = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    m_total = x_micro.shape[0]
    nbuf = 2 * n - 1      # a slot lives at most 2(n-1) ticks
    ticks = m_total + 2 * (n - 1)
    last = s == n - 1
    like = x_micro[0]
    like32 = torch.empty(like.shape, dtype=torch.float32, device=like.device)
    st_leaves, st_rebuild = _flatten(stage_params)
    hd_leaves, hd_rebuild = _flatten(head_params)
    params = _leaves_for_grad(st_leaves)
    head = _leaves_for_grad(hd_leaves)
    dstage = [torch.zeros_like(p) for p in st_leaves]
    dhead = [torch.zeros_like(h) for h in hd_leaves]
    loss = torch.zeros((), dtype=torch.float32, device=like.device)
    dx_out = torch.zeros(x_micro.shape, dtype=torch.float32,
                         device=like.device)
    slots: List[Optional[torch.Tensor]] = [None] * nbuf
    buf_fwd = buf_bwd = dy_head = None
    valid = lambda m: 0 <= m < m_total
    for t in range(ticks):
        m_f = t - s                    # the microbatch in forward here
        m_b = t - 2 * (n - 1) + s      # the microbatch in backward here
        y = dx = None
        if valid(m_f):
            x_in = x_micro[m_f] if s == 0 else buf_fwd
            with torch.no_grad():
                y = stage_fn(st_rebuild(params), x_in)
            slots[t % nbuf] = x_in
            if last:  # the head's loss and cotangents
                y_leaf = y.detach().requires_grad_()
                with torch.enable_grad():
                    loss_m = head_loss_fn(hd_rebuild(head), y_leaf,
                                          labels_micro[m_f])
                got = torch.autograd.grad(loss_m, [*head, y_leaf],
                                          allow_unused=True,
                                          materialize_grads=True)
                loss = loss + loss_m.detach()
                dhead = [a + g for a, g in zip(dhead, got[:-1])]
                dy_head = got[-1]
        if valid(m_b):
            dy_in = dy_head.to(torch.float32) if last else buf_bwd
            x_saved = slots[(t - 2 * (n - 1 - s)) % nbuf]
            x_leaf = x_saved.detach().requires_grad_()
            with torch.enable_grad():
                y_re = stage_fn(st_rebuild(params), x_leaf)
            got = torch.autograd.grad(y_re, [*params, x_leaf],
                                      dy_in.to(y_re.dtype),
                                      allow_unused=True,
                                      materialize_grads=True)
            dstage = [a + g for a, g in zip(dstage, got[:-1])]
            dx = got[-1].to(torch.float32)
            if s == 0:
                dx_out[m_b] = dx
        # the rings: activations forward, cotangents backward, each part
        # posted where this tick (or the neighbour's) carried a microbatch
        buf_fwd = send_recv(y, axis_name,
                            s + 1 if y is not None and not last else None,
                            s - 1 if s > 0 and valid(t - (s - 1)) else None,
                            like, mesh, FWD)
        buf_bwd = send_recv(dx, axis_name,
                            s - 1 if dx is not None and s > 0 else None,
                            s + 1 if not last
                            and valid(t - 2 * (n - 1) + s + 1) else None,
                            like32, mesh, BWD)
    return (loss, st_rebuild(dstage), hd_rebuild(dhead), dx_out)


__all__ = ["STAGE_AXIS", "pipeline_apply", "pipeline_1f1b"]
