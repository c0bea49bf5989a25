"""The model-parallel train step, port of the local step of
``distkeras_tpu/parallel/train_step.py :: build_train_step``.

The JAX step is ``value_and_grad`` of the model's loss, the optax update
and ``apply_updates``, jitted under ``shard_map``, where JAX inserts the
gradient reductions of replicated parameters itself.  Here each rank
takes ``torch.autograd.grad`` over its shards, sums each gradient over
the axes that ``grad_axes`` names for its parameter (one all-reduce per
set of axes, over the gradients flattened together), and runs the update
rule (a ``core.optimizers.Transform``, e.g. ``core.optimizers.adam``) in
place on its shards, as ``core/train.py`` does.  ZeRO-1 (``zero_axis``)
and FSDP (``fsdp_axis``) are sharding annotations over the data axis; on
a data axis of size 1 they are the same math as the plain step, and are
accepted there.  Above size 1 they raise, as do ``opt_partition_specs``,
``shard_specs_over_axis`` and ``zero_shard_specs``, which are not ported
(ROADMAP queue A item 7).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core import optimizers as opt_lib
from .collective import all_reduce_sum
from .mesh import Mesh


def reduce_grads(grads: List[torch.Tensor], axes: Sequence[Sequence[str]],
                 mesh: Mesh) -> List[torch.Tensor]:
    """Each gradient summed over its axes (``axes[i]`` for ``grads[i]``):
    the gradients of one set of axes flattened into one buffer and
    all-reduced once, in the order of their first appearance."""
    out = list(grads)
    sets: Dict[tuple, List[int]] = {}
    for i, a in enumerate(axes):
        key = mesh.sized_axes(a)
        if key:
            sets.setdefault(key, []).append(i)
    for key, idx in sets.items():
        flat = all_reduce_sum(torch.cat([grads[i].reshape(-1) for i in idx]),
                              key, mesh)
        for i, g in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = g.view_as(grads[i])
    return out


def build_train_step(mesh: Mesh, local_loss: Callable,
                     optimizer: opt_lib.Transform,
                     params: Dict[str, torch.Tensor],
                     zero_axis: Optional[str] = None,
                     fsdp_axis: Optional[str] = None,
                     grad_axes: Optional[Dict[str, Sequence[str]]] = None):
    """(opt_state, step): ``step(params, opt_state, tokens, labels) ->
    (params, opt_state, loss)``.

    ``local_loss(params, tokens, labels)`` is the model's scalar loss on
    this rank; ``params`` a name → tensor dict of this rank's shards to
    train, updated in place by every step (the returned dict is the same
    object); ``grad_axes`` the axes over which each parameter's gradient
    is summed (none: no sum).  The loss comes back detached, on the
    device: a step waits for nothing on the host."""
    for name, axis in (("zero_axis", zero_axis), ("fsdp_axis", fsdp_axis)):
        if axis is None:
            continue
        if axis not in mesh.shape:
            raise ValueError(f"{name} {axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        if mesh.shape[axis] != 1:
            raise NotImplementedError(
                f"ZeRO/FSDP sharding over mesh axis {axis!r} of size "
                f"{mesh.shape[axis]} is not ported yet (ROADMAP queue A "
                "item 7)")
    axes = [tuple((grad_axes or {}).get(n, ())) for n in params]
    opt_state = optimizer.init(list(params.values()))

    def step(params, opt_state, tokens, labels):
        plist = list(params.values())
        loss = local_loss(params, tokens, labels)
        grads = reduce_grads(list(torch.autograd.grad(loss, plist)), axes,
                             mesh)
        with torch.no_grad():
            updates, opt_state = optimizer.update(list(grads), opt_state,
                                                  plist)
            opt_lib.apply_updates(plist, updates)
        return params, opt_state, loss.detach()

    return opt_state, step
