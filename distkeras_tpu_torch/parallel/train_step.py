"""The model-parallel train step, port of the local step of
``distkeras_tpu/parallel/train_step.py :: build_train_step`` on one card.

The JAX step is ``value_and_grad`` of the model's loss, the optax update
and ``apply_updates``, jitted under ``shard_map``.  Here the gradient comes
from ``torch.autograd.grad`` over the parameters, and the update rule (a
``core.optimizers.Transform``, e.g. ``core.optimizers.adam``) runs and is
applied in place, as ``core/train.py`` does.  ZeRO-1 (``zero_axis``) and
FSDP (``fsdp_axis``) are sharding annotations over the data axis; on a
data axis of size 1 they are the same math as the plain step, and are
accepted there.  Above size 1 they raise, as do ``opt_partition_specs``,
``shard_specs_over_axis`` and ``zero_shard_specs``, which are not ported
(ROADMAP queue A item 7).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core import optimizers as opt_lib
from .mesh import Mesh, collective


def build_train_step(mesh: Mesh, local_loss: Callable,
                     optimizer: opt_lib.Transform,
                     params: Dict[str, torch.Tensor],
                     zero_axis: Optional[str] = None,
                     fsdp_axis: Optional[str] = None):
    """(opt_state, step): ``step(params, opt_state, tokens, labels) ->
    (params, opt_state, loss)``.

    ``local_loss(params, tokens, labels)`` is the model's scalar loss;
    ``params`` a name → tensor dict of the leaf tensors to train, updated
    in place by every step (the returned dict is the same object).  The
    loss comes back detached, on the device: a step waits for nothing on
    the host."""
    for name, axis in (("zero_axis", zero_axis), ("fsdp_axis", fsdp_axis)):
        if axis is None:
            continue
        if axis not in mesh.shape:
            raise ValueError(f"{name} {axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        collective("ZeRO/FSDP sharding", None, axis, mesh)
    opt_state = optimizer.init(list(params.values()))

    def step(params, opt_state, tokens, labels):
        plist = list(params.values())
        loss = local_loss(params, tokens, labels)
        grads = torch.autograd.grad(loss, plist)
        with torch.no_grad():
            updates, opt_state = optimizer.update(list(grads), opt_state,
                                                  plist)
            opt_lib.apply_updates(plist, updates)
        return params, opt_state, loss.detach()

    return opt_state, step
