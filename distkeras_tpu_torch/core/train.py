"""Train-step construction, port of ``distkeras_tpu/core/train.py``.

The JAX package builds a pure ``(params, opt_state, batch, rng) ->
(params, opt_state, loss)`` step and scans a whole epoch of minibatches
inside one XLA program.  PyTorch runs eagerly, so here the step is a
function over the model's own parameters (updated in place) and the
epoch runner is a Python loop over the stacked batches, which live on the
model's device for the whole epoch.  The losses of an epoch stay on the
device until the epoch ends, so a step waits for nothing on the host.

BatchNormalization's running statistics ride along as in the JAX step: the
loss functions return them as an aux (``{layer_index: new_stats}``), the
update rule sees a zero gradient for them (they are masked out of it, so
they keep that zero update), and the step writes the new statistics into
the model after the update.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import optimizers as opt_lib
from .losses import get_loss, per_example
from .model import Sequential, jax_leaves


class TrainState(NamedTuple):
    """Carried training state: the model's parameters (path → tensor, in
    the JAX leaf order; updated in place), the optimizer state and the
    step count."""
    params: Dict[str, torch.Tensor]
    opt_state: Any
    step: int


def model_params(model: Sequential) -> Dict[str, torch.Tensor]:
    """The model's parameters by path, in the JAX package's leaf order."""
    return dict(jax_leaves(model))


def _gradients(value: torch.Tensor, params) -> list:
    """d value / d p for every tensor of ``params``: zeros for one that
    needs no gradient (BatchNorm's running statistics) or that the value
    does not reach, as ``jax.grad`` gives."""
    trainable = [p for p in params if p.requires_grad]
    found = iter(torch.autograd.grad(value, trainable, allow_unused=True))
    grads = [next(found) if p.requires_grad else None for p in params]
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def make_loss_fn(model: Sequential, loss) -> Callable:
    """(x, y, generator) -> (loss, stats_aux): the loss of a train-mode
    forward, and the ``{layer_index: new_stats}`` dict of EMA-updated
    BatchNorm running statistics (empty for stat-free models)."""
    loss_fn = get_loss(loss)

    def compute(x, y, generator=None):
        stats: dict = {}
        pred = model(x, train=True, generator=generator, stats_out=stats)
        return loss_fn(y, pred), stats

    return compute


def make_masked_loss_fn(model: Sequential, loss) -> Callable:
    """(x, y, w, generator[, seg]) -> (masked-mean loss, stats_aux).

    ``w`` is a per-example weight vector (1 real, 0 padding): the loss is
    Σ wᵢ·lossᵢ / max(Σ w, 1), so padded examples contribute exactly zero to
    value and gradient (the tail batch is wrap-padded with real rows, which
    keeps BatchNorm's batch statistics sane).  ``stats_aux`` as in
    :func:`make_loss_fn`.  ``seg`` (sequence packing) is refused by the
    model's forward until packing is ported."""
    per_ex = per_example(get_loss(loss))

    def compute(x, y, w, generator=None, seg=None):
        stats: dict = {}
        pred = model(x, train=True, generator=generator, segment_ids=seg,
                     stats_out=stats)
        losses = per_ex(y, pred)
        w = w.to(torch.float32)
        return (torch.sum(losses * w) / torch.clamp(torch.sum(w), min=1.0),
                stats)

    return compute


def make_masked_step(model: Sequential, loss, tx: opt_lib.Transform
                     ) -> Callable:
    """The one masked minibatch step.

    (state, x, y, w, generator[, seg]) -> (state, loss, wsum), with ``w``
    a host (numpy) weight vector.  The gradient is taken with respect to
    the model's parameters, the update rule runs on it, the update is
    added to the parameters in place, and BatchNorm's new running
    statistics are written after it.

    A fully padded batch (wsum == 0) is a TRUE no-op: the masked loss
    gives zero gradient, but e.g. Adam still moves parameters on a zero
    gradient (decayed momentum over sqrt(v)), so the parameters, the
    optimizer state and the running statistics are left as they were.
    ``w`` comes from the host, so that decision needs no wait for the
    device.
    """
    compute = make_masked_loss_fn(model, loss)

    def step(state: TrainState, x, y, w, generator=None, seg=None):
        w = np.asarray(w, dtype=np.float32)
        wsum = float(w.sum())
        params = list(state.params.values())
        value, stats = compute(x, y, torch.as_tensor(w, device=x.device),
                               generator, seg)
        grads = _gradients(value, params)
        opt_state = state.opt_state
        if wsum > 0.0:
            with torch.no_grad():
                updates, opt_state = tx.update(grads, opt_state, params)
                opt_lib.apply_updates(params, updates)
            model.merge_stats(stats)
        return (TrainState(state.params, opt_state, state.step + 1),
                value.detach(), wsum)

    return step


def make_train_step(model: Sequential, loss, tx: opt_lib.Transform
                    ) -> Callable:
    """The single-device step without a mask: (state, (x, y), generator)
    -> (state, loss).  The gradient of the train-mode loss, the update
    rule, the update added in place, then BatchNorm's new running
    statistics written into the model."""
    compute = make_loss_fn(model, loss)

    def step(state: TrainState, batch, generator=None):
        x, y = batch
        params = list(state.params.values())
        value, stats = compute(x, y, generator)
        grads = _gradients(value, params)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, params)
            opt_lib.apply_updates(params, updates)
        model.merge_stats(stats)
        return (TrainState(state.params, opt_state, state.step + 1),
                value.detach())

    return step


def make_epoch_runner(model: Sequential, loss, tx: opt_lib.Transform,
                      packed: bool = False) -> Callable:
    """epoch(state, xb, yb, mb, generator) -> (state, per-batch losses).

    ``xb``/``yb`` are (num_batches, batch, ...) tensors on the model's
    device and ``mb`` the host (num_batches, batch) real/padding mask
    (:func:`batch_epoch_data`), so the tail batch is padded and masked
    instead of dropped.  Each loss is the exact mean over that batch's
    real examples; they come back as one (num_batches,) tensor."""
    if packed:
        raise NotImplementedError(
            "packed epochs (sequence packing, data/packing.py) are not "
            "ported yet")
    step = make_masked_step(model, loss, tx)

    def epoch(state: TrainState, xb, yb, mb, generator=None):
        losses = []
        for x, y, w in zip(xb, yb, mb):
            state, value, _ = step(state, x, y, w, generator)
            losses.append(value)
        return state, torch.stack(losses)

    return epoch


def batch_epoch_arrays(batch_size: int, *arrays):
    """Stack flat epoch arrays into (num_batches, batch, ...) + mask,
    wrap-padding the tail batch instead of dropping it.  All arrays share
    one row order; returns ``(*stacked, mask, num_batches)``.  (A copy of
    the JAX package's numpy function.)"""
    n_rows = len(arrays[0])
    if n_rows == 0:
        raise ValueError("empty dataset")
    if any(len(a) != n_rows for a in arrays):
        raise ValueError("epoch arrays must share their row count")
    nb = -(-n_rows // batch_size)  # ceil: pad up, never drop
    rows = nb * batch_size
    idx = np.arange(rows) % n_rows
    mask = (np.arange(rows) < n_rows).astype(np.float32)
    shape = (nb, batch_size)
    stacked = tuple(np.asarray(a)[idx].reshape(shape + np.asarray(a).shape[1:])
                    for a in arrays)
    return stacked + (mask.reshape(shape), nb)


def batch_epoch_data(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Stack a flat epoch into (num_batches, batch, ...) + mask,
    wrap-padding the tail batch instead of dropping it."""
    xb, yb, mask, nb = batch_epoch_arrays(batch_size, x, y)
    return xb, yb, mask, nb


def init_state(model: Sequential, generator: Optional[torch.Generator],
               input_shape, optimizer, learning_rate=None, lr_schedule=None,
               total_steps=None, gradient_accumulation: int = 1,
               gradient_clip_norm=None
               ) -> Tuple[TrainState, opt_lib.Transform]:
    """Build the model's parameters for ``input_shape`` from ``generator``
    and the optimizer state for them."""
    model.build(input_shape, generator=generator)
    params = model_params(model)
    tx, opt_state = opt_lib.build(optimizer, params, learning_rate,
                                  lr_schedule, total_steps,
                                  gradient_accumulation, gradient_clip_norm)
    return TrainState(params, opt_state, 0), tx
