"""Trainers, port of ``distkeras_tpu/trainers.py``: the ``Trainer`` base
and ``SingleTrainer``.

The constructor keywords are the JAX package's (``keras_model``,
``worker_optimizer``, ``loss``, ``batch_size``, ``features_col``,
``label_col``, ``num_epoch``, ``lr_schedule``, ``gradient_accumulation``,
``gradient_clip_norm``, early stopping), and ``train(dataset) ->
FittedModel``, ``get_history()`` and ``get_training_time()`` behave the
same, plus ``device`` (``None`` means the CUDA card, and raises without
one).  The distributed trainers (ADAG, DOWNPOUR, AEASGD, EAMSGD, DynSGD,
Averaging, Ensemble) and their engines arrive with later slices, as do
sequence packing (``segment_col``) and the Keras adapter.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

import numpy as np
import torch

from .core import optimizers as opt_lib
from .core.layers import Layer
from .core.losses import get_loss
from .core.model import FittedModel, Sequential, load_jax_weights
from .core.train import (TrainState, batch_epoch_arrays, make_epoch_runner,
                         model_params)
from .data.dataset import Dataset
from .device import DeviceLike, resolve_device


def _as_model(keras_model) -> Sequential:
    """Accept a Sequential or a FittedModel (whose weights then start the
    training).  The Keras adapter is not ported: a Keras model raises."""
    if isinstance(keras_model, Sequential):
        return keras_model
    if isinstance(keras_model, FittedModel):
        return keras_model.model
    raise TypeError(f"Cannot interpret model {type(keras_model)}: the port "
                    "takes a Sequential or a FittedModel (the Keras adapter "
                    "is not ported yet)")


def _require_masked_loss(loss):
    """The one segment_col loss rule: packed labels carry -1 sentinels,
    which a plain sparse CE would clamp to class 0 and silently train
    document boundaries wrong."""
    if isinstance(loss, str) and "masked" not in loss:
        raise ValueError(
            f"segment_col needs a *_masked loss (packed labels mark "
            f"cross-document/padding positions -1), got {loss!r} — use "
            "e.g. 'sparse_categorical_crossentropy_masked_from_logits'")


def _on_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host column on the device; float64 becomes float32, as JAX (with
    64-bit mode off) stores it."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


class Trainer:
    """Abstract base: the model spec, loss and worker optimizer, the
    wall-clock bookkeeping (``record_training_start/stop``,
    ``get_training_time``) and validation with early stopping."""

    def __init__(self, keras_model, loss: str = "categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate: Optional[float] = None,
                 seed: int = 0, lr_schedule=None,
                 gradient_accumulation: int = 1,
                 gradient_clip_norm: Optional[float] = None,
                 early_stopping_patience: Optional[int] = None,
                 early_stopping_min_delta: float = 0.0,
                 device: DeviceLike = None):
        self.master_model = _as_model(keras_model)
        self.device = resolve_device(device)
        self.loss = loss
        self.worker_optimizer = worker_optimizer
        self.learning_rate = learning_rate
        # ``lr_schedule`` is a name/dict/callable resolved by
        # ``core.optimizers.get_schedule`` against the trainer's own
        # total-update count; ``gradient_accumulation`` = K averages K
        # mini-step gradients per optimizer update
        self.lr_schedule = lr_schedule
        self.gradient_accumulation = int(gradient_accumulation)
        if self.gradient_accumulation < 1:
            raise ValueError("gradient_accumulation must be >= 1")
        self.gradient_clip_norm = (float(gradient_clip_norm)
                                   if gradient_clip_norm is not None
                                   else None)
        if self.gradient_clip_norm is not None \
                and self.gradient_clip_norm <= 0:
            raise ValueError("gradient_clip_norm must be > 0")
        # early stopping on validation loss (train(validation_data=...)):
        # stop after `patience` epochs without > min_delta improvement
        self.early_stopping_patience = (
            int(early_stopping_patience)
            if early_stopping_patience is not None else None)
        if self.early_stopping_patience is not None \
                and self.early_stopping_patience < 1:
            raise ValueError("early_stopping_patience must be >= 1")
        self.early_stopping_min_delta = float(early_stopping_min_delta)
        self.validation_history: List[float] = []
        self.stopped_epoch: Optional[int] = None
        self.seed = seed
        self.history: List[float] = []
        self.training_time = 0.0
        self._time_start: Optional[float] = None
        self._fitted: Optional[FittedModel] = None
        if isinstance(keras_model, FittedModel):
            self._initial_weights = keras_model.get_weights()
        else:
            self._initial_weights = None

    # -- timing ------------------------------------------------------------
    def record_training_start(self):
        self.training_time = 0.0
        self._time_start = time.time()

    def record_training_stop(self):
        if self._time_start is None:
            raise RuntimeError("record_training_stop before "
                               "record_training_start")
        self.training_time = time.time() - self._time_start

    def get_training_time(self) -> float:
        return self.training_time

    def get_history(self) -> List[float]:
        return self.history

    # -- model plumbing ----------------------------------------------------
    def _initial_params(self, input_shape) -> Sequential:
        """A fresh copy of the master model on the trainer's device, its
        parameters drawn from ``seed`` (a torch generator: not the JAX
        package's numbers) or, when the trainer was given a FittedModel,
        that model's weights.  The master model itself is left as it
        was, as the JAX package leaves its params."""
        spec = json.loads(self.master_model.to_json())
        model = Sequential([Layer.from_config(c) for c in spec["layers"]],
                           compute_dtype=spec["compute_dtype"],
                           name=spec["name"], device=self.device)
        model.build(input_shape,
                    generator=torch.Generator().manual_seed(self.seed))
        if self._initial_weights is not None:
            load_jax_weights(model, self._initial_weights)
        return model

    def serialize(self) -> dict:
        """Serialized trained model."""
        if self._fitted is not None:
            return self._fitted.serialize()
        raise ValueError("Trainer has no fitted model yet; call train() first")

    def train(self, dataset: Dataset, shuffle: bool = False) -> FittedModel:
        raise NotImplementedError

    # -- validation / early stopping -----------------------------------------
    def _setup_validation(self, validation_data: Optional[Dataset]):
        if validation_data is None:
            if self.early_stopping_patience is not None:
                raise ValueError(
                    "early_stopping_patience needs validation_data passed "
                    "to train()")
            return None
        xv = _on_device(validation_data[self.features_col], self.device)
        yv = _on_device(validation_data[self.label_col], self.device)
        loss_fn = get_loss(self.loss)

        def val_loss(model: Sequential) -> float:
            with torch.no_grad():
                return float(loss_fn(yv, model(xv, train=False)))

        self.validation_history = []
        self._val_best = float("inf")
        self._val_bad = 0
        return val_loss

    def _validate_epoch(self, val_fn, model: Sequential, epoch: int) -> bool:
        """Record this epoch's validation loss; True → stop now (no
        improvement > min_delta for ``early_stopping_patience`` epochs)."""
        vl = val_fn(model)
        self.validation_history.append(vl)
        patience = self.early_stopping_patience
        if patience is None:
            return False
        if vl < self._val_best - self.early_stopping_min_delta:
            self._val_best = vl
            self._val_bad = 0
            return False
        self._val_bad += 1
        if self._val_bad >= patience:
            self.stopped_epoch = epoch
            return True
        return False


class SingleTrainer(Trainer):
    """Single-device trainer: one card (or the CPU), one epoch at a time as
    a loop of masked steps over the stacked minibatches."""

    def __init__(self, keras_model, features_col: str = "features",
                 label_col: str = "label", batch_size: int = 32,
                 num_epoch: int = 1, loss: str = "categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=None, seed: int = 0,
                 lr_schedule=None, gradient_accumulation: int = 1,
                 gradient_clip_norm: Optional[float] = None,
                 early_stopping_patience: Optional[int] = None,
                 early_stopping_min_delta: float = 0.0,
                 segment_col: Optional[str] = None,
                 device: DeviceLike = None):
        if segment_col is not None:
            _require_masked_loss(loss)
            raise NotImplementedError(
                "segment_col (sequence packing, data/packing.py) is not "
                "ported yet")
        super().__init__(keras_model, loss, worker_optimizer, learning_rate,
                         seed, lr_schedule, gradient_accumulation,
                         gradient_clip_norm, early_stopping_patience,
                         early_stopping_min_delta, device)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)

    def train(self, dataset: Dataset, shuffle: bool = False,
              validation_data: Optional[Dataset] = None) -> FittedModel:
        self.record_training_start()
        x = dataset[self.features_col]
        y = dataset[self.label_col]
        model = self._initial_params(x.shape[1:])
        # schedule horizon = optimizer updates over the whole run: ceil-div
        # mini-steps by the accumulation factor
        steps_per_epoch = -(-len(x) // self.batch_size)
        total_updates = -(-steps_per_epoch * self.num_epoch
                          // self.gradient_accumulation)
        params = model_params(model)
        tx, opt_state = opt_lib.build(
            self.worker_optimizer, params, self.learning_rate,
            self.lr_schedule, total_updates, self.gradient_accumulation,
            self.gradient_clip_norm)
        state = TrainState(params, opt_state, 0)
        runner = make_epoch_runner(model, self.loss, tx)
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed + 1)
        val_fn = self._setup_validation(validation_data)
        cols = Dataset({"x": x, "y": y})
        for epoch in range(self.num_epoch):
            ds = cols.shuffle(self.seed + epoch) if shuffle else cols
            xb, yb, mb, _ = batch_epoch_arrays(self.batch_size, ds["x"],
                                               ds["y"])
            state, losses = runner(state, _on_device(xb, self.device),
                                   _on_device(yb, self.device), mb,
                                   generator)
            self.history.extend(losses.tolist())
            if val_fn is not None and self._validate_epoch(val_fn, model,
                                                           epoch):
                break
        self._fitted = FittedModel(model)
        self.record_training_stop()
        return self._fitted
