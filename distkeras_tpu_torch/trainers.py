"""Trainers, port of ``distkeras_tpu/trainers.py``: ``SingleTrainer`` and
the distributed trainers (``ADAG``, ``DOWNPOUR``, ``DynSGD``, ``AEASGD``,
``EAMSGD``, ``AveragingTrainer``, ``EnsembleTrainer``) on the SPMD engine
(``parallel/spmd.py``).

The constructor keywords are the JAX package's (``keras_model``,
``worker_optimizer``, ``loss``, ``num_workers``, ``batch_size``,
``features_col``, ``label_col``, ``num_epoch``, ``communication_window``,
``rho``, ``momentum``, ``lr_schedule``, ``gradient_accumulation``,
``gradient_clip_norm``, early stopping, checkpoints, metrics), and
``train(dataset) -> FittedModel``, ``get_history()`` and
``get_training_time()`` behave the same, plus ``device`` (``None`` means
the CUDA card, and raises without one).  The distributed trainers run on
a worker mesh (``parallel.get_mesh``): by default one worker per visible
card; ``mesh=get_mesh(N, devices=[device] * N)`` runs N workers on one
device.  ``segment_col`` trains on packed rows (``data/packing.py``) with
a ``*_masked`` loss, on ``SingleTrainer`` and on the SPMD engine.

``execution="host_ps"`` runs the asynchronous family (ADAG, DOWNPOUR,
DynSGD, AEASGD, EAMSGD) against a live socket parameter server on
loopback (``parameter_servers.py``): ``num_workers × parallelism_factor``
worker threads, each training its own copy of the model on the trainer's
one device (``workers.py``), with the dense wire codings, top-k and
row-sparse commits, both server cores, ``comm_overlap`` and the center
sharded over ``ps_shards`` servers (``ps_sharding.py``).  What waits for
later slices raises: the process engine (``execution="process_ps"``),
recovery, the elastic and streaming engines and fault injection (ROADMAP
queue A item 6), the orbax checkpoint backend and the Keras adapter.
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
                         make_packed_epoch_runner, model_params)
from .data.dataset import Dataset
from .data.pipeline import num_rounds
from .device import DeviceLike, host_to_device, resolve_device
from .parallel import mesh as mesh_lib
from .parallel import rules
from .parallel.spmd import DistState, SPMDEngine, shape_epoch_data


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

    def _model_from(self, params, input_shape) -> Sequential:
        """A fresh copy of the master model holding ``params`` (path →
        tensor, the JAX leaf order)."""
        model = self._initial_params(input_shape)
        with torch.no_grad():
            for p, v in zip(model_params(model).values(), params.values()):
                p.copy_(v)
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
        xv = host_to_device(validation_data[self.features_col], self.device)
        yv = host_to_device(validation_data[self.label_col], self.device)
        loss_fn = get_loss(self.loss)
        # packed validation: the segment ids keep attention's document
        # isolation, and the *_masked loss drops the label -1 positions
        # across documents and on padding, as in training
        seg_col = getattr(self, "segment_col", None)
        if seg_col is not None and seg_col not in validation_data:
            raise ValueError(
                f"validation_data lacks the segment column {seg_col!r} — "
                "pack it the same way as the training corpus "
                "(data/packing.py)")
        sv = (host_to_device(validation_data[seg_col], self.device)
              if seg_col is not None else None)

        def val_loss(model: Sequential) -> float:
            with torch.no_grad():
                return float(loss_fn(yv, model(xv, train=False,
                                               segment_ids=sv)))

        self.validation_history = []
        self._val_best = float("inf")
        self._val_bad = 0
        return val_loss

    def _validate_epoch(self, val_fn, model: Sequential, epoch: int,
                        metrics=None) -> bool:
        """Record this epoch's validation loss; True → stop now (no
        improvement > min_delta for ``early_stopping_patience`` epochs)."""
        vl = val_fn(model)
        self.validation_history.append(vl)
        if metrics is not None:
            metrics.logger.log(kind="val", epoch=epoch, val_loss=vl)
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
        super().__init__(keras_model, loss, worker_optimizer, learning_rate,
                         seed, lr_schedule, gradient_accumulation,
                         gradient_clip_norm, early_stopping_patience,
                         early_stopping_min_delta, device)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        # sequence packing (data/packing.py): the segment-ids column;
        # attention isolates documents and the *_masked loss drops the
        # label -1 positions across them
        self.segment_col = segment_col

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
        packed = self.segment_col is not None
        runner = (make_packed_epoch_runner(model, self.loss, tx) if packed
                  else make_epoch_runner(model, self.loss, tx))
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed + 1)
        val_fn = self._setup_validation(validation_data)
        cols = {"x": x, "y": y}
        if packed:
            cols["s"] = dataset[self.segment_col]
        cols = Dataset(cols)
        for epoch in range(self.num_epoch):
            ds = cols.shuffle(self.seed + epoch) if shuffle else cols
            *stacked, mb, _ = batch_epoch_arrays(
                self.batch_size, *(ds[k] for k in cols.columns))
            state, losses = runner(
                state, *(host_to_device(a, self.device) for a in stacked),
                mb, generator)
            self.history.extend(losses.tolist())
            if val_fn is not None and self._validate_epoch(val_fn, model,
                                                           epoch):
                break
        self._fitted = FittedModel(model)
        self.record_training_stop()
        return self._fitted


#: the execution engines of the port's distributed trainers
_ENGINES = ("spmd", "host_ps")


class DistributedTrainer(Trainer):
    """Base of the multi-worker trainers: the worker count, batch and
    window, and the ``train()`` lifecycle on the SPMD engine, or on the
    host parameter server with ``execution="host_ps"``.  The JAX
    package's ``service()`` (the parameter server's start) maps to the
    SPMD engine's construction here.

    On ``"spmd"`` the workers are a mesh (``parallel.get_mesh``: one per
    card by default).  On ``"host_ps"`` ``num_workers`` (default 1) counts
    worker threads that all run on the trainer's one device; a ``mesh``
    given there only names that device and the count."""

    ALGORITHM = "local"
    DEFAULT_WINDOW = 5

    def __init__(self, keras_model, num_workers: Optional[int] = None,
                 batch_size: int = 32, features_col: str = "features",
                 label_col: str = "label", num_epoch: int = 1,
                 communication_window: Optional[int] = None,
                 loss: str = "categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=None,
                 execution: str = "spmd", mesh=None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 checkpoint_unit: str = "epoch",
                 checkpoint_backend: str = "npz",
                 metrics_path: Optional[str] = None,
                 wire_dtype: Optional[str] = None,
                 wire_topk: float = 0.01,
                 wire_topk_dtype: Optional[str] = None,
                 lr_schedule=None, gradient_accumulation: int = 1,
                 gradient_clip_norm: Optional[float] = None,
                 early_stopping_patience: Optional[int] = None,
                 early_stopping_min_delta: float = 0.0,
                 fault_tolerance: bool = False,
                 fault_injection: Optional[dict] = None,
                 segment_col: Optional[str] = None,
                 device: DeviceLike = None):
        if execution == "process_ps":
            raise NotImplementedError(
                "execution='process_ps': the cross-process parameter-server "
                "engine is not ported yet (ROADMAP queue A item 6); use "
                "execution='host_ps' or 'spmd'")
        if execution not in _ENGINES:
            raise ValueError(f"unknown execution {execution!r}; the port "
                             f"runs execution in {list(_ENGINES)}")
        if segment_col is not None:
            _require_masked_loss(loss)
        if execution == "host_ps" and mesh is None:
            # worker threads on one device: the count is not a mesh
            workers = 1 if num_workers is None else int(num_workers)
            if workers < 1:
                raise ValueError(f"num_workers must be >= 1, got {workers}")
            worker_dev = resolve_device(device)
        else:
            if mesh is None:
                mesh = mesh_lib.get_mesh(
                    num_workers, devices=None if device is None else [device])
            worker_dev = mesh_lib.worker_device(mesh)
            if device is not None and not mesh_lib.same_device(
                    resolve_device(device), worker_dev):
                raise ValueError(f"device={device!r} but the worker mesh is "
                                 f"on {worker_dev}")
            workers = int(mesh.devices.size)
        super().__init__(keras_model, loss, worker_optimizer, learning_rate,
                         seed, lr_schedule, gradient_accumulation,
                         gradient_clip_norm, early_stopping_patience,
                         early_stopping_min_delta, worker_dev)
        # sequence packing on the SPMD engine (the distributed twin of
        # SingleTrainer(segment_col=...)): the segment-ids column
        self.segment_col = segment_col
        self.mesh = mesh
        self.num_workers = workers
        self.batch_size = int(batch_size)
        self.features_col = features_col
        self.label_col = label_col
        self.num_epoch = int(num_epoch)
        self.communication_window = int(
            communication_window if communication_window is not None
            else self.DEFAULT_WINDOW)
        self.execution = execution
        # the wire codings of the parameter-server commits, checked as the
        # JAX class checks them (its messages): host_ps takes the dense
        # codings (bfloat16, float16, int8) and sparse top-k ("topk", its
        # density wire_topk, its value code wire_topk_dtype); the SPMD
        # engine has no wire, and where the JAX class ignores a coding
        # there the port refuses it
        if wire_dtype == "topk":
            if not 0.0 < float(wire_topk) <= 1.0:
                raise ValueError(
                    f"wire_topk must be a density in (0, 1], got "
                    f"{float(wire_topk)}")
            if wire_topk_dtype not in (None, "bfloat16", "int8"):
                raise ValueError(
                    "wire_topk_dtype must be None, 'bfloat16' or 'int8', "
                    f"got {wire_topk_dtype!r}")
        elif wire_topk_dtype is not None:
            raise ValueError(
                "wire_topk_dtype applies to wire_dtype='topk' only")
        if execution == "spmd" and (wire_dtype is not None
                                    or float(wire_topk) != 0.01):
            raise NotImplementedError(
                "wire_dtype/wire_topk code the parameter-server commits "
                "(execution='host_ps'); the SPMD engine has no wire: leave "
                "them unset")
        self.wire_dtype = wire_dtype
        self.wire_topk = float(wire_topk)
        self.wire_topk_dtype = wire_topk_dtype
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(int(checkpoint_every), 1)
        if checkpoint_unit not in ("epoch", "round"):
            raise ValueError("checkpoint_unit must be 'epoch' or 'round'")
        # 'round': checkpoints between rounds, on the global round clock
        # (DistState.round_idx); 'epoch': between epochs
        self.checkpoint_unit = checkpoint_unit
        if checkpoint_backend not in ("npz", "orbax"):
            raise ValueError("checkpoint_backend must be 'npz' or 'orbax'")
        if checkpoint_backend == "orbax":
            raise NotImplementedError(
                "checkpoint_backend='orbax' is not ported (no orbax in the "
                "port); use 'npz'")
        self.checkpoint_backend = checkpoint_backend
        self.metrics_path = metrics_path
        # worker death on the PS engines; refused at train() on the SPMD
        # engine, whose recovery is checkpoint_dir + train(resume=True)
        self.fault_tolerance = bool(fault_tolerance)
        self.fault_injection = fault_injection
        self.metrics: List[dict] = []
        self._engine: Optional[SPMDEngine] = None
        self._state: Optional[DistState] = None

    # -- engine lifecycle --------------------------------------------------
    def _elastic_alpha(self) -> Optional[float]:
        return None

    def service(self, input_shape) -> SPMDEngine:
        engine = SPMDEngine(
            self._initial_params(input_shape), self.loss,
            self.worker_optimizer, self.mesh, self.ALGORITHM,
            self.communication_window, self.learning_rate,
            alpha=self._elastic_alpha(), lr_schedule=self.lr_schedule,
            schedule_steps=getattr(self, "_schedule_steps", None),
            gradient_accumulation=self.gradient_accumulation,
            gradient_clip_norm=self.gradient_clip_norm,
            packed=self.segment_col is not None)
        self._state = engine.init_state()
        return engine

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False,
              validation_data: Optional[Dataset] = None) -> FittedModel:
        if self.execution == "host_ps":
            if (validation_data is not None
                    or self.early_stopping_patience is not None):
                raise ValueError(
                    "validation_data/early stopping run between SPMD "
                    "epochs; the async PS engines have no between-epoch "
                    "hook (workers own their epoch loops) — use "
                    "execution='spmd'")
            if self.segment_col is not None:
                raise ValueError(
                    "segment_col (packed training) runs on the SPMD engine "
                    "only — the PS workers don't thread segment ids; use "
                    "execution='spmd'")
            if self.fault_tolerance or self.fault_injection:
                raise NotImplementedError(
                    "fault_tolerance/fault_injection on execution='host_ps' "
                    "are not ported yet (ROADMAP queue A item 6)")
            from .parameter_servers import run_host_ps_training
            return run_host_ps_training(self, dataset, shuffle,
                                        resume=resume)
        if self.fault_tolerance or self.fault_injection:
            raise ValueError(
                "fault_tolerance/fault_injection apply to the PS engines "
                "(execution='host_ps'/'process_ps'); the SPMD program is "
                "bulk-synchronous — a lost participant is a lost collective, "
                "and its recovery story is checkpoint_dir + train("
                "resume=True)")
        self.record_training_start()
        # before any resource (checkpoint directory, metrics file) opens:
        # a bad validation config must not leak them
        val_fn = self._setup_validation(validation_data)
        x = np.asarray(dataset[self.features_col])
        y = np.asarray(dataset[self.label_col])
        seg = (np.asarray(dataset[self.segment_col])
               if self.segment_col is not None else None)
        self._input_shape = x.shape[1:]
        rpe = num_rounds(len(x), self.num_workers, self.communication_window,
                         self.batch_size)  # rounds per epoch (constant)
        # per-worker optimizer updates over the run (the LR-schedule
        # horizon): rounds × window mini-steps per epoch, ceil-divided by
        # the accumulation factor
        self._schedule_steps = -(-rpe * self.communication_window
                                 * self.num_epoch
                                 // self.gradient_accumulation)
        engine = self.service(self._input_shape)
        self._engine = engine
        ckpt = None
        start_epoch = 0
        skip_rounds = 0  # rounds of start_epoch already done (round unit)
        if resume and self.checkpoint_dir is None:
            raise ValueError("train(resume=True) needs checkpoint_dir")
        if self.checkpoint_dir is not None:
            from .checkpoint import foreign_checkpoints, make_checkpointer
            ckpt = make_checkpointer(self.checkpoint_dir,
                                     self.checkpoint_backend)
            latest = ckpt.latest_step()
            if resume and latest is None:
                foreign = foreign_checkpoints(self.checkpoint_dir,
                                              self.checkpoint_backend)
                if foreign:
                    raise ValueError(
                        f"resume=True with checkpoint_backend="
                        f"{self.checkpoint_backend!r}, but "
                        f"{self.checkpoint_dir} holds steps {foreign} "
                        "written by the other backend — resuming now would "
                        "silently retrain from scratch; use the backend "
                        "that wrote the checkpoints")
            if resume and latest is not None:
                # a step number only means what the saving run meant by
                # it: refuse to read epoch steps as rounds or vice versa
                meta = ckpt.read_meta(latest)
                saved_unit = meta.get("unit", "epoch")
                if meta.get("engine", "spmd") != "spmd" \
                        or saved_unit != self.checkpoint_unit:
                    raise ValueError(
                        f"checkpoint at {self.checkpoint_dir} was saved by "
                        f"engine={meta.get('engine', 'spmd')!r} with "
                        f"checkpoint_unit={saved_unit!r}; this trainer is "
                        f"spmd/{self.checkpoint_unit!r} — resume with the "
                        "same configuration")
                if self.checkpoint_unit == "round" and \
                        meta.get("rounds_per_epoch") not in (None, rpe):
                    raise ValueError(
                        f"checkpoint was saved with rounds_per_epoch="
                        f"{meta['rounds_per_epoch']} but this configuration "
                        f"gives {rpe} (batch_size/communication_window/"
                        "dataset size changed) — resume with the same "
                        "configuration")
                self._state = engine.put_state(
                    ckpt.restore(self._state, latest))
                if self.checkpoint_unit == "round":
                    # step k = global round clock after k rounds
                    start_epoch, skip_rounds = divmod(latest, rpe)
                else:
                    # step k = state after k epochs
                    start_epoch = latest
        from .metrics import EpochMetrics, MetricsLogger
        # every worker of the mesh runs on one card
        metrics = EpochMetrics(MetricsLogger(self.metrics_path), num_chips=1)
        self.metrics = metrics.logger.events
        rngs = engine.worker_rngs(self.seed + 17)
        try:
            for epoch in range(start_epoch, self.num_epoch):
                t0 = time.time()
                if shuffle:
                    # deterministic per-epoch reshuffle
                    perm = np.random.default_rng(
                        self.seed + epoch).permutation(len(x))
                    xe, ye = x[perm], y[perm]
                    se = seg[perm] if seg is not None else None
                else:
                    xe, ye, se = x, y, seg
                shaped = shape_epoch_data(
                    xe, ye, self.num_workers, self.communication_window,
                    self.batch_size, columns_seg=se)
                if se is not None:
                    xb, yb, sb, mb, rounds = shaped
                    sb = host_to_device(sb, self.device)
                else:
                    (xb, yb, mb, rounds), sb = shaped, None
                xb = host_to_device(xb, self.device)
                yb = host_to_device(yb, self.device)
                first = skip_rounds if epoch == start_epoch else 0
                if self.checkpoint_unit == "round" and ckpt is not None:
                    # round by round, checkpointable mid-epoch on the
                    # global round clock; the same rounds as run_epoch.
                    # The losses stay on the device until the epoch ends.
                    losses = []
                    done = self._state.round_idx
                    for r in range(first, rounds):
                        self._state, loss = engine.run_round(
                            self._state, xb[r], yb[r], mb[r], rngs,
                            s=sb[r] if sb is not None else None)
                        losses.append(loss)
                        done += 1
                        if done % self.checkpoint_every == 0:
                            ckpt.save(done, self._state,
                                      meta={"engine": "spmd",
                                            "unit": "round",
                                            "rounds_per_epoch": rpe})
                    losses = (torch.stack(losses).cpu().numpy()
                              if losses else np.zeros((0,), np.float32))
                else:
                    self._state, losses = engine.run_epoch(
                        self._state, xb, yb, mb, rngs, sb=sb)
                    losses = losses.cpu().numpy()
                self.history.extend(losses.tolist())
                # every real row trains exactly once (the tail is padded
                # and masked, not dropped); a resumed partial epoch counts
                # the real rows of its remaining rounds (mask sum)
                examples = (len(xe) if first == 0
                            else int(mb[first:].sum()))
                metrics.epoch(epoch, examples, time.time() - t0,
                              float(losses.mean()) if len(losses) else 0.0)
                if (ckpt is not None and self.checkpoint_unit == "epoch"
                        and (epoch + 1) % self.checkpoint_every == 0):
                    ckpt.save(epoch + 1, self._state,
                              meta={"engine": "spmd", "unit": "epoch"})
                if val_fn is not None and self._validate_epoch(
                        val_fn, self._model_from(self._state.center,
                                                 self._input_shape),
                        epoch, metrics):
                    break
        finally:
            metrics.logger.close()
            if ckpt is not None:
                ckpt.close()
        self._fitted = FittedModel(self._model_from(self._state.center,
                                                    self._input_shape))
        self.record_training_stop()
        return self._fitted


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Base of the asynchronous family.  On the SPMD engine the async
    commits execute as deterministic rounds (``parallel/spmd.py``); with
    ``execution="host_ps"`` they run against a live socket parameter
    server (``parameter_servers.py``).

    The host-PS knobs of the JAX class that the port runs:
    ``parallelism_factor`` (``num_workers × parallelism_factor`` worker
    threads), ``comm_overlap`` (one combined commit+pull round trip per
    window, received while the next window computes; ``None`` resolves
    per algorithm: ON for DOWNPOUR/ADAG/DynSGD, OFF for the elastic
    family), ``ps_core`` (``"event"`` or ``"threaded"``), ``coalesce`` and
    ``apply_kernel``, the address pair ``ps_bind_host`` /
    ``ps_advertise_host``, ``ps_shards`` (the center partitioned over N
    shard servers, ``ps_sharding.py``) and ``row_sparse`` (exact
    touched-row commits of embedding tables; it pins the serial loop).
    Each is checked as the JAX class checks it, and a value the JAX class
    refuses is refused here with the same ``ValueError``.  The knobs of the
    engines still to come (``recovery``, ``elastic``, ``stream``,
    ``partition_windows``) raise ``NotImplementedError`` on ``host_ps``
    (ROADMAP queue A item 6).
    """

    #: algorithms whose per-algorithm comm_overlap default is ON
    _OVERLAP_DEFAULT_ON = ("downpour", "adag", "dynsgd")

    def __init__(self, keras_model, *, parallelism_factor: int = 1,
                 comm_overlap: Optional[bool] = None, ps_shards: int = 1,
                 recovery: bool = False, recovery_policy=None,
                 elastic: bool = False,
                 lease_windows: Optional[int] = None,
                 lease_timeout: float = 5.0,
                 ps_core: str = "event", coalesce: bool = True,
                 apply_kernel: Optional[str] = None,
                 stream: bool = False,
                 horizon_windows: Optional[int] = None,
                 max_horizons: Optional[int] = None,
                 row_sparse=None,
                 ps_bind_host: Optional[str] = None,
                 ps_advertise_host: Optional[str] = None,
                 ps_placement: str = "driver",
                 partition_windows: int = 0,
                 freeze_deadline: Optional[float] = None,
                 scratch_dir: Optional[str] = None,
                 **kw):
        super().__init__(keras_model, **kw)
        host_ps = self.execution == "host_ps"
        ps_only = ("applies to the parameter-server engines "
                   "(execution='host_ps'/'process_ps'); the SPMD engine "
                   "has no parameter server")
        refusals = (
            (int(parallelism_factor) < 1,
             "parallelism_factor must be >= 1"),
            (int(parallelism_factor) > 1 and not host_ps,
             "parallelism_factor > 1 requires execution='host_ps' (the "
             "SPMD engine runs exactly one worker per mesh slot)"),
            (comm_overlap is not None and not host_ps,
             f"comm_overlap {ps_only}"),
            (int(ps_shards) < 1, "ps_shards must be >= 1"),
            (int(ps_shards) > 1 and not host_ps, f"ps_shards > 1 {ps_only}"),
            (bool(recovery) and not host_ps,
             "recovery=True requires a PS engine; the SPMD engine's "
             "recovery story is checkpoint_dir + train(resume=True)"),
            (bool(elastic) and not host_ps,
             "elastic=True requires a PS engine; the SPMD engine is "
             "bulk-synchronous — a lost participant is a lost collective"),
            (lease_windows is not None and int(lease_windows) < 1,
             "lease_windows must be >= 1"),
            (float(lease_timeout) <= 0, "lease_timeout must be > 0"),
            (ps_core not in ("event", "threaded"),
             f"ps_core must be one of ['event', 'threaded'], got "
             f"{ps_core!r}"),
            (apply_kernel not in (None, "numpy", "native", "auto"),
             f"apply_kernel must be one of (None, 'numpy', 'native', "
             f"'auto'), got {apply_kernel!r}"),
            ((ps_core != "event" or not coalesce
              or apply_kernel is not None) and not host_ps,
             f"ps_core/coalesce/apply_kernel {ps_only}"),
            (bool(stream) and not host_ps,
             "stream=True requires execution='host_ps'"),
            (horizon_windows is not None and int(horizon_windows) < 1,
             "horizon_windows must be >= 1"),
            (horizon_windows is not None and not stream,
             "horizon_windows applies to stream=True"),
            (max_horizons is not None and int(max_horizons) < 1,
             "max_horizons must be >= 1"),
            (max_horizons is not None and not stream,
             "max_horizons applies to stream=True"),
            (bool(row_sparse) and not host_ps,
             "row_sparse requires execution='host_ps' (the SPMD "
             "engine exchanges deltas over ICI; process_ps ships "
             "config as JSON and keeps dense commits)"),
            (bool(row_sparse) and self.ALGORITHM not in
             self._OVERLAP_DEFAULT_ON,
             "row_sparse applies to the delta family (DOWNPOUR/ADAG/"
             "DynSGD); the elastic family's force term is dense by "
             "construction"),
            (bool(row_sparse) and self.wire_dtype is not None,
             "row_sparse is the exact sparse profile and does not compose "
             "with lossy wire_dtype codings — use wire_dtype=None"),
            (ps_bind_host == "" or ps_advertise_host == "",
             "ps_bind_host/ps_advertise_host must be a host string or None "
             "(empty string is neither bindable nor dialable)"),
            ((ps_bind_host is not None or ps_advertise_host is not None)
             and not host_ps, f"ps_bind_host/ps_advertise_host {ps_only}"),
            (ps_placement not in ("driver", "process"),
             f"ps_placement must be 'driver' or 'process', got "
             f"{ps_placement!r}"),
            (int(partition_windows) < 0, "partition_windows must be >= 0"),
            (freeze_deadline is not None and float(freeze_deadline) <= 0,
             "freeze_deadline must be > 0"),
            (ps_placement == "process" or freeze_deadline is not None
             or scratch_dir is not None,
             "ps_placement='process'/freeze_deadline/scratch_dir apply to "
             "the supervised cross-process engine — execution='process_ps' "
             "with elastic=True"),
            (int(partition_windows) != 0 and not host_ps,
             f"partition_windows {ps_only}"),
            (int(partition_windows) != 0 and int(ps_shards) > 1,
             "partition_windows requires ps_shards=1 — sharded workers "
             "heal by blocking reconnect-resume (lease stealing already "
             "guarantees zero lost examples)"),
            (int(partition_windows) != 0 and bool(recovery),
             "partition_windows with recovery is a process_ps feature — "
             "host_ps recovery routes workers through the sharded client"),
        )
        for refused, message in refusals:
            if refused:
                raise ValueError(message)
        # the knobs of the host-PS engines still to come
        for knob, is_set in (("recovery=True", bool(recovery)),
                             ("elastic=True", bool(elastic)),
                             ("stream=True", bool(stream)),
                             ("partition_windows",
                              int(partition_windows) != 0)):
            if is_set:
                raise NotImplementedError(
                    f"{knob} on execution='host_ps' is not ported yet "
                    "(ROADMAP queue A item 6)")
        if host_ps:
            # resolved eagerly, as the JAX class does: 'native' raises here
            # (the port's build of the apply kernel waits for item 8)
            from . import applykernel
            applykernel.resolve(apply_kernel)
        self.parallelism_factor = int(parallelism_factor)
        self._comm_overlap = comm_overlap
        self.ps_shards = int(ps_shards)
        self.recovery = bool(recovery)
        self.elastic = bool(elastic)
        self.lease_windows = (None if lease_windows is None
                              else int(lease_windows))
        self.lease_timeout = float(lease_timeout)
        self.ps_core = str(ps_core)
        self.coalesce = bool(coalesce)
        self.apply_kernel = apply_kernel
        self.ps_bind_host = ps_bind_host
        self.ps_advertise_host = ps_advertise_host
        # row-sparse embedding commits: True detects every Embedding table
        # of the model (streaming.resolve_row_sparse_tables), or explicit
        # weight-list indices; each table's window delta ships as an exact
        # networking.RowSparseDelta beside the dense rest
        self.row_sparse = row_sparse if row_sparse else None

    @property
    def comm_overlap(self) -> bool:
        """The host-PS transport pipelining in effect: the explicit knob,
        else ON for the delta family and OFF for the elastic family.
        ``row_sparse`` pins the serial loop: its window step is itself one
        blocking 'u' round trip (commit + fresh center, atomically)."""
        if self.row_sparse is not None:
            return False
        if self._comm_overlap is not None:
            return bool(self._comm_overlap)
        return self.ALGORITHM in self._OVERLAP_DEFAULT_ON


class SynchronousDistributedTrainer(DistributedTrainer):
    """Base of the synchronous family (the parallelism factor is 1, as
    upstream)."""


class DOWNPOUR(AsynchronousDistributedTrainer):
    """DistBelief-style async SGD: workers push raw accumulated deltas
    every window (default 5) and re-pull the center.  SPMD form: center +=
    Σᵢ Δᵢ each round."""
    ALGORITHM = "downpour"
    DEFAULT_WINDOW = 5


class ADAG(AsynchronousDistributedTrainer):
    """Asynchronous Distributed Adaptive Gradients, the north-star
    algorithm: window deltas normalized over the commit count before the
    apply, in bulk-synchronous form the mean of the window deltas (center
    += Σᵢ Δᵢ / N)."""
    ALGORITHM = "adag"
    DEFAULT_WINDOW = 12


class DynSGD(AsynchronousDistributedTrainer):
    """Staleness-aware async SGD: each commit is scaled by
    1/(staleness+1).  The SPMD form emulates serialized commits with a
    per-round rotation (see ``parallel/spmd.py``)."""
    ALGORITHM = "dynsgd"
    DEFAULT_WINDOW = 5


class AEASGD(AsynchronousDistributedTrainer):
    """Asynchronous Elastic Averaging SGD (Zhang et al. 2015): each worker
    keeps its own params; every window the elastic force α·(x−x̃), α =
    learning_rate·rho, is subtracted locally and added to the center."""
    ALGORITHM = "aeasgd"
    DEFAULT_WINDOW = 32

    def __init__(self, keras_model, rho: float = 5.0,
                 learning_rate: float = 0.1, **kw):
        super().__init__(keras_model, learning_rate=learning_rate, **kw)
        self.rho = float(rho)

    def _elastic_alpha(self) -> float:
        lr = self.learning_rate if self.learning_rate is not None else 0.1
        return self.rho * lr


class EAMSGD(AEASGD):
    """Elastic averaging with Nesterov momentum on the local update
    (``momentum`` default 0.9): the momentum lives in the worker optimizer
    (SGD + Nesterov); the elastic exchange is AEASGD's."""
    ALGORITHM = "eamsgd"

    def __init__(self, keras_model, rho: float = 5.0,
                 learning_rate: float = 0.1, momentum: float = 0.9, **kw):
        kw.pop("worker_optimizer", None)
        super().__init__(
            keras_model, rho=rho, learning_rate=learning_rate,
            worker_optimizer=opt_lib.SGD(learning_rate=learning_rate,
                                         momentum=momentum, nesterov=True),
            **kw)
        self.momentum = float(momentum)


def _reject_validation_kwargs(kw: dict, name: str) -> None:
    """The 'local' trainers never update a center model, so validating it
    per epoch would watch the initial weights: refuse up front."""
    if kw.get("early_stopping_patience") is not None:
        raise ValueError(
            f"{name} trains independent per-worker models (the center "
            "never moves): per-epoch center validation / early stopping "
            "does not apply")


class AveragingTrainer(DistributedTrainer):
    """One-shot parameter averaging: each worker trains independently on
    its shard; the result is the weight average."""
    ALGORITHM = "local"

    def __init__(self, keras_model, **kw):
        kw.setdefault("communication_window", 1)
        _reject_validation_kwargs(kw, type(self).__name__)
        super().__init__(keras_model, **kw)

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False) -> FittedModel:
        super().train(dataset, shuffle, resume)
        self._fitted = FittedModel(self._model_from(
            rules.average_trees(self._state.local), self._input_shape))
        return self._fitted


class EnsembleTrainer(DistributedTrainer):
    """k independent models trained side by side, returned as a list."""
    ALGORITHM = "local"

    def __init__(self, keras_model, num_models: Optional[int] = None, **kw):
        kw.setdefault("communication_window", 1)
        if num_models is not None:
            kw.setdefault("num_workers", num_models)
        _reject_validation_kwargs(kw, type(self).__name__)
        super().__init__(keras_model, **kw)
        self.num_models = self.num_workers

    def train(self, dataset: Dataset, shuffle: bool = False,
              resume: bool = False) -> List[FittedModel]:
        super().train(dataset, shuffle, resume)
        models = [FittedModel(self._model_from(p, self._input_shape))
                  for p in self._state.local]
        self._ensemble = models
        self._fitted = models[0]  # predict-convenience surface only
        return models

    def serialize(self) -> dict:
        """All trained members: ``{"ensemble": [blob, ...]}``; rebuild
        each with ``FittedModel.deserialize``."""
        if not getattr(self, "_ensemble", None):
            raise ValueError(
                "EnsembleTrainer has no fitted models yet; call train() first")
        return {"ensemble": [m.serialize() for m in self._ensemble]}
