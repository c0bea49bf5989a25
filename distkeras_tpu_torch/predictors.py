"""Batch inference, port of ``distkeras_tpu/predictors.py``.

``ModelPredictor.predict(dataset)`` appends a ``prediction`` column holding
the model's output for every row, running ``batch_size`` rows at a time
through the model on its device.  With ``mesh=`` a worker mesh (or,
without one, inside a process group of more than one rank, as JAX's
``len(jax.devices()) > 1``) it takes the JAX package's sharded route:
chunks of ``batch_size × n`` rows, the tail padded by repeating its last
row, each worker's ``batch_size`` rows through the model (one worker a
rank across ranks, all of them in turn in one process), the outputs
gathered in row order on every rank and the padding cut off.  With a
``serving.ServingEngine`` and ``num_steps`` it takes the engine route
instead: rows are token prompts, each one request to the
continuous-batching engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.model import FittedModel
from .data.dataset import Dataset
from .device import DeviceLike, resolve_device
from .parallel import collective
from .parallel import mesh as mesh_lib


class Predictor:
    """Base class (reference: ``predictors.py :: Predictor``)."""

    def predict(self, dataset: Dataset) -> Dataset:  # pragma: no cover
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Batch inference over a dataset, with an optional live-engine route
    for sequence models.

    Default (no ``engine``): the model is moved, in place, to ``device``
    (``None`` means the CUDA card, and raises without one) and run over
    the rows in batches.  With ``engine`` (a ``serving.ServingEngine``
    built on the same model) and ``num_steps``, rows of ``features_col``
    are token prompts routed through the engine: the output column holds
    each row's prompt + ``num_steps`` generated tokens (the ``generate``
    row shape).  ``generate_kwargs`` (temperature/top_k/top_p/eos_id/
    pad_id/seed) pass through ``engine.submit`` per row, so outputs match
    ``FittedModel.generate`` under the same seeds.  The engine runs where
    its model lives; ``device``, if given, must be that device.  With
    ``mesh`` (see the module docstring) the model runs on this process's
    device of the mesh; ``device``, if given, must be that device.
    """

    def __init__(self, keras_model: FittedModel,
                 features_col: str = "features",
                 output_col: str = "prediction",
                 batch_size: int = 1024, device: DeviceLike = None,
                 engine=None, num_steps: Optional[int] = None,
                 generate_kwargs: Optional[dict] = None, mesh=None):
        if not isinstance(keras_model, FittedModel):
            raise TypeError(
                "ModelPredictor needs a FittedModel (a trained model with "
                f"weights); got {type(keras_model).__name__}")
        if engine is not None and num_steps is None:
            raise ValueError("engine-backed prediction needs num_steps "
                             "(the continuation length per prompt row)")
        world = mesh_lib.group_size()
        if engine is None and mesh is None and world > 1:
            mesh = mesh_lib.get_mesh(
                devices=None if device is None else [device] * world)
        self.mesh = None if engine is not None else mesh
        if self.mesh is not None:
            dev = mesh_lib.worker_device(self.mesh)
            if device is not None and not mesh_lib.same_device(
                    resolve_device(device), dev):
                raise ValueError(f"device={device!r} but the mesh runs this "
                                 f"process's workers on {dev}")
            self.model = keras_model.model.to(dev)
        elif engine is None:
            self.model = keras_model.model.to(resolve_device(device))
        else:
            want = None if device is None else resolve_device(device)
            if want is not None and (want.type, want.index or 0) != (
                    engine.device.type, engine.device.index or 0):
                raise ValueError(f"the engine runs on {engine.device}, not "
                                 f"{device}: it runs where its model lives")
            self.model = keras_model.model
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)
        self.engine = engine
        self.num_steps = None if num_steps is None else int(num_steps)
        self.generate_kwargs = dict(generate_kwargs or {})

    def predict(self, dataset: Dataset) -> Dataset:
        if self.engine is not None:
            return self._predict_engine(dataset)
        x = np.asarray(dataset[self.features_col])
        if self.mesh is not None:
            preds = self._predict_sharded(x, self.mesh)
        else:
            preds = self.model.predict(x, batch_size=self.batch_size)
        return dataset.with_column(self.output_col, preds)

    def _forward(self, rows: np.ndarray) -> torch.Tensor:
        """``rows`` through the model on its device, as ``predict`` runs a
        batch (bf16 outputs as f32)."""
        with torch.inference_mode():
            y = self.model(torch.as_tensor(rows, device=self.model.device))
            if y.dtype == torch.bfloat16:
                y = y.to(torch.float32)
        return y.clone()  # a normal tensor, for the collective

    def _predict_sharded(self, x: np.ndarray, mesh) -> np.ndarray:
        """Batch-parallel forward over the mesh's workers: each chunk of
        ``batch_size × n`` rows (the tail padded to a multiple of n by its
        last row) split in n equal parts in worker order, a part a worker,
        the outputs gathered in row order (one ``all_gather`` a chunk
        across ranks) and the padding cut off."""
        n = mesh.size
        chunk = self.batch_size * n
        workers = mesh_lib.local_workers(mesh)
        outs = []
        for i in range(0, len(x), chunk):
            block = x[i:i + chunk]
            pad = (-len(block)) % n
            if pad:
                block = np.concatenate([block, block[-1:].repeat(pad, 0)])
            k = len(block) // n
            parts = [self._forward(block[w * k:(w + 1) * k])
                     for w in workers]
            if mesh_lib.across_ranks(mesh):
                out = collective.gather_leaf(parts[0], mesh_lib.WORKER_AXIS,
                                             0, mesh)
            else:
                out = torch.cat(parts)
            out = out.cpu().numpy()
            outs.append(out[:len(out) - pad] if pad else out)
        return np.concatenate(outs, axis=0)

    def _predict_engine(self, dataset: Dataset) -> Dataset:
        """Continuous-batching route: one engine request per prompt row
        (admission backpressure is honoured by blocking submits), results
        reassembled in row order."""
        prompts = np.asarray(dataset[self.features_col])
        if prompts.ndim != 2:
            raise ValueError(
                f"engine-backed predict needs (rows, prompt_len) int "
                f"tokens in {self.features_col!r}, got shape "
                f"{prompts.shape}")
        was_running = self.engine._thread is not None
        self.engine.start()
        try:
            handles = [self.engine.submit(row, self.num_steps,
                                          **self.generate_kwargs)
                       for row in prompts.astype(np.int32)]
            rows = [h.result(timeout=600.0) for h in handles]
        finally:
            if not was_running:
                self.engine.stop()
        return dataset.with_column(self.output_col,
                                   np.stack(rows).astype(np.int32))
