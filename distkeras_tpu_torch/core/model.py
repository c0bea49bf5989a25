"""Sequential model and FittedModel, port of ``distkeras_tpu/core/model.py``.

``Sequential`` is an ``nn.Module`` holding its layers and their
parameters; ``model(x, train=, generator=)`` is the JAX
``apply(params, x, train=, rng=)``.  The model spec
is the same JSON as the JAX package's, and ``get_weights`` is the same
flat list in JAX pytree leaf order, so an npz blob saved by either
package loads in the other (:func:`write_npz_blob`, :func:`read_npz_blob`).

:func:`load_jax_weights` is the one place where the JAX package's
parameters enter the port: it takes them as a flat list of numpy arrays
(``get_weights()``, or the ``w{i}`` arrays of a blob).  The port keeps the
JAX layouts, so nothing is transposed.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device, torch_dtype
from .layers import Layer, layer_leaves


class Sequential(nn.Module):
    """A stack of layers.  With ``input_shape`` (batch dim excluded) the
    parameters are built at construction, on ``device`` (``None`` means the
    CUDA card, and raises without one), drawn from ``generator`` (seed 0
    when ``None``).  Without it, call :meth:`build` before the first
    forward."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 compute_dtype: str = "bfloat16", name: str = "sequential",
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers or [])
        self.input_shape = tuple(input_shape) if input_shape else None
        self.compute_dtype = compute_dtype
        self.name = name
        self._device = resolve_device(device)
        if self.input_shape is not None:
            self.build(generator=generator)

    @property
    def device(self) -> torch.device:
        p = next(self.parameters(), None)
        return self._device if p is None else p.device

    def build(self, input_shape: Optional[Sequence[int]] = None,
              generator: Optional[torch.Generator] = None) -> "Sequential":
        """(Re)create every layer's parameters for ``input_shape``."""
        shape = tuple(input_shape) if input_shape else self.input_shape
        if shape is None:
            raise ValueError("input_shape required (constructor or build())")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_shape = shape
        for layer in self.layers:
            shape = layer.build(shape, generator, self._device)
        self.output_shape = shape
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                segment_ids=None,
                stats_out: Optional[dict] = None) -> torch.Tensor:
        """The forward pass.  ``train`` turns on dropout, with masks drawn
        from ``generator`` (on ``x``'s device), and batch statistics in
        BatchNormalization.  ``stats_out``: an optional dict that a train
        forward fills with ``{layer_index: new_stats}`` for the layers that
        carry statistics (BatchNorm), for :meth:`merge_stats` after the
        update.  ``segment_ids`` (sequence packing) is refused until
        packing is ported."""
        if segment_ids is not None:
            raise NotImplementedError(
                "segment_ids (sequence packing, data/packing.py) is not "
                "ported yet")
        cdtype = torch_dtype(self.compute_dtype)
        for i, layer in enumerate(self.layers):
            if (train and stats_out is not None
                    and hasattr(layer, "apply_with_stats")):
                x, stats_out[i] = layer.apply_with_stats(x, cdtype)
            else:
                x = layer(x, cdtype, train=train, generator=generator)
        return x

    @torch.no_grad()
    def merge_stats(self, stats: dict) -> "Sequential":
        """Write ``{layer_index: new_stats}`` (from ``forward(...,
        stats_out=)``) into the layers' running statistics, in place;
        trained parameters are left as they are."""
        for i, new in stats.items():
            for name, value in new.items():
                getattr(self.layers[i].stats, name).copy_(value)
        return self

    def has_stats(self) -> bool:
        return any(hasattr(layer, "apply_with_stats")
                   for layer in self.layers)

    def predict(self, x, batch_size: int = 512) -> np.ndarray:
        """Batched inference over host rows (used by ModelPredictor):
        ``batch_size`` rows at a time go to the model's device, under
        ``torch.inference_mode()``; the result comes back as numpy."""
        x = np.asarray(x)
        outs = []
        with torch.inference_mode():
            for i in range(0, len(x), batch_size):
                y = self(torch.as_tensor(x[i:i + batch_size],
                                         device=self.device))
                if y.dtype == torch.bfloat16:  # numpy has no bfloat16
                    y = y.to(torch.float32)
                outs.append(y.cpu().numpy())
        return np.concatenate(outs, axis=0)

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "compute_dtype": self.compute_dtype,
            "input_shape": list(self.input_shape) if self.input_shape else None,
            "layers": [layer.get_config() for layer in self.layers],
        })

    @staticmethod
    def from_json(spec: str, device: DeviceLike = None,
                  generator: Optional[torch.Generator] = None
                  ) -> "Sequential":
        cfg = json.loads(spec)
        return Sequential(
            [Layer.from_config(c) for c in cfg["layers"]],
            input_shape=cfg.get("input_shape"),
            compute_dtype=cfg.get("compute_dtype", "bfloat16"),
            name=cfg.get("name", "sequential"),
            device=device, generator=generator)

    def get_weights(self) -> List[np.ndarray]:
        """Flat list of numpy arrays in JAX pytree leaf order: copies, so
        later in-place updates of the model leave them as they are (the
        JAX package's arrays are immutable)."""
        return [np.array(p.detach().cpu()) for _, p in jax_leaves(self)]

    def set_weights(self, weights: Sequence[np.ndarray]) -> "Sequential":
        return load_jax_weights(self, weights)


def jax_leaves(model: Sequential) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs in the order of the JAX package's
    ``get_weights``: layer by layer, each layer's dict keys sorted.  The
    tensors are the parameters and BatchNorm's running statistics
    (buffers, which need no gradient)."""
    for i, layer in enumerate(model.layers):
        yield from layer_leaves(layer, f"{i}/")


def load_jax_weights(model: Sequential,
                     weights: Sequence[np.ndarray]) -> Sequential:
    """Copy the JAX package's flat parameter list into ``model``, in
    place, checking count and shapes; returns ``model``."""
    leaves = list(jax_leaves(model))
    if len(leaves) != len(weights):
        raise ValueError(
            f"weight count mismatch: {len(leaves)} vs {len(weights)}")
    with torch.no_grad():
        for (path, p), w in zip(leaves, weights):
            w = np.asarray(w)
            if tuple(w.shape) != tuple(p.shape):
                raise ValueError(f"weight {path}: shape {tuple(w.shape)} "
                                 f"does not match {tuple(p.shape)}")
            p.copy_(torch.tensor(w, dtype=p.dtype))
    return model


class FittedModel:
    """A built model with its weights — what a trainer returns and what
    ``ModelPredictor`` serves."""

    def __init__(self, model: Sequential):
        self.model = model

    def predict(self, x, batch_size: int = 512) -> np.ndarray:
        return self.model.predict(x, batch_size=batch_size)

    def get_weights(self) -> List[np.ndarray]:
        return self.model.get_weights()

    def serialize(self) -> dict:
        return serialize_model(self.model)

    @staticmethod
    def from_blob(blob: dict, device: DeviceLike = None) -> "FittedModel":
        """A blob of either package (``{"model": json, "weights": [...]}``)
        → a FittedModel on ``device`` (``None`` means the CUDA card)."""
        return FittedModel(deserialize_model(blob, device=device))

    #: the JAX package's name for :meth:`from_blob`
    deserialize = from_blob

    def save(self, path: str):
        """Persist spec + weights as the framework's npz blob."""
        write_npz_blob(path, self.serialize())

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "FittedModel":
        return FittedModel.from_blob(read_npz_blob(path), device=device)


def write_npz_blob(path: str, blob: dict) -> None:
    """The framework's one npz model layout (``spec`` json bytes + ``w{i}``
    weight arrays), byte-compatible with the JAX package's."""
    weights = {f"w{i}": np.asarray(w) for i, w in enumerate(blob["weights"])}
    np.savez(path, spec=np.frombuffer(blob["model"].encode(),
                                      dtype=np.uint8), **weights)


def read_npz_blob(path: str) -> dict:
    with np.load(path) as z:
        spec = bytes(z["spec"]).decode()
        weights = [z[f"w{i}"] for i in range(len(z.files) - 1)]
    return {"model": spec, "weights": weights}


def serialize_model(model: Sequential) -> dict:
    return {"model": model.to_json(), "weights": model.get_weights()}


def deserialize_model(blob: dict, device: DeviceLike = None) -> Sequential:
    model = Sequential.from_json(blob["model"], device=device)
    if model.input_shape is None:
        raise ValueError("serialized model missing input_shape")
    return load_jax_weights(model, blob["weights"])
