"""Utility helpers, a copy of ``distkeras_tpu/utils.py`` kept in the port
so that it imports nothing of the JAX package.

The reference's utils are Keras/Spark glue: model (de)serialization,
one-hot vectors, DataFrame row construction, shuffling, uniform weight
init.  The same-named functions here operate on the port's
``Sequential``/``FittedModel``/``Dataset`` and give the JAX functions'
results: the same blobs, the same seeded draws.

The JAX module's ``honor_platform_env`` has no counterpart: it only
drives ``jax.config``, and the port selects its device explicitly
(``device.py``: ``device=None`` means the CUDA card, tests pass
``"cpu"``).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np

from .core.model import FittedModel, deserialize_model, serialize_model
from .data.dataset import Dataset
from .device import DeviceLike


# -- model (de)serialization (reference: serialize_keras_model) --------------

def serialize_keras_model(model) -> dict:
    """Serialize a FittedModel — or an actual ``keras.Model`` via the
    adapter — into the blob both packages read (reference: ``utils.py ::
    serialize_keras_model`` pickles json+weights).  A Keras model is
    converted on the CPU: the blob holds host arrays."""
    if isinstance(model, FittedModel):
        return model.serialize()
    from .core.keras_adapter import convert_keras_model, keras_weights
    native = convert_keras_model(model, device="cpu")
    native.set_weights(keras_weights(model))
    return serialize_model(native)


def deserialize_keras_model(blob: dict,
                            device: DeviceLike = None) -> FittedModel:
    """A blob of either package → a FittedModel on ``device`` (``None``
    means the CUDA card)."""
    return FittedModel(deserialize_model(blob, device=device))


# -- vector/row helpers -------------------------------------------------------

def to_dense_vector(value: float, n_dim: int) -> np.ndarray:
    """One-hot vector with ``value`` as the hot index (reference:
    ``utils.py :: to_dense_vector`` backing OneHotTransformer)."""
    out = np.zeros((n_dim,), np.float32)
    out[int(value)] = 1.0
    return out


def new_dataframe_row(row: dict, name: str, value) -> dict:
    """Append a column to a row dict (reference: ``utils.new_dataframe_row``
    rebuilds a Spark Row with an extra field)."""
    out = dict(row)
    out[name] = value
    return out


def shuffle(dataset: Dataset, seed: Optional[int] = None) -> Dataset:
    """Global shuffle (reference: ``utils.shuffle(df)``)."""
    return dataset.shuffle(seed)


def precache(dataset: Dataset) -> Dataset:
    """Parity stub for ``df.cache()`` — the datasets are already
    host-resident numpy; returns the dataset unchanged."""
    return dataset


def uniform_weights(fitted: FittedModel,
                    constraints: Sequence[float] = (-0.5, 0.5),
                    seed: int = 0) -> FittedModel:
    """Re-init all weights uniformly in [lo, hi] (reference:
    ``utils.uniform_weights``): drawn by ``np.random.default_rng(seed)`` in
    ``get_weights()`` order, as the JAX function draws them, into a copy of
    the model (``fitted`` keeps its weights, as the JAX one does)."""
    lo, hi = constraints
    rng = np.random.default_rng(seed)
    new = [rng.uniform(lo, hi, size=w.shape).astype(w.dtype)
           for w in fitted.get_weights()]
    return FittedModel(copy.deepcopy(fitted.model)).set_weights(new)


def history_average(history: Sequence[float]) -> float:
    return float(np.mean(np.asarray(history))) if len(history) else 0.0


def history_executors_average(histories) -> float:
    """Average final loss across worker histories (reference keeps per-worker
    loss lists; ours are already merged per-round means)."""
    return history_average([h[-1] if isinstance(h, (list, np.ndarray)) else h
                            for h in histories])
