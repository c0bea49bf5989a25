"""Batch inference, port of ``distkeras_tpu/predictors.py``.

``ModelPredictor.predict(dataset)`` appends a ``prediction`` column holding
the model's output for every row, running ``batch_size`` rows at a time
through the model on its device.  This is the JAX package's default route;
its mesh route (rows sharded over devices) and its serving-engine route
arrive with later slices.
"""

from __future__ import annotations

from .core.model import FittedModel
from .data.dataset import Dataset
from .device import DeviceLike, resolve_device


class Predictor:
    """Base class (reference: ``predictors.py :: Predictor``)."""

    def predict(self, dataset: Dataset) -> Dataset:  # pragma: no cover
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Batch inference over a dataset.  The model is moved, in place, to
    ``device`` (``None`` means the CUDA card, and raises without one)."""

    def __init__(self, keras_model: FittedModel,
                 features_col: str = "features",
                 output_col: str = "prediction",
                 batch_size: int = 1024, device: DeviceLike = None):
        if not isinstance(keras_model, FittedModel):
            raise TypeError(
                "ModelPredictor needs a FittedModel (a trained model with "
                f"weights); got {type(keras_model).__name__}")
        self.model = keras_model.model.to(resolve_device(device))
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size = int(batch_size)

    def predict(self, dataset: Dataset) -> Dataset:
        preds = self.model.predict(dataset[self.features_col],
                                   batch_size=self.batch_size)
        return dataset.with_column(self.output_col, preds)
