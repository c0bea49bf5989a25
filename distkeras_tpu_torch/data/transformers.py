"""Feature-pipeline transformers — the dist-keras ``transform()`` API.

A verbatim copy of ``distkeras_tpu/data/transformers.py`` (numpy only),
kept here so the port imports nothing of the JAX package.  The original
docstring follows.

Feature-pipeline transformers (Spark-ML-style ``transform()`` parity).

Mirrors the reference transformer set (reference:
``distkeras/transformers.py`` — MinMaxTransformer, DenseTransformer,
ReshapeTransformer, OneHotTransformer, LabelIndexTransformer; SURVEY.md §2.1
row 19) but operates vectorized on ``Dataset`` columns instead of per-row
Spark UDFs — every transform is a single numpy pass, not a row closure.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .dataset import Dataset


class Transformer:
    """Base: ``transform(dataset) -> dataset`` (Spark-ML convention)."""

    def transform(self, dataset: Dataset) -> Dataset:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class MinMaxTransformer(Transformer):
    """Rescale features from observed range [o_min, o_max] to [n_min, n_max].

    Parity: reference ``transformers.py :: MinMaxTransformer`` (same
    constructor signature)."""

    def __init__(self, n_min: float = 0.0, n_max: float = 1.0,
                 o_min: float = 0.0, o_max: float = 255.0,
                 input_col: str = "features", output_col: str = "features"):
        self.n_min, self.n_max = float(n_min), float(n_max)
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col].astype(np.float32)
        scale = (self.n_max - self.n_min) / (self.o_max - self.o_min)
        y = (x - self.o_min) * scale + self.n_min
        return dataset.with_column(self.output_col, y)


class StandardScaleTransformer(Transformer):
    """Zero-mean / unit-variance feature scaling (fit on the given dataset)."""

    def __init__(self, input_col: str = "features",
                 output_col: str = "features", epsilon: float = 1e-8):
        self.input_col, self.output_col = input_col, output_col
        self.epsilon = epsilon

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col].astype(np.float32)
        mean = x.mean(axis=0, keepdims=True)
        std = x.std(axis=0, keepdims=True)
        return dataset.with_column(self.output_col,
                                   (x - mean) / (std + self.epsilon))


class DenseTransformer(Transformer):
    """Sparse→dense vector conversion. Our columns are already dense ndarrays,
    so this is a float32 densify/copy — kept for API parity (reference
    ``transformers.py :: DenseTransformer``)."""

    def __init__(self, input_col: str = "features",
                 output_col: str = "features"):
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        x = np.asarray(dataset[self.input_col], dtype=np.float32)
        return dataset.with_column(self.output_col, x)


class ReshapeTransformer(Transformer):
    """Flat vector → tensor shape (e.g. 784 → (28, 28, 1) for ConvNets).

    Parity: reference ``transformers.py :: ReshapeTransformer`` (used by the
    MNIST ConvNet example). Shape excludes the batch dim."""

    def __init__(self, input_col: str = "features",
                 output_col: str = "features",
                 shape: Sequence[int] = (28, 28, 1)):
        self.input_col, self.output_col = input_col, output_col
        self.shape = tuple(int(d) for d in shape)

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col]
        return dataset.with_column(self.output_col,
                                   x.reshape((len(x),) + self.shape))


class OneHotTransformer(Transformer):
    """Label index → one-hot vector (reference ``transformers.py ::
    OneHotTransformer`` backed by ``utils.to_dense_vector``)."""

    def __init__(self, output_dim: int, input_col: str = "label",
                 output_col: str = "label_encoded"):
        self.output_dim = int(output_dim)
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        idx = dataset[self.input_col].astype(np.int64).reshape(-1)
        out = np.zeros((len(idx), self.output_dim), np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return dataset.with_column(self.output_col, out)


class LabelIndexTransformer(Transformer):
    """Probability vector → argmax class index (reference
    ``transformers.py :: LabelIndexTransformer``; used after ModelPredictor)."""

    def __init__(self, output_dim: Optional[int] = None,
                 input_col: str = "prediction",
                 output_col: str = "prediction_index"):
        self.output_dim = output_dim  # kept for signature parity; unused
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        probs = dataset[self.input_col]
        idx = np.argmax(probs, axis=-1).astype(np.int64)
        return dataset.with_column(self.output_col, idx)


class LabelVectorTransformerUDF(Transformer):
    """Apply an arbitrary row->row function to a column (escape hatch mirroring
    ad-hoc UDF transformers in the reference examples)."""

    def __init__(self, fn, input_col: str, output_col: str):
        self.fn = fn
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col]
        out = np.stack([np.asarray(self.fn(row)) for row in x])
        return dataset.with_column(self.output_col, out)
