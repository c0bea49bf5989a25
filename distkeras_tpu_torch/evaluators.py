"""Metric evaluation over predicted datasets.

A copy of ``distkeras_tpu/evaluators.py`` (numpy only), kept here so the
port imports nothing of the JAX package; ``LossEvaluator`` computes its
loss through the port's ``core/losses.py`` on torch tensors.  The
original docstring follows.

Metric evaluation over predicted datasets (reference:
``distkeras/evaluators.py`` — SURVEY.md §2.1 row 20).

``AccuracyEvaluator.evaluate(dataset)`` computes the fraction of rows where
the predicted class index equals the label — same contract as the reference's
Spark aggregation, executed as one vectorized numpy pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.dataset import Dataset


class Evaluator:
    def evaluate(self, dataset: Dataset) -> float:  # pragma: no cover
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    def __init__(self, prediction_col: str = "prediction_index",
                 label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        pred, label = _pred_and_label(dataset, self.prediction_col,
                                      self.label_col)
        return float(np.mean(pred == label))


def _labels_1d(label: np.ndarray) -> np.ndarray:
    if label.ndim > 1 and label.shape[-1] > 1:  # one-hot labels
        label = np.argmax(label, axis=-1)
    return label.reshape(-1).astype(np.int64)


def _pred_and_label(dataset: Dataset, prediction_col: str, label_col: str):
    pred = np.asarray(dataset[prediction_col]).reshape(-1)
    label = _labels_1d(np.asarray(dataset[label_col]))
    if np.issubdtype(pred.dtype, np.floating):
        # prediction_col must hold class indices; round-to-nearest tolerates
        # float storage of integers while NaN/inf (undefined as a class)
        # fail loudly instead of casting to a platform-defined int64
        if not np.isfinite(pred).all():
            raise ValueError(
                f"column {prediction_col!r} contains NaN/inf — expected "
                "integer class indices (run LabelIndexTransformer first)")
        pred = np.rint(pred)
    return pred.astype(np.int64), label


class F1Evaluator(Evaluator):
    """Precision / recall / F1 over predicted class indices (extra over the
    reference, which ships accuracy only).

    ``average``: ``"binary"`` (score class ``positive_label``), ``"macro"``
    (unweighted mean of per-class scores over classes present in labels or
    predictions), or ``"micro"`` (global counts — equals accuracy for
    single-label classification).  ``metric`` picks ``"f1"`` (default),
    ``"precision"`` or ``"recall"``; empty denominators score 0.
    """

    def __init__(self, average: str = "binary", metric: str = "f1",
                 positive_label: int = 1,
                 prediction_col: str = "prediction_index",
                 label_col: str = "label"):
        if average not in ("binary", "macro", "micro"):
            raise ValueError(f"unknown average {average!r}")
        if metric not in ("f1", "precision", "recall"):
            raise ValueError(f"unknown metric {metric!r}")
        self.average = average
        self.metric = metric
        self.positive_label = int(positive_label)
        self.prediction_col = prediction_col
        self.label_col = label_col

    @staticmethod
    def _scores(tp, fp, fn):
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = (2 * prec * rec / (prec + rec)) if prec + rec else 0.0
        return {"precision": prec, "recall": rec, "f1": f1}

    def evaluate(self, dataset: Dataset) -> float:
        pred, label = _pred_and_label(dataset, self.prediction_col,
                                      self.label_col)
        if self.average == "binary":
            classes = [self.positive_label]
        else:
            classes = np.union1d(np.unique(pred), np.unique(label))
        per_class = []
        total = np.zeros(3)
        for c in classes:
            tp = float(np.sum((pred == c) & (label == c)))
            fp = float(np.sum((pred == c) & (label != c)))
            fn = float(np.sum((pred != c) & (label == c)))
            total += (tp, fp, fn)
            per_class.append(self._scores(tp, fp, fn)[self.metric])
        if self.average == "micro":
            return float(self._scores(*total)[self.metric])
        return float(np.mean(per_class))


class TopKAccuracyEvaluator(Evaluator):
    """Fraction of rows whose label is in the top-k of the predicted
    probability/logit vector (``prediction`` column, not the argmax index)."""

    def __init__(self, k: int = 5, prediction_col: str = "prediction",
                 label_col: str = "label"):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        probs = np.asarray(dataset[self.prediction_col])
        label = _labels_1d(np.asarray(dataset[self.label_col]))
        if probs.ndim != 2:
            raise ValueError(
                f"column {self.prediction_col!r} must be (N, num_classes) "
                f"probability/logit vectors, got shape {probs.shape}")
        k = min(self.k, probs.shape[-1])
        topk = np.argpartition(-probs, k - 1, axis=-1)[:, :k]
        return float(np.mean((topk == label[:, None]).any(axis=1)))


class LossEvaluator(Evaluator):
    """Mean loss over a predicted dataset (extra over reference — cheap and
    useful for parity tests)."""

    def __init__(self, loss: str = "categorical_crossentropy",
                 prediction_col: str = "prediction",
                 label_col: str = "label_encoded"):
        from .core.losses import get_loss
        self.loss_fn = get_loss(loss)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        pred = torch.as_tensor(np.asarray(dataset[self.prediction_col]))
        label = torch.as_tensor(np.asarray(dataset[self.label_col]))
        return float(self.loss_fn(label, pred))


class AUCEvaluator(Evaluator):
    """Area under the ROC curve for binary tasks (extra over reference —
    the Higgs workload upstream reports accuracy only, but AUC is the
    standard metric for that dataset).

    ``prediction`` column holds a positive-class score per row: either a
    (N,) score/probability vector, a (N, 1) column, or (N, 2) class
    probabilities (column 1 is used).  Labels are 0/1 (or one-hot).
    Computed by the rank statistic (Mann-Whitney U), ties handled by
    midranks — exact for any score distribution, O(N log N).
    """

    def __init__(self, prediction_col: str = "prediction",
                 label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        score = np.asarray(dataset[self.prediction_col], np.float64)
        if score.ndim == 2 and score.shape[1] == 2:
            score = score[:, 1]
        score = score.reshape(-1)
        label = _labels_1d(np.asarray(dataset[self.label_col]))
        if score.shape[0] != label.shape[0]:
            raise ValueError(
                f"prediction/label length mismatch: {score.shape[0]} vs "
                f"{label.shape[0]}")
        classes = np.unique(label)
        if not np.isin(classes, (0, 1)).all():
            raise ValueError(
                f"AUC is binary: labels must be 0/1, got classes {classes}")
        pos = label == 1
        n_pos = int(pos.sum())
        n_neg = label.shape[0] - n_pos
        if n_pos == 0 or n_neg == 0:
            raise ValueError("AUC undefined: need both classes present")
        # midranks (average rank within tied groups), vectorized: group
        # starts where the sorted score changes; each element's midrank is
        # the mean of its group's first and last 1-based positions
        order = np.argsort(score, kind="mergesort")
        sorted_scores = score[order]
        n = len(sorted_scores)
        new_group = np.empty(n, bool)
        new_group[0] = True
        np.not_equal(sorted_scores[1:], sorted_scores[:-1],
                     out=new_group[1:])
        starts = np.nonzero(new_group)[0]
        ends = np.append(starts[1:], n) - 1
        group_of = np.cumsum(new_group) - 1
        midrank = 0.5 * (starts + ends) + 1.0
        ranks = np.empty_like(score)
        ranks[order] = midrank[group_of]
        u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
        return float(u / (n_pos * n_neg))
