"""Loss functions (Keras names), port of ``distkeras_tpu/core/losses.py``.

Trainers take Keras loss *names*, resolved here to plain tensor functions
``loss(y_true, y_pred) -> scalar``.  Every loss reduces to a scalar mean
over the batch and computes in float32 whatever the model's compute
dtype, as the JAX package's do.  :func:`per_example` lifts any of them to
a (batch,) vector, the masked train step's form.
"""

from __future__ import annotations

import torch

_EPS = 1e-7
_F32 = torch.float32


def _log_probs(y_pred: torch.Tensor, from_logits: bool) -> torch.Tensor:
    y_pred = y_pred.to(_F32)
    if from_logits:
        return torch.log_softmax(y_pred, dim=-1)
    return torch.log(torch.clamp(y_pred, _EPS, 1.0))


def categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    logp = _log_probs(y_pred, from_logits)
    return -torch.mean(torch.sum(y_true.to(_F32) * logp, dim=-1))


def sparse_categorical_crossentropy(y_true, y_pred,
                                   from_logits: bool = False):
    logp = _log_probs(y_pred, from_logits)
    idx = y_true.to(torch.int64)
    return -torch.mean(torch.gather(logp, -1, idx[..., None])[..., 0])


def masked_sparse_categorical_crossentropy(y_true, y_pred,
                                           from_logits: bool = False):
    """Sparse CE that skips label < 0 (the sequence-packing convention:
    cross-document and padding positions are marked -1).  Mean over the
    VALID positions only."""
    logp = _log_probs(y_pred, from_logits)
    idx = y_true.to(torch.int64)
    valid = idx >= 0
    picked = torch.gather(logp, -1, torch.clamp(idx, min=0)[..., None])[..., 0]
    count = torch.clamp(valid.sum(), min=1)
    return -torch.where(valid, picked, 0.0).sum() / count


def binary_crossentropy(y_true, y_pred, from_logits: bool = False):
    y_true = y_true.to(_F32)
    y_pred = y_pred.to(_F32)
    if from_logits:
        # numerically stable sigmoid BCE
        return torch.mean(torch.clamp(y_pred, min=0) - y_pred * y_true
                          + torch.log1p(torch.exp(-torch.abs(y_pred))))
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return -torch.mean(y_true * torch.log(p)
                       + (1.0 - y_true) * torch.log(1.0 - p))


def mean_squared_error(y_true, y_pred):
    return torch.mean(torch.square(y_true.to(_F32) - y_pred.to(_F32)))


def mean_absolute_error(y_true, y_pred):
    return torch.mean(torch.abs(y_true.to(_F32) - y_pred.to(_F32)))


def mean_absolute_percentage_error(y_true, y_pred):
    y_true = y_true.to(_F32)
    diff = torch.abs((y_true - y_pred.to(_F32))
                     / torch.clamp(torch.abs(y_true), min=_EPS))
    return 100.0 * torch.mean(diff)


def mean_squared_logarithmic_error(y_true, y_pred):
    fl = torch.log1p(torch.clamp(y_pred.to(_F32), min=_EPS))
    sl = torch.log1p(torch.clamp(y_true.to(_F32), min=_EPS))
    return torch.mean(torch.square(fl - sl))


def kullback_leibler_divergence(y_true, y_pred):
    y_true = torch.clamp(y_true.to(_F32), _EPS, 1.0)
    y_pred = torch.clamp(y_pred.to(_F32), _EPS, 1.0)
    return torch.mean(torch.sum(y_true * torch.log(y_true / y_pred), dim=-1))


def hinge(y_true, y_pred):
    """Hinge loss with {0,1} labels converted to {-1,1} (the JAX package's
    deliberate Keras-2 modernization, documented there)."""
    y_true = y_true.to(_F32)
    y_true = torch.where(y_true == 0.0, -1.0, y_true)
    return torch.mean(torch.clamp(1.0 - y_true * y_pred.to(_F32), min=0.0))


def squared_hinge(y_true, y_pred):
    # the same {0,1}->{-1,1} conversion as ``hinge``
    y_true = y_true.to(_F32)
    y_true = torch.where(y_true == 0.0, -1.0, y_true)
    return torch.mean(torch.square(
        torch.clamp(1.0 - y_true * y_pred.to(_F32), min=0.0)))


def poisson(y_true, y_pred):
    y_pred = torch.clamp(y_pred.to(_F32), min=_EPS)
    return torch.mean(y_pred - y_true.to(_F32) * torch.log(y_pred))


def cosine_proximity(y_true, y_pred):
    """Keras-1 cosine proximity: ``-mean(l2_normalize(y_true) *
    l2_normalize(y_pred))`` with the mean over ALL elements, as the JAX
    package reproduces it (an aligned pair scores -1/feature_dim)."""
    yt = y_true.to(_F32)
    yp = y_pred.to(_F32)
    yt = yt / torch.clamp(torch.linalg.norm(yt, dim=-1, keepdim=True),
                          min=_EPS)
    yp = yp / torch.clamp(torch.linalg.norm(yp, dim=-1, keepdim=True),
                          min=_EPS)
    return -torch.mean(yt * yp)


def _from_logits(fn):
    def wrapped(y_true, y_pred):
        return fn(y_true, y_pred, from_logits=True)
    return wrapped


_LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "categorical_crossentropy_from_logits":
        _from_logits(categorical_crossentropy),
    "sparse_categorical_crossentropy_from_logits":
        _from_logits(sparse_categorical_crossentropy),
    "sparse_categorical_crossentropy_masked":
        masked_sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_masked_from_logits":
        _from_logits(masked_sparse_categorical_crossentropy),
    "binary_crossentropy_from_logits": _from_logits(binary_crossentropy),
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "mape": mean_absolute_percentage_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "msle": mean_squared_logarithmic_error,
    "kullback_leibler_divergence": kullback_leibler_divergence,
    "kld": kullback_leibler_divergence,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "cosine": cosine_proximity,
}


def get_loss(name):
    """Resolve a Keras-style loss name (or pass through a callable)."""
    if callable(name):
        return name
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(
            f"Unknown loss {name!r}; known: {sorted(_LOSSES)}") from None


def per_example(loss_fn):
    """Lift any mean-reducing loss to per-example form: map it over
    singleton batches (``torch.vmap``, the JAX ``vmap``), giving a (batch,)
    vector whose entry i is the loss's own mean over example i (for the
    LM, the mean over its positions).  Works for custom callables too."""
    def fn(y_true, y_pred):
        return torch.vmap(lambda yt, yp: loss_fn(yt[None], yp[None]))(
            y_true, y_pred)
    return fn
