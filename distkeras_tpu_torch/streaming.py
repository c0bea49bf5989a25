"""Row-sparse table detection, the part of ``distkeras_tpu/streaming.py``
that the host parameter server's ``row_sparse=`` knob needs:
``embedding_weight_indices`` and ``resolve_row_sparse_tables``
(``distkeras_tpu/streaming.py:358-407``), over the port's ``Sequential``.

The weight order is the JAX package's leaf order (``core.model.
jax_leaves``: layer by layer, each layer's keys sorted), so a layer's leaf
count locates its weights in the flat list exactly as the JAX module's
``tree_leaves`` count does.

The streaming half of the JAX module (``StreamBuffer``, ``StreamSource``,
``feed_stream``, ``run_stream_training``: online training from an
unbounded source through the elastic lease loop) waits for ROADMAP queue
A item 6, and the trainers refuse ``stream=True`` until then.
"""

from __future__ import annotations

from typing import List

from .core.layers import Embedding, layer_leaves
from .core.model import Sequential, jax_leaves


def embedding_weight_indices(model: Sequential) -> List[int]:
    """Weight-list indices of every ``Embedding`` table in ``model``.

    An ``Embedding`` layer carries exactly one leaf — its ``(vocab, dim)``
    table — and each layer's leaf count (parameters and BatchNorm
    statistics alike) advances the offset in the flat list.
    """
    out: List[int] = []
    off = 0
    for layer in model.layers:
        if isinstance(layer, Embedding):
            out.append(off)
        off += sum(1 for _ in layer_leaves(layer))
    return out


def resolve_row_sparse_tables(spec, model: Sequential) -> List[int]:
    """Resolve the trainer's ``row_sparse=`` knob to weight-list indices.

    ``True`` detects every ``Embedding`` table from the model (and refuses
    a model that has none — silently committing everything dense would be
    a no-op knob); an iterable of ints passes through validated against
    the weight list.
    """
    shapes = [tuple(p.shape) for _, p in jax_leaves(model)]
    if spec is True:
        tables = embedding_weight_indices(model)
        if not tables:
            raise ValueError(
                "row_sparse=True but the model has no Embedding layer — "
                "pass explicit weight indices or drop the knob")
        return tables
    tables = sorted({int(t) for t in spec})
    for t in tables:
        if not 0 <= t < len(shapes):
            raise ValueError(
                f"row_sparse names weight {t}; model has "
                f"{len(shapes)} weights")
        if len(shapes[t]) < 2:
            raise ValueError(
                f"row_sparse weight {t} has shape {shapes[t]} — row "
                "sparsity needs a (rows, dim...) table")
    return tables
