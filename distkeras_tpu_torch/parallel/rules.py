"""Per-algorithm update rules as pure functions over parameter trees, port
of ``distkeras_tpu/parallel/rules.py``.

These are the semantic core of each distributed optimization algorithm,
apart from how it executes: the SPMD engine (``spmd.py``) applies them
once a round, and the host parameter servers will apply the same rules to
their commits.  A tree is an ordered dict of name → tensor (what
``core.train.model_params`` gives), a list or tuple of trees, or one
tensor or numpy array.  No function changes its inputs: each returns new
tensors, so a caller may keep the trees it passed in.

The rules being kept:
 - delta commit:      DOWNPOUR's parameter server (center += delta)
 - ADAG normalize:    ADAG's parameter server (the summed deltas are
                      normalized by the number of commits before the apply)
 - elastic term:      AEASGD's worker (the ρ-scaled difference, subtracted
                      locally and committed to the center)
 - staleness scaling: DynSGD's parameter server
                      (center += delta / (staleness + 1))
"""

from __future__ import annotations

from typing import Callable, Sequence


def tmap(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure (dicts keep their
    key order, lists, tuples and named tuples their type)."""
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((k, tmap(fn, *(t[k] for t in trees)))
                           for k in first)
    if isinstance(first, (list, tuple)):
        out = [tmap(fn, *leaves) for leaves in zip(*trees)]
        return (type(first)(*out) if hasattr(first, "_fields")
                else type(first)(out))
    return fn(*trees)


def tree_sub(a, b):
    return tmap(lambda x, y: x - y, a, b)


def tree_add(a, b):
    return tmap(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tmap(lambda x: x * s, a)


def delta_commit(center, delta):
    """DOWNPOUR-style raw delta apply: center += delta."""
    return tree_add(center, delta)


def adag_commit(center, summed_delta, num_commits):
    """ADAG: deltas accumulated across workers, normalized by the commit
    count before the apply; in bulk-synchronous form that is the mean of
    the window deltas over the workers."""
    return tree_add(center, tree_scale(summed_delta, 1.0 / num_commits))


def elastic_difference(local, center, alpha):
    """EASGD elastic force α·(x − x̃).  ``alpha`` is the elastic
    coefficient (paper: α = η·ρ; the trainers expose ``rho`` and
    ``learning_rate``)."""
    return tmap(lambda x, c: alpha * (x - c), local, center)


def easgd_worker_update(local, elastic):
    """Worker side of the elastic exchange: x ← x − e."""
    return tree_sub(local, elastic)


def easgd_center_update(center, summed_elastic):
    """Center side: x̃ ← x̃ + Σᵢ eᵢ (the sum of the workers' elastic
    terms)."""
    return tree_add(center, summed_elastic)


def dynsgd_commit(center, delta, staleness):
    """DynSGD staleness-aware apply: center += delta / (staleness + 1)."""
    return tmap(lambda c, d: c + d / (staleness + 1.0), center, delta)


def average_trees(trees: Sequence):
    """The average of a list of trees (AveragingTrainer's one-shot model
    average)."""
    n = len(trees)
    out = trees[0]
    for t in trees[1:]:
        out = tree_add(out, t)
    return tree_scale(out, 1.0 / n)
