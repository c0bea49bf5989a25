"""The epoch layout of the distributed engine and a streaming input path.

``num_rounds``, ``round_block`` and ``round_stream`` are copies of
``distkeras_tpu/data/pipeline.py`` (numpy only), kept here so the port
imports nothing of the JAX package: the same arguments give the same
arrays to the bit.  ``prefetch_to_device`` is the port's counterpart of the
JAX function: host arrays go to their devices by ``non_blocking`` copies
from pinned memory, ``buffer_size`` items ahead of the consumer, so the
copy of round r+1 overlaps the compute of round r.

The SPMD engine's default path puts a whole epoch on the device once
(``parallel.spmd.shape_epoch_data``); this module is the mode for data
that does not fit: a generator of per-round host arrays, consumed by
``SPMDEngine.run_epoch_streaming``.
"""

from __future__ import annotations

import collections
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import host_to_device


def num_rounds(n_rows: int, num_workers: int, window: int,
               batch_size: int) -> int:
    """Rounds per epoch: ceil — the tail is padded up, never dropped."""
    if n_rows == 0:
        raise ValueError("empty dataset")
    if n_rows < num_workers:
        raise ValueError(
            f"dataset of {n_rows} rows has fewer rows than workers "
            f"({num_workers}); some workers would train on padding only")
    return -(-n_rows // (num_workers * window * batch_size))


def round_block(n_rows: int, num_workers: int, window: int, batch_size: int,
                r: int) -> Tuple[np.ndarray, np.ndarray]:
    """The one source of truth for the epoch data layout, shared by
    ``shape_epoch_data`` (all at once) and ``round_stream`` (streaming).

    Returns ``(sel, mask)`` shaped (window, workers, batch) for round ``r``
    — closed form, O(one round) memory.  Worker i's slot ``j = r·w·b + t·b
    + p`` (window step t, batch position p) holds row ``j·n + i``: real rows
    are dealt round-robin across workers, so the wrap-padding that fills
    the tail round is spread evenly — no worker ever trains on padding
    only, which matters for the algorithms whose result blends per-worker
    params (Averaging, Ensemble, EASGD).  ``mask`` is 1.0 for real rows,
    0.0 for padding; over a whole epoch every real row appears exactly once
    with mask 1.
    """
    n, w, b = num_workers, window, batch_size
    t = np.arange(w)[:, None, None]
    i = np.arange(n)[None, :, None]
    p = np.arange(b)[None, None, :]
    k = (r * w * b + t * b + p) * n + i  # (window, workers, batch)
    mask = (k < n_rows).astype(np.float32)
    sel = k % n_rows  # wrap-pad with real rows
    return sel, mask


def round_stream(x: np.ndarray, y: np.ndarray, num_workers: int,
                 window: int, batch_size: int,
                 shuffle_seed: Optional[int] = None,
                 seg: Optional[np.ndarray] = None
                 ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield per-round (x, y, mask) triples shaped (window, workers, batch,
    ...) — or (x, y, seg, mask) quadruples when ``seg`` (sequence-packing
    segment ids, same row order) is given.

    The row layout comes from ``round_block``, identical to
    ``shape_epoch_data``, so a streamed epoch visits exactly the same
    batches and masks as the all-at-once path while holding only one round
    at a time (plus an optional epoch-length permutation for shuffling).
    """
    n, w, b = num_workers, window, batch_size
    rounds = num_rounds(len(x), n, w, b)
    perm = (np.random.default_rng(shuffle_seed).permutation(len(x))
            if shuffle_seed is not None else None)
    for r in range(rounds):
        sel, mask = round_block(len(x), n, w, b, r)
        if perm is not None:
            sel = perm[sel]
        if seg is not None:
            yield x[sel], y[sel], seg[sel], mask
        else:
            yield x[sel], y[sel], mask


def prefetch_to_device(iterator: Iterator, devices: Sequence,
                       buffer_size: int = 2):
    """Wrap an iterator of array tuples, keeping ``buffer_size`` items in
    flight on their devices: element k of each item goes to
    ``devices[k]``.

    A ``non_blocking`` copy from pinned memory returns at once (the copy
    runs on the card's copy engine in stream order), so enqueueing the next
    round before the current one is consumed overlaps host → device copies
    with device compute.
    """
    devices = [torch.device(d) for d in devices]
    queue = collections.deque()

    def enqueue(k):
        for _ in range(k):
            try:
                item = next(iterator)
            except StopIteration:
                return
            if len(item) != len(devices):
                # zip would silently truncate (dropping e.g. the mask of a
                # packed quadruple fed with 3 devices): refuse instead
                raise ValueError(
                    f"streamed item has {len(item)} arrays but "
                    f"{len(devices)} devices were given")
            queue.append(tuple(host_to_device(a, d, non_blocking=True)
                               for a, d in zip(item, devices)))

    enqueue(buffer_size)
    while queue:
        yield queue.popleft()
        enqueue(1)
