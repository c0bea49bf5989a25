"""Sequence packing, a copy of ``distkeras_tpu/data/packing.py`` (numpy
only, kept in the port so that it imports nothing of the JAX package).

Several documents fill each fixed-length training row, with a parallel
``segment_ids`` row that keeps them isolated:

 - attention masks cross-segment pairs
   (``ops.attention.dot_product_attention(segment_ids=...)``, threaded
   through ``Sequential.forward(segment_ids=...)``);
 - the LM labels mask cross-segment next-token predictions
   (``packed_lm_labels`` emits -1 there; the ``*_masked`` losses in
   ``core/losses.py`` skip label -1).

With RoPE positions (relative) each packed document trains exactly as it
would unpacked.  Segment id 0 is padding; real documents get ids 1, 2, ...
per row.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pack_documents(docs: Sequence[Sequence[int]], seq_len: int,
                   pad_value: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """First-fit pack token sequences into (N, seq_len) rows.

    Documents are placed in the first row with room (first-fit over the
    open rows, documents in given order); documents longer than
    ``seq_len`` are rejected — split upstream if truncation is wanted
    (silently cutting data would be a silent-loss bug, per the repo's
    pad+mask contract).  Returns ``(tokens, segment_ids)`` int32 arrays;
    ``segment_ids`` is 0 on padding and 1, 2, ... for each document
    within its row.
    """
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    rows: List[List[int]] = []      # token buffers
    segs: List[List[int]] = []      # parallel segment ids
    counts: List[int] = []          # documents already in each row
    lengths = [len(d) for d in docs]
    for d, n_d in enumerate(lengths):
        if n_d > seq_len:
            raise ValueError(
                f"document {d} has {n_d} tokens > seq_len {seq_len}; "
                "split it upstream (packing never truncates)")
    min_len = min((n_d for n_d in lengths if n_d), default=0)
    open_rows: List[int] = []       # candidate rows, retired when too full
    for doc, n_d in zip(docs, lengths):
        if not n_d:
            continue
        placed = None
        for pos, r in enumerate(open_rows):
            if len(rows[r]) + n_d <= seq_len:
                placed = (pos, r)
                break
        if placed is None:
            rows.append([])
            segs.append([])
            counts.append(0)
            placed = (len(open_rows), len(rows) - 1)
            open_rows.append(placed[1])
        pos, r = placed
        counts[r] += 1
        rows[r].extend(doc)
        segs[r].extend([counts[r]] * n_d)
        # retire rows no remaining document can fit — keeps the scan list
        # short (first-fit stays O(docs · open_rows), not O(docs · rows))
        if seq_len - len(rows[r]) < min_len:
            open_rows.pop(pos)
    n = len(rows)
    tokens = np.full((n, seq_len), pad_value, np.int32)
    segment_ids = np.zeros((n, seq_len), np.int32)
    for r in range(n):
        tokens[r, :len(rows[r])] = rows[r]
        segment_ids[r, :len(segs[r])] = segs[r]
    return tokens, segment_ids


def packed_lm_labels(tokens, segment_ids, ignore: int = -1) -> np.ndarray:
    """Next-token labels that respect packing: position i's label is
    token i+1 when both live in the same non-padding segment, else
    ``ignore`` (which the ``*_masked`` losses skip).  The last position
    of every row is always ``ignore``."""
    tokens = np.asarray(tokens)
    seg = np.asarray(segment_ids)
    labels = np.full(tokens.shape, ignore, np.int32)
    same = (seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] != 0)
    labels[:, :-1] = np.where(same, tokens[:, 1:], ignore)
    return labels


def packing_efficiency(segment_ids) -> float:
    """Fraction of slots carrying real tokens — the waste packing
    removes relative to one-document-per-row padding."""
    seg = np.asarray(segment_ids)
    return float((seg != 0).mean()) if seg.size else 0.0
