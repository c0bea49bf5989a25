"""Column-oriented in-memory Dataset — the Spark-DataFrame replacement.

A verbatim copy of ``distkeras_tpu/data/dataset.py`` (numpy only), kept
here so the port imports nothing of the JAX package.  The original
docstring follows.

The reference stores training data in a Spark ``DataFrame`` whose rows hold a
features vector column and a label column; sharding is ``df.repartition(n)``
(reference: ``distkeras/trainers.py :: DistributedTrainer.train``).  On TPU the
idiomatic equivalent is a host-resident column store of numpy arrays that can
be (a) globally shuffled, (b) split into per-worker shards whose leading dim is
the mesh 'workers' axis, and (c) stacked into (num_batches, batch, ...) arrays
that feed a ``lax.scan`` epoch — one device_put per epoch instead of a Python
loop of per-batch transfers.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class Dataset:
    """Immutable-ish column store. All columns share the leading (row) dim."""

    def __init__(self, columns: Dict[str, np.ndarray],
                 num_partitions: int = 1):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"Column length mismatch: {lens}")
        self._cols = {k: np.asarray(v) for k, v in columns.items()}
        self.num_partitions = int(num_partitions)

    # -- basic accessors ----------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self._cols.values())))

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __getitem__(self, name: str) -> np.ndarray:
        try:
            return self._cols[name]
        except KeyError:
            raise KeyError(
                f"No column {name!r}; available: {sorted(self._cols)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        cols = dict(self._cols)
        cols[name] = np.asarray(values)
        return Dataset(cols, self.num_partitions)

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset({n: self._cols[n] for n in names}, self.num_partitions)

    def drop(self, name: str) -> "Dataset":
        cols = {k: v for k, v in self._cols.items() if k != name}
        return Dataset(cols, self.num_partitions)

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._cols.items()},
                       self.num_partitions)

    def concat(self, other: "Dataset") -> "Dataset":
        cols = {k: np.concatenate([v, other._cols[k]])
                for k, v in self._cols.items()}
        return Dataset(cols, self.num_partitions)

    # -- spark-parity surface -----------------------------------------------
    def repartition(self, n: int) -> "Dataset":
        """Parity with ``df.repartition(n)`` — records the shard count used by
        ``shard()``; data movement happens lazily at shard time."""
        return Dataset(self._cols, num_partitions=n)

    def shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Global row shuffle (parity with reference ``utils.shuffle(df)``)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        return Dataset({k: v[perm] for k, v in self._cols.items()},
                       self.num_partitions)

    def split(self, fraction: float, seed: Optional[int] = None):
        """Parity with ``df.randomSplit([f, 1-f])`` — returns (left, right)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        cut = int(len(self) * fraction)
        left = {k: v[perm[:cut]] for k, v in self._cols.items()}
        right = {k: v[perm[cut:]] for k, v in self._cols.items()}
        return (Dataset(left, self.num_partitions),
                Dataset(right, self.num_partitions))

    # -- sharding / batching for the TPU path --------------------------------
    def shard(self, num_shards: Optional[int] = None,
              drop_remainder: bool = False,
              pad: bool = False) -> Dict[str, np.ndarray]:
        """Columns reshaped to (num_shards, rows_per_shard, ...).

        The leading axis is laid out along the mesh 'workers' axis by the
        parallel layer; equal shard sizes are required (SPMD static shapes).
        A row count not divisible by ``num_shards`` **raises** — silent
        truncation violated the framework's no-data-drop contract, and
        silent duplication would bias any metric computed over the shards.
        Opt in explicitly to either resolution:

        - ``drop_remainder=True`` — truncate the tail (Spark-repartition
          style; acceptable for training streams);
        - ``pad=True`` — wrap-pad the tail by repeating rows from the front
          (no row lost, but padded duplicates weight those rows twice in
          unweighted metrics — the trainers' ``batches``/mask path is the
          metric-exact route).
        """
        if drop_remainder and pad:
            raise ValueError("drop_remainder and pad are mutually exclusive")
        n = num_shards or self.num_partitions
        total = len(self)
        if total < n:
            raise ValueError(f"Dataset of {total} rows cannot fill "
                             f"{n} shards")
        if total % n == 0:
            rows = total
            cols = self._cols
        elif drop_remainder:
            rows = (total // n) * n
            cols = {k: v[:rows] for k, v in self._cols.items()}
        elif pad:
            rows = (-(-total // n)) * n  # ceil to a full last shard
            cols = {k: np.concatenate([v, v[:rows - total]])
                    for k, v in self._cols.items()}
        else:
            raise ValueError(
                f"{total} rows do not divide into {n} equal shards; pass "
                "drop_remainder=True to truncate the tail or pad=True to "
                "wrap-pad it")
        return {k: v.reshape((n, rows // n) + v.shape[1:])
                for k, v in cols.items()}

    def batches(self, batch_size: int, columns: Sequence[str],
                drop_remainder: bool = True) -> Dict[str, np.ndarray]:
        """Columns stacked to (num_batches, batch_size, ...) for lax.scan."""
        nb = len(self) // batch_size
        if nb == 0:
            raise ValueError(
                f"batch_size {batch_size} > dataset size {len(self)}")
        rows = nb * batch_size
        return {k: self._cols[k][:rows].reshape(
            (nb, batch_size) + self._cols[k].shape[1:]) for k in columns}

    # -- row iteration (predictor/evaluator convenience) ---------------------
    def rows(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield {k: v[i] for k, v in self._cols.items()}

    def __repr__(self):
        shapes = {k: tuple(v.shape) for k, v in self._cols.items()}
        return (f"Dataset(rows={len(self)}, partitions={self.num_partitions}, "
                f"columns={shapes})")
