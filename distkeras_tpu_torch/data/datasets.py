"""Workload datasets: MNIST, CIFAR-10, ATLAS Higgs and digits.

A copy of ``distkeras_tpu/data/datasets.py`` (numpy only), kept here so
the port imports nothing of the JAX package: the loaders, their ``.npz``
lookup and the synthetic stand-ins are the same code, so the same seed
gives the same arrays to the bit.  ``read_csv`` is the JAX module's,
gates and all; its native parser is the port's own build of
``csrc/csvloader.cpp`` (``native.load("csvloader")``, compiled at first
use), never the JAX package's module.  The original docstring follows.

Workload datasets matching the reference examples.

The reference examples train on MNIST (MLP + ConvNet), CIFAR-10 (ConvNet) and
the ATLAS Higgs CSV (tabular binary classification) — SURVEY.md §2.1 row 23,
``BASELINE.json.configs``.  Nothing is downloaded, so each loader
first looks for a real ``.npz`` copy under ``DISTKERAS_TPU_DATA`` (or
``~/.distkeras_tpu/data``) and otherwise generates a *deterministic synthetic
stand-in with learnable class structure* (class-conditional prototypes +
noise), which is sufficient for training-dynamics tests and throughput
benchmarks (throughput does not depend on pixel content).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

from .dataset import Dataset

_DATA_DIRS = [
    os.environ.get("DISTKERAS_TPU_DATA", ""),
    os.path.expanduser("~/.distkeras_tpu/data"),
]


def has_real_data(name: str) -> bool:
    """Cheap provenance check (no load): is a real ``<name>.npz`` present
    under ``DISTKERAS_TPU_DATA`` / ``~/.distkeras_tpu/data``?"""
    return any(d and os.path.exists(os.path.join(d, name + ".npz"))
               for d in _DATA_DIRS)


def _try_load_npz(name: str) -> Optional[dict]:
    for d in _DATA_DIRS:
        if not d:
            continue
        path = os.path.join(d, name + ".npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return dict(z)
    return None


def _synthetic_classification(n: int, shape: Tuple[int, ...], num_classes: int,
                              seed: int, noise: float = 0.35,
                              value_range=(0.0, 255.0),
                              image_hw: Optional[Tuple[int, int, int]] = None,
                              proto_seed: Optional[int] = None,
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional prototype + Gaussian noise, clipped to value_range.

    ``proto_seed`` fixes the class prototypes independently of the sample
    noise/labels so train and test splits share one distribution (different
    ``seed``, same ``proto_seed``).

    For image workloads (``image_hw = (H, W, C)``) prototypes are *spatially
    smooth*: sampled at coarse resolution and block-upsampled, so conv+pool
    architectures pick up the class structure quickly (i.i.d.-pixel prototypes
    are linearly separable but fight a ConvNet's locality/pooling bias).
    A linear probe reaches high accuracy, a random model ~1/num_classes —
    exactly what accuracy-threshold integration tests need.
    """
    proto_rng = np.random.default_rng(
        seed if proto_seed is None else proto_seed)
    rng = np.random.default_rng(seed)
    if image_hw is not None:
        h, w, c = image_hw
        fh, fw = max(h // 4, 1), max(w // 4, 1)
        coarse = proto_rng.uniform(0.2, 0.8, size=(num_classes, fh, fw, c))
        protos = np.kron(coarse, np.ones((1, h // fh, w // fw, 1)))
        protos = protos.reshape(num_classes, -1)[:, :int(np.prod(shape))]
        protos = protos.reshape((num_classes,) + shape)
    else:
        protos = proto_rng.uniform(0.25, 0.75, size=(num_classes,) + shape)
    labels = rng.integers(0, num_classes, size=n)
    x = protos[labels] + noise * rng.standard_normal((n,) + shape)
    x = np.clip(x, 0.0, 1.0)
    lo, hi = value_range
    x = (lo + x * (hi - lo)).astype(np.float32)
    return x, labels.astype(np.int64)


def load_mnist(n_train: int = 60_000, n_test: int = 10_000,
               seed: int = 0, noise: float = 0.35
               ) -> Tuple[Dataset, Dataset]:
    """MNIST as flat 784-dim feature rows, pixel range [0, 255] (matching the
    reference's raw-CSV representation fed through MinMaxTransformer).

    ``noise`` only shapes the synthetic fallback (ignored on real npz data):
    raising it makes the stand-in task genuinely hard, which parity/accuracy
    gates need — at the default every capable model saturates at 1.0."""
    real = _try_load_npz("mnist")
    if real is not None:
        xtr = real["x_train"].reshape(-1, 784).astype(np.float32)[:n_train]
        ytr = real["y_train"].astype(np.int64)[:n_train]
        xte = real["x_test"].reshape(-1, 784).astype(np.float32)[:n_test]
        yte = real["y_test"].astype(np.int64)[:n_test]
    else:
        xtr, ytr = _synthetic_classification(n_train, (784,), 10, seed,
                                             noise=noise,
                                             image_hw=(28, 28, 1),
                                             proto_seed=seed)
        xte, yte = _synthetic_classification(n_test, (784,), 10, seed + 1,
                                             noise=noise,
                                             image_hw=(28, 28, 1),
                                             proto_seed=seed)
    return (Dataset({"features": xtr, "label": ytr}),
            Dataset({"features": xte, "label": yte}))


def load_cifar10(n_train: int = 50_000, n_test: int = 10_000,
                 seed: int = 10) -> Tuple[Dataset, Dataset]:
    """CIFAR-10 as flat 3072-dim rows in [0, 255]."""
    real = _try_load_npz("cifar10")
    if real is not None:
        xtr = real["x_train"].reshape(-1, 3072).astype(np.float32)[:n_train]
        ytr = real["y_train"].reshape(-1).astype(np.int64)[:n_train]
        xte = real["x_test"].reshape(-1, 3072).astype(np.float32)[:n_test]
        yte = real["y_test"].reshape(-1).astype(np.int64)[:n_test]
    else:
        xtr, ytr = _synthetic_classification(n_train, (3072,), 10, seed,
                                             image_hw=(32, 32, 3),
                                             proto_seed=seed)
        xte, yte = _synthetic_classification(n_test, (3072,), 10, seed + 1,
                                             image_hw=(32, 32, 3),
                                             proto_seed=seed)
    return (Dataset({"features": xtr, "label": ytr}),
            Dataset({"features": xte, "label": yte}))


def load_atlas_higgs(n_train: int = 200_000, n_test: int = 50_000,
                     seed: int = 20) -> Tuple[Dataset, Dataset]:
    """ATLAS Higgs tabular: 28 physics features, binary signal/background
    (the reference's ``examples/data/atlas_higgs.csv`` workload)."""
    real = _try_load_npz("atlas_higgs")
    if real is not None:
        xtr = real["x_train"].astype(np.float32)[:n_train]
        ytr = real["y_train"].reshape(-1).astype(np.int64)[:n_train]
        xte = real["x_test"].astype(np.float32)[:n_test]
        yte = real["y_test"].reshape(-1).astype(np.int64)[:n_test]
    else:
        rng = np.random.default_rng(seed)
        d = 28

        w = rng.standard_normal((d,))  # shared signal direction

        def make(n, s):
            r = np.random.default_rng(s)
            y = r.integers(0, 2, size=n)
            x = r.standard_normal((n, d)).astype(np.float32)
            # shift signal events along the shared direction (learnable margin)
            x += np.outer(2.0 * y - 1.0, 0.6 * w).astype(np.float32)
            return x, y.astype(np.int64)

        xtr, ytr = make(n_train, seed)
        xte, yte = make(n_test, seed + 1)
    return (Dataset({"features": xtr, "label": ytr}),
            Dataset({"features": xte, "label": yte}))


def load_digits(n_train: int = 1500, n_test: Optional[int] = None,
                seed: int = 0) -> Tuple[Dataset, Dataset]:
    """REAL handwritten-digit data, available offline: scikit-learn's bundled
    ``load_digits`` (1797 8x8 images of digits 0-9, from UCI's optical
    recognition set).  Nothing is downloaded, so this is the one
    genuinely-real image workload — the accuracy-parity artifact
    (``scripts/accuracy_parity.py``, SURVEY.md §6 "identical final validation
    accuracy") uses it to demonstrate parity on real data rather than the
    synthetic MNIST stand-in.

    Pixels are rescaled from sklearn's [0, 16] to [0, 255] so example code
    (``MinMaxTransformer(o_min=0, o_max=255)``) is uniform across loaders.
    Without scikit-learn it raises ImportError, as the JAX function does.
    The train/test split is a deterministic seeded shuffle; ``n_test``
    defaults to everything after the first ``n_train`` rows.
    """
    try:
        from sklearn.datasets import load_digits as _sk_digits
    except ImportError as e:  # pragma: no cover - sklearn is in the image
        raise ImportError(
            "load_digits needs scikit-learn (bundled data, no network); "
            "use load_mnist for the synthetic stand-in instead") from e
    bunch = _sk_digits()
    x = bunch.data.astype(np.float32) * (255.0 / 16.0)
    y = bunch.target.astype(np.int64)
    order = np.random.default_rng(seed).permutation(len(x))
    x, y = x[order], y[order]
    n_train = min(n_train, len(x) - 1)
    stop = len(x) if n_test is None else min(len(x), n_train + n_test)
    return (Dataset({"features": x[:n_train], "label": y[:n_train]}),
            Dataset({"features": x[n_train:stop], "label": y[n_train:stop]}))


# Native multithreaded CSV parser (the port's copy of csrc/csvloader.cpp,
# built by native.py at first use) — the data plane's Spark-JVM-ingest
# analogue.  read_csv() uses it only for files it can prove are plain
# numeric CSVs (no quotes/comments); everything else takes np.genfromtxt,
# so behavior is identical either way.  That choice is a rule about the
# file's contents: a build that fails raises.  _UNRESOLVED until the first
# headered file loads it; None pins np.genfromtxt.
_UNRESOLVED = object()
_native_csv = _UNRESOLVED


def _csv_module():
    global _native_csv
    if _native_csv is _UNRESOLVED:
        from .. import native
        _native_csv = native.load("csvloader")
    return _native_csv


def _header_eligible(names: list, delimiter: str) -> bool:
    """Header-level gates for the native CSV path — O(header) checks that
    run BEFORE the file body is even read.  Reject anything where
    genfromtxt's name handling diverges: sanitized (non-identifier) names,
    duplicate names (renamed 'a', 'a_1'), and numpy's excludelist (names
    shadowing genfromtxt internals get an underscore appended)."""
    if _csv_module() is None or len(delimiter) != 1 or ord(delimiter) >= 128:
        return False
    if delimiter.isspace():
        return False  # whitespace delims hit genfromtxt's line-strip rules
    if any(not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", n) for n in names):
        return False  # genfromtxt would sanitize these names; let it
    if len(set(names)) != len(names):
        return False  # genfromtxt renames duplicates ('a', 'a_1', ...)
    if any(n in ("return", "file", "print") for n in names):
        return False  # numpy NameValidator excludelist: renamed 'print_' &c
    return True


def _native_parse(raw: bytes, names: list, delimiter: str,
                  body_start: int):
    """Parse a headered numeric CSV with the C++ kernel; returns a dict
    column-name → float64 array (genfromtxt-equivalent), or None when the
    body needs the general path (header gates are ``_header_eligible``).

    The body gates are deliberately paranoid: anything where strtod and
    genfromtxt's float() conversion could disagree (quotes, comments, tabs,
    hex floats, Python underscore literals, non-ASCII bytes — the fallback
    raises UnicodeDecodeError on mis-encoded files and the native path must
    not mask that — or bare-CR line endings, which genfromtxt's
    universal-newline text mode treats as row separators) takes the
    fallback, so observable behavior never depends on the route.  Scans
    use find()/count() with offsets, not slices: no body copies."""
    if not raw.isascii():
        return None  # non-ASCII: genfromtxt's decode/naming territory
    if b'"' in raw or b"'" in raw or b"#" in raw or b"\t" in raw:
        return None  # quoting/comments/tabs: genfromtxt semantics territory
    if b"\x0b" in raw or b"\x0c" in raw:
        return None  # \v/\f: float() strips them, strtod does not
    if (raw.find(b"x", body_start) != -1 or raw.find(b"X", body_start) != -1
            or raw.find(b"_", body_start) != -1):
        return None  # strtod hex floats / float('1_5') underscore literals
    if raw.count(b"\r") != raw.count(b"\r\n"):
        return None  # bare CR: universal newlines make it a row separator
    flat = np.frombuffer(
        _native_csv.parse_numeric(raw, len(names), ord(delimiter), 1),
        dtype=np.float64)
    mat = flat.reshape(-1, len(names))
    return {n: mat[:, i] for i, n in enumerate(names)}


def read_csv(path: str, label_column: str,
             feature_columns: Optional[list] = None,
             delimiter: str = ",") -> Dataset:
    """Read a headered CSV into a Dataset (reference workflow parity:
    ``examples/workflow.ipynb`` reads the ATLAS Higgs CSV through Spark and
    assembles named columns into a features vector).

    ``feature_columns`` defaults to every column except the label, in file
    order.  Features come back as one float32 ``features`` matrix and the
    label as an int64 ``label`` column — ready for the transformer pipeline.
    """
    # Header first: if the header-level gates already force the fallback,
    # the body is never read into memory (genfromtxt streams from path).
    # No BOM strip, errors="replace": a BOM-prefixed or mis-encoded first
    # name just fails the identifier gate, routing to genfromtxt - whose
    # naming was the pre-native behavior and must stay observable-identical.
    with open(path, "rb") as f:
        first = f.readline()
        header = first.decode("utf-8", errors="replace").strip()
        hdr_names = [c.strip() for c in header.split(delimiter)]
        data = None
        if _header_eligible(hdr_names, delimiter):
            raw = first + f.read()
            data = _native_parse(raw, hdr_names, delimiter, len(first))
            del raw  # if body gates routed to fallback, free before
            # genfromtxt builds its own representation (pre-native peak)
    if data is None:
        data = np.atleast_1d(np.genfromtxt(
            path, delimiter=delimiter, names=True, dtype=np.float64,
            encoding="utf-8"))
    names = list(data.dtype.names) if hasattr(data, "dtype") else hdr_names
    if label_column not in names:
        raise ValueError(f"label column {label_column!r} not in CSV header "
                         f"{names}")
    if feature_columns is not None and len(feature_columns) == 0:
        raise ValueError("feature_columns is empty")
    feats = (feature_columns if feature_columns is not None
             else [n for n in names if n != label_column])
    missing = [c for c in feats if c not in names]
    if missing:
        raise ValueError(f"feature columns {missing} not in CSV header")
    x = np.stack([data[c] for c in feats], axis=1).astype(np.float32)
    y = data[label_column].astype(np.int64)
    return Dataset({"features": x, "label": y})
