"""Apply-kernel resolution for the host parameter server (``apply_kernel=``
knob), a copy of ``distkeras_tpu/applykernel.py`` kept in the port so
that it imports nothing of the JAX package.

The PS apply path reduces to two primitives: a dense in-place axpy
(``center += scale * delta``) and a sequential scatter-add
(``np.add.at(flat, indices, values)``, the sparse-commit and
coalesced-drain workhorse).  The native route is the port's own build of
``csrc/applykernel.cpp`` (``native.load("applykernel")``, compiled at
first use with ``-ffp-contract=off``), bit-identical to numpy: same
rounding count, same accumulation order.  ``apply_kernel=None`` (or
``"numpy"``) never touches the native module and stays the reference;
``"native"`` and ``"auto"`` resolve to the build, and a build that fails
raises (the port has a compiler wherever it runs, so ``"auto"`` does not
fall back silently).  Setting ``_native = None`` pins the numpy path for
``"auto"`` and makes ``"native"`` raise.  The apply runs on the host;
nothing on the card depends on this knob.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

#: the native apply kernel: the port's build, loaded at first resolve;
#: None pins the numpy path
_UNRESOLVED = object()
_native: Any = _UNRESOLVED

#: the accepted ``apply_kernel=`` spellings
KERNEL_CHOICES = (None, "numpy", "native", "auto")


def _module():
    global _native
    if _native is _UNRESOLVED:
        from . import native
        _native = native.load("applykernel")
    return _native


def have_native() -> bool:
    return _module() is not None


def resolve(name: Optional[str]):
    """Resolve an ``apply_kernel=`` knob value to the native module or None.

    None / ``"numpy"`` → None (the pure-NumPy reference path);
    ``"native"`` → the port's build (built here at first use), raising if
    it is pinned off;
    ``"auto"`` → the port's build, or None where it is pinned off.
    """
    if name in (None, "numpy"):
        return None
    if name not in KERNEL_CHOICES:
        raise ValueError(
            f"apply_kernel must be one of {KERNEL_CHOICES}, got {name!r}")
    kernel = _module()
    if kernel is None and name == "native":
        raise RuntimeError(
            "apply_kernel='native' but the native apply kernel is pinned "
            "off (applykernel._native is None); use apply_kernel=None "
            "(numpy, bit-identical) or 'auto'")
    return kernel


def axpy(kernel, dst: np.ndarray, src: np.ndarray, scale: float) -> None:
    """``dst += scale * src`` over flat f32 arrays, through ``kernel`` when
    given (bit-equal either way).  ``dst`` must be a writable f32 view."""
    if kernel is not None:
        kernel.axpy_f32(dst, np.ascontiguousarray(src, np.float32), scale)
    elif scale == 1.0:
        dst += src
    else:
        dst += scale * src


def scatter_add(kernel, dst: np.ndarray, idx: np.ndarray,
                vals: np.ndarray) -> None:
    """``dst[idx[i]] += vals[i]`` in array order (``np.add.at`` semantics),
    through ``kernel`` when given.  ``idx`` int64, ``vals``/``dst`` f32."""
    if kernel is not None:
        kernel.scatter_add_f32(dst, np.ascontiguousarray(idx, np.int64),
                               np.ascontiguousarray(vals, np.float32))
    else:
        np.add.at(dst, idx, vals)


def row_scatter_add(kernel, dst2d: np.ndarray, rows: np.ndarray,
                    vals2d: np.ndarray, scale: float = 1.0) -> None:
    """``dst2d[rows[i]] += scale * vals2d[i]`` row by row, in array order —
    the row-sparse embedding apply (``networking.RowSparseDelta``).  Each
    touched row is one contiguous ``axpy``, so the native and NumPy paths
    share per-row arithmetic and stay bit-identical; duplicated rows (never
    emitted by the wire contract, tolerated for direct callers) accumulate
    sequentially, the ``np.add.at`` semantics."""
    for i, r in enumerate(rows):
        axpy(kernel, dst2d[int(r)], vals2d[i], scale)
