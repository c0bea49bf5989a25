"""Apply-kernel resolution for the host parameter server (``apply_kernel=``
knob), a copy of ``distkeras_tpu/applykernel.py`` with its numpy path
only, kept in the port so that it imports nothing of the JAX package.

The PS apply path reduces to two primitives: a dense in-place axpy
(``center += scale * delta``) and a sequential scatter-add
(``np.add.at(flat, indices, values)``, the sparse-commit and
coalesced-drain workhorse).  The JAX package can route both through a
native extension (``csrc/applykernel.cpp``) with bit-identical results;
the port's own build of that source waits for ROADMAP queue A item 8, so
here ``have_native()`` is False, ``"native"`` raises, and ``None``,
``"numpy"`` and ``"auto"`` all resolve to the numpy path (``"auto"`` is
the JAX contract of the knob when nothing is built).  The apply runs on
the host in either package; nothing on the card depends on this knob.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: the native apply kernel: not built for the port (ROADMAP queue A item 8)
_native = None

#: the accepted ``apply_kernel=`` spellings
KERNEL_CHOICES = (None, "numpy", "native", "auto")


def have_native() -> bool:
    return _native is not None


def resolve(name: Optional[str]):
    """Resolve an ``apply_kernel=`` knob value to the native module or None.

    None / ``"numpy"`` → None (the pure-NumPy reference path);
    ``"native"`` → raises, the port builds no native apply kernel yet;
    ``"auto"`` → the native module when built, so None here.
    """
    if name in (None, "numpy"):
        return None
    if name == "auto":
        return _native
    if name == "native":
        if _native is None:
            raise RuntimeError(
                "apply_kernel='native': the port's build of "
                "csrc/applykernel.cpp waits for ROADMAP queue A item 8; use "
                "apply_kernel=None (numpy, bit-identical) or 'auto'")
        return _native
    raise ValueError(
        f"apply_kernel must be one of {KERNEL_CHOICES}, got {name!r}")


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
    touched row is one contiguous ``axpy``; duplicated rows (never emitted
    by the wire contract, tolerated for direct callers) accumulate
    sequentially, the ``np.add.at`` semantics."""
    for i, r in enumerate(rows):
        axpy(kernel, dst2d[int(r)], vals2d[i], scale)
