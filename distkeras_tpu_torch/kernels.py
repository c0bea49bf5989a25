"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>.so``
at the root of the checkout (or into ``$DISTKERAS_TPU_TORCH_BUILD_DIR``
when that is set, e.g. for an installed package), then loaded with
``ctypes``.  The build happens at first use (or up front through
:func:`build`, which starts one ``nvcc`` per source, all at once) and is
redone when the source, or a header under ``csrc/`` (``*.cuh``), is newer
than the library.  A failed build raises; nothing falls back.

It also holds :func:`kernel_operand`, the layout rule that the public
entry points apply to a kernel's operands before the wrappers check them,
and :func:`count_launch`, the one increment of the wrappers' launch
counters.

Kernels launch from more than one thread (the host parameter server's
workers are threads): one lock makes a library compile and load once
however many threads reach it first, and another makes every counter's
increment atomic.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = Path(os.environ.get("DISTKERAS_TPU_TORCH_BUILD_DIR")
                 or PACKAGE_DIR.parent / "build" / "torch_kernels")

#: every kernel source of the port, by name (``csrc/<name>.cu``)
KERNELS = ("flash_attention_fwd", "flash_attention_fwd_sm90",
           "flash_attention_bwd", "flash_attention_bwd_sm90", "fused_ce")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: held while a library is checked, compiled and loaded, so that two
#: threads never start ``nvcc`` into one path or load a half-written file
_BUILD_LOCK = threading.RLock()
#: held while a launch counter is bumped (``+=`` is not atomic)
_COUNT_LOCK = threading.Lock()

#: where every kernel operand must start: the sm90 kernels' TMA tensor maps
#: and the 16-byte vector loads
ALIGN_BYTES = 16


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def nvcc_command(name: str, output: Path) -> List[str]:
    """The compile line for one kernel source."""
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(output), str(source_path(name))]


def _stale(name: str) -> bool:
    """Is the library missing, or older than its source or any header of
    ``csrc/`` (a header is included by the sources that need it)?"""
    lib = library_path(name)
    if not lib.exists():
        return True
    inputs = [source_path(name), *CSRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(names: Sequence[str] = KERNELS) -> List[str]:
    """Compile every stale library among ``names``, one ``nvcc`` process
    per source, all started together.  Returns the names it compiled;
    raises if any compile fails."""
    with _BUILD_LOCK:
        return _build_locked(names)


def _build_locked(names: Sequence[str]) -> List[str]:
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    if not Path(_nvcc()).exists():
        raise RuntimeError(f"nvcc not found (looked for {_nvcc()}); the "
                           "port's CUDA kernels need the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        nvcc_command(name, library_path(name)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in todo}
    errors = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def load(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load its shared library (under the
    build lock: a thread that finds the library being compiled waits for
    it)."""
    with _BUILD_LOCK:
        build([name])
        return ctypes.CDLL(str(library_path(name)))


def count_launch(fn, attr: str = "launches", by_variant: str = None,
                 variant: str = None) -> None:
    """Add one to the counter ``attr`` of the wrapper ``fn`` and, with
    ``by_variant``, to ``variant``'s entry of that dict attribute, as one
    atomic step (launches come from several threads)."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
        if by_variant is not None:
            getattr(fn, by_variant)[variant] += 1


def _needs_copy(t: torch.Tensor) -> bool:
    """Is ``t`` a CUDA tensor that the kernels cannot read as it lies: not
    contiguous, or not starting on an ``ALIGN_BYTES`` boundary?
    (``Tensor.contiguous()`` keeps a misaligned contiguous view, so the
    address is tested on its own.)"""
    if t.device.type != "cuda":
        return False
    address = (t.untyped_storage().data_ptr()
               + t.storage_offset() * t.element_size())
    return not t.is_contiguous() or address % ALIGN_BYTES != 0


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: a fresh contiguous copy where
    :func:`_needs_copy` says so (a layout copy; autograd carries a gradient
    back into the view's shape and strides), else ``t`` itself."""
    if _needs_copy(t):
        return t.clone(memory_format=torch.contiguous_format)
    return t
