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
workers are threads) and from more than one process (the cross-process
engine's workers): a thread lock and an ``fcntl.flock`` on
``BUILD_DIR/.lock`` make a library compile and load once however many
threads and processes reach it first, ``nvcc`` writes to a temporary name
in ``BUILD_DIR`` that ``os.replace`` puts in place (no process ever loads
a half-written library), and another lock makes every counter's
increment atomic.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
#: (:func:`_build_dir_lock` does the same across processes)
_BUILD_LOCK = threading.RLock()
#: how deep this process is inside :func:`_build_dir_lock` (the thread lock
#: is re-entrant; the file lock is taken once, by the outermost holder)
_FLOCK_DEPTH = 0
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


@contextlib.contextmanager
def _build_dir_lock():
    """The build lock of this thread and of every process that builds into
    ``BUILD_DIR``: the thread lock, then an exclusive ``flock`` on
    ``BUILD_DIR/.lock`` (another process holding it is building or loading;
    the staleness check runs again once it lets go)."""
    global _FLOCK_DEPTH
    with _BUILD_LOCK:
        if _FLOCK_DEPTH:
            _FLOCK_DEPTH += 1
            try:
                yield
            finally:
                _FLOCK_DEPTH -= 1
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            _FLOCK_DEPTH = 1
            try:
                yield
            finally:
                _FLOCK_DEPTH = 0
                fcntl.flock(lock, fcntl.LOCK_UN)


def build(names: Sequence[str] = KERNELS) -> List[str]:
    """Compile every stale library among ``names``, one ``nvcc`` process
    per source, all started together.  Returns the names it compiled;
    raises if any compile fails."""
    with _build_dir_lock():
        return _build_locked(names)


def _build_locked(names: Sequence[str]) -> List[str]:
    todo = [n for n in names if _stale(n)]
    if not todo:
        return []
    if not Path(_nvcc()).exists():
        raise RuntimeError(f"nvcc not found (looked for {_nvcc()}); the "
                           "port's CUDA kernels need the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # each compile writes a name of this process's own; os.replace puts
    # the finished file in place, so a library path is whole or absent
    partial = {name: BUILD_DIR / f"tmp{os.getpid()}_lib{name}.so"
               for name in todo}
    procs = {name: subprocess.Popen(
        nvcc_command(name, partial[name]), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in todo}
    errors = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{out}")
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            os.replace(partial[name], library_path(name))
    finally:
        for path in partial.values():
            if path.exists():
                path.unlink()
    return todo


def load(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load its shared library (under the
    build lock: a thread or process that finds the library being compiled
    waits for it)."""
    with _build_dir_lock():
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


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter in this process, by name
    (``fused_ce_fwd``, ``flash_dq``, ``flash_dq_sm90``, ...).  A counter
    counts inside one process: a driver sums the counts its worker
    processes report."""
    import importlib
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    bwd = fa.flash_attention_backward
    by_variant = {"fwd_lse": fa.flash_attention_forward.launches_by_variant,
                  "dq": bwd.dq_launches_by_variant,
                  "dkv": bwd.dkv_launches_by_variant,
                  "inference": fa.flash_attention.launches_by_variant}
    return {"fused_ce_fwd": ce.fused_ce_fwd.launches,
            "fused_ce_bwd": ce.fused_ce_bwd.launches,
            "flash_fwd_lse": fa.flash_attention_forward.launches,
            "flash_dq": bwd.dq_launches,
            "flash_dkv": bwd.dkv_launches,
            "flash_inference": fa.flash_attention.launches,
            **{f"flash_{kernel}_{variant}": n
               for kernel, counts in by_variant.items()
               for variant, n in counts.items()}}


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
