"""Build and load the port's host C++ extensions.

Three CPython extension modules run on the host, beside the CUDA kernels
of :mod:`kernels`: the wire codec (``csrc/wirecodec.cpp``:
``encode_frames``, ``decode_frames``, ``decode_payload``), the CSV parser
(``csrc/csvloader.cpp``: ``parse_numeric``) and the parameter server's
apply kernel (``csrc/applykernel.cpp``: ``axpy_f32``,
``scatter_add_f32``).  The sources are the port's own copies of the JAX
package's; each is compiled at first use by the host C++ compiler found
on ``PATH`` (``g++``, else ``c++``) with ``-O3 -std=c++17 -shared -fPIC``
against this interpreter's headers into ``kernels.BUILD_DIR`` as
``_<name><EXT_SUFFIX>`` and loaded from that file as
``distkeras_tpu_torch._<name>``.  ``applykernel`` also gets
``-ffp-contract=off``: its contract is bit-equality with the numpy apply,
and an FMA would round ``dst + scale * src`` once where numpy rounds
twice.

A build runs under :func:`kernels._build_dir_lock` (a thread lock and an
``flock`` on ``BUILD_DIR/.lock``), so however many threads and processes
reach a stale module first, the compiler runs once; it writes to a
temporary name that ``os.replace`` puts in place.  A module is stale when
it is missing or older than its source.  A build that fails raises with
the compiler's output: nothing falls back to the pure-Python twins.
Processes that a driver starts (PS workers, PS shards) load the driver's
build: the driver calls :func:`build` before it spawns them.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List, Sequence

from . import kernels

CSRC_DIR = kernels.CSRC_DIR

#: every host extension of the port, by name (``csrc/<name>.cpp``)
MODULES = ("wirecodec", "csvloader", "applykernel")

#: flags beyond the common ones, by module
EXTRA_FLAGS = {"applykernel": ("-ffp-contract=off",)}

#: compiler runs of this process (a worker process that loads its driver's
#: build reports 0)
compiles = 0

_loaded: Dict[str, object] = {}
_LOAD_LOCK = threading.Lock()


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cpp"


def module_path(name: str) -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    return kernels.BUILD_DIR / f"_{name}{suffix}"


def compiler() -> str:
    """The host C++ compiler on ``PATH``: ``g++``, else ``c++``."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH; the port's "
                       "host extensions are built from csrc/*.cpp at first "
                       "use")


def compile_command(name: str, output: Path) -> List[str]:
    """The compile line for one extension source."""
    include = sysconfig.get_paths()["include"]
    return [compiler(), "-O3", "-std=c++17", "-shared", "-fPIC",
            f"-I{include}", *EXTRA_FLAGS.get(name, ()), "-o", str(output),
            str(source_path(name))]


def _stale(name: str) -> bool:
    mod = module_path(name)
    return (not mod.exists()
            or mod.stat().st_mtime < source_path(name).stat().st_mtime)


def build(names: Sequence[str] = MODULES) -> List[str]:
    """Compile every stale module among ``names``, one compiler process per
    source, all started together.  Returns the names it compiled; raises
    with the compiler's output if any compile fails."""
    global compiles
    for name in names:
        if name not in MODULES:
            raise ValueError(f"unknown host extension {name!r}; the port "
                             f"builds {MODULES}")
    with kernels._build_dir_lock():
        todo = [n for n in names if _stale(n)]
        if not todo:
            return []
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = {n: kernels.BUILD_DIR / f"tmp{os.getpid()}_{n}.so"
                   for n in todo}
        procs = {n: subprocess.Popen(
            compile_command(n, partial[n]), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for n in todo}
        errors = []
        for n, proc in procs.items():
            out, _ = proc.communicate()
            compiles += 1
            if proc.returncode != 0:
                errors.append(f"compiling csrc/{n}.cpp failed "
                              f"({' '.join(proc.args)}):\n{out}")
        try:
            if errors:
                raise RuntimeError("\n".join(errors))
            for n in todo:
                os.replace(partial[n], module_path(n))
        finally:
            for path in partial.values():
                if path.exists():
                    path.unlink()
        return todo


def load(name: str):
    """The extension module ``name``, built first if it is stale; loaded
    once a process."""
    with _LOAD_LOCK:
        mod = _loaded.get(name)
        if mod is not None:
            return mod
        with kernels._build_dir_lock():
            build([name])
            path = module_path(name)
            spec = importlib.util.spec_from_file_location(
                f"distkeras_tpu_torch._{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _loaded[name] = mod
        return mod
