"""The JAX package's native extensions, built for the port's tests.

The JAX package binds its C++ extensions (``distkeras_tpu._wirecodec``,
``._csvloader``, ``._applykernel``) once, at import, from files that
``setup.py build_ext --inplace`` leaves beside its modules; a fresh
checkout has none.  The port's tests that hold a native route against
the JAX package's must not depend on whether, or when, some other process
built those files, so they take the JAX extensions from here instead
(:func:`load`) and monkeypatch them onto the JAX module
(``jnet._native``, ``jds._native_csv``, ``japply._native``).

:func:`load` compiles ``csrc/<name>.cpp`` with ``setup.py``'s flags (plus
``-shared -fPIC`` and this interpreter's headers) by the ``g++`` on
``PATH`` into a directory of its own under the system temp dir, named by
a hash of the source, the flags and the interpreter's extension suffix.
The build runs under an ``flock`` on that directory's lock file, writes
a temporary name and ``os.replace``s it into place, so concurrent test
processes compile once and never see half a file.  The module is loaded
from that path under the JAX package's own name (``PyInit_<name>``
depends only on the last component) and is not put in ``sys.modules``.
A failed build raises with the compiler's output."""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "csrc"

#: setup.py's extra_compile_args, by extension
FLAGS = {"wirecodec": ("-O3", "-std=c++17"),
         "csvloader": ("-O3", "-std=c++17"),
         "applykernel": ("-O3", "-std=c++17", "-ffp-contract=off")}

_loaded = {}
_lock = threading.Lock()


def _command(name: str, output: Path):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH: the JAX package's extensions "
                           "are built from csrc/*.cpp for the port's tests")
    include = sysconfig.get_paths()["include"]
    return [cxx, *FLAGS[name], "-shared", "-fPIC", f"-I{include}", "-o",
            str(output), str(CSRC / f"{name}.cpp")]


def build_dir(name: str) -> Path:
    """The directory that holds ``name``'s build: keyed by the source,
    the flags and the extension suffix."""
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(FLAGS[name]).encode())
    h.update(sysconfig.get_config_var("EXT_SUFFIX").encode())
    return (Path(tempfile.gettempdir()) / "distkeras_tpu_jax_native"
            / f"{name}-{h.hexdigest()[:16]}")


def build(name: str) -> Path:
    """The path of ``name``'s extension, compiled first if it is not
    there yet."""
    if name not in FLAGS:
        raise ValueError(f"unknown JAX extension {name!r}; "
                         f"known: {sorted(FLAGS)}")
    out = build_dir(name)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"_{name}{sysconfig.get_config_var('EXT_SUFFIX')}"
    with open(out / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            partial = out / f"tmp{os.getpid()}_{threading.get_ident()}.so"
            try:
                r = subprocess.run(_command(name, partial),
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(
                        f"compiling csrc/{name}.cpp failed:\n"
                        f"{r.stdout}{r.stderr}")
                os.replace(partial, path)
            finally:
                if partial.exists():
                    partial.unlink()
    return path


def load(name: str):
    """The JAX package's extension ``name`` (``"wirecodec"``,
    ``"csvloader"`` or ``"applykernel"``) as the module
    ``distkeras_tpu._<name>``, built from this checkout's source; loaded
    once a process."""
    with _lock:
        mod = _loaded.get(name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                f"distkeras_tpu._{name}", build(name))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _loaded[name] = mod
        return mod
