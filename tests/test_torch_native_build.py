"""The port's builds of its host C++ extensions (``distkeras_tpu_torch.
native``): ``csrc/wirecodec.cpp``, ``csrc/csvloader.cpp`` and
``csrc/applykernel.cpp``, its own copies of the JAX package's sources,
compiled at first use by the host compiler on ``PATH`` into the kernels'
build directory.

Two processes that race to a fresh build directory run the compiler once
between them (the build lock of the CUDA kernels); a touched source
rebuilds its module and nothing else; a missing compiler or a source that
does not compile raises with the reason, and nothing falls back to the
pure-Python twins (the codec, the apply and ``read_csv`` all raise); each
module loads under the port's name from the build directory, with the
flags the JAX package's ``setup.py`` gives it."""

import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import applykernel, kernels, native, networking
from distkeras_tpu_torch.data import datasets

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: each module's entry points (the JAX package's modules have the same)
ENTRIES = {"wirecodec": ("encode_frames", "decode_frames", "decode_payload"),
           "csvloader": ("parse_numeric",),
           "applykernel": ("axpy_f32", "scatter_add_f32")}


@pytest.fixture()
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and nothing loaded in this process."""
    build = tmp_path / "build"
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_loaded", {})
    return build


def test_two_processes_race_and_the_compiler_runs_once(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               DISTKERAS_TPU_TORCH_BUILD_DIR=str(tmp_path / "race"))
    code = ("from distkeras_tpu_torch import native; "
            "m = native.load('applykernel'); "
            "print(native.compiles, m.__name__)")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=str(tmp_path), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    compiles = sorted(int(out.split()[0]) for out, _ in outs)
    assert compiles == [0, 1]
    assert {out.split()[1] for out, _ in outs} == {
        "distkeras_tpu_torch._applykernel"}
    left = sorted(p.name for p in (tmp_path / "race").iterdir())
    assert left == [".lock", native.module_path("applykernel").name]


def test_touching_a_source_rebuilds_that_module_only(tmp_path, fresh_build,
                                                     monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("applykernel", "csvloader"):
        shutil.copy(native.source_path(name), csrc)
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    names = ["applykernel", "csvloader"]
    before = native.compiles
    assert sorted(native.build(names)) == sorted(names)
    assert native.build(names) == []
    built = native.module_path("applykernel").stat().st_mtime
    os.utime(native.module_path("applykernel"), (built - 10, built - 10))
    os.utime(csrc / "applykernel.cpp")  # touched: newer than its module
    assert native.build(names) == ["applykernel"]
    assert native.compiles - before == 3
    assert native.build(names) == []


def test_an_empty_path_raises_rather_than_falling_back(tmp_path, fresh_build,
                                                       monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="no C..? compiler"):
        native.load("wirecodec")
    monkeypatch.setattr(networking, "_native", networking._UNRESOLVED)
    with pytest.raises(RuntimeError, match="compiler"):
        networking.encode_message({"w": np.zeros(2, np.float32)})
    monkeypatch.setattr(applykernel, "_native", applykernel._UNRESOLVED)
    for kern in ("native", "auto"):
        with pytest.raises(RuntimeError, match="compiler"):
            applykernel.resolve(kern)
    monkeypatch.setattr(datasets, "_native_csv", datasets._UNRESOLVED)
    path = tmp_path / "t.csv"
    path.write_text("label,a\n1,2\n")
    with pytest.raises(RuntimeError, match="compiler"):
        datasets.read_csv(str(path), "label")
    assert not any(p.suffix == ".so" for p in fresh_build.iterdir())


def test_a_source_that_does_not_compile_raises_with_the_output(
        tmp_path, fresh_build, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "applykernel.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    with pytest.raises(RuntimeError, match="applykernel.cpp failed") as e:
        native.load("applykernel")
    assert "error" in str(e.value)
    assert not native.module_path("applykernel").exists()
    assert [p.name for p in fresh_build.iterdir()] == [".lock"]


def test_unknown_names_are_refused():
    with pytest.raises(ValueError, match="unknown host extension"):
        native.build(["fused_ce"])


@pytest.mark.parametrize("name", native.MODULES)
def test_the_compile_line_is_the_packages(name, tmp_path):
    cmd = native.compile_command(name, tmp_path / "out.so")
    assert Path(cmd[0]).name in ("g++", "c++")
    include = sysconfig.get_paths()["include"]
    assert cmd[1:6] == ["-O3", "-std=c++17", "-shared", "-fPIC",
                        f"-I{include}"]
    assert (Path(include) / "Python.h").exists()
    assert ("-ffp-contract=off" in cmd) == (name == "applykernel")
    assert cmd[-1] == str(native.CSRC_DIR / f"{name}.cpp")


@pytest.mark.parametrize("name", native.MODULES)
def test_each_module_loads_under_the_ports_name(name):
    mod = native.load(name)
    assert mod is native.load(name)  # once a process
    assert mod.__name__ == f"distkeras_tpu_torch._{name}"
    assert Path(mod.__file__) == native.module_path(name)
    assert Path(mod.__file__).parent == kernels.BUILD_DIR
    for entry in ENTRIES[name]:
        assert callable(getattr(mod, entry))


@pytest.mark.parametrize("name", native.MODULES)
def test_each_source_is_the_jax_packages_with_a_header(name):
    """The port's copy is the JAX package's file below a header naming
    it, so the modules compute the same bytes."""
    mine = native.source_path(name).read_text()
    theirs = (ROOT / "csrc" / f"{name}.cpp").read_text()
    assert mine.startswith(f"/* A copy of csrc/{name}.cpp of the JAX")
    assert mine.endswith(theirs)
    header = mine[:len(mine) - len(theirs)]
    assert header.count("*/") == 1 and header.rstrip().endswith("*/")
