"""Kernel loading and launch counting from many threads, on the CPU.

The host parameter server's workers are threads, and the LM's windows
reach the flash kernels from several of them at once.  A library must
then compile and load once (``kernels.load`` under its build lock), a C
entry point must bind once (``_entry`` of ``ops/flash_attention.py`` and
``ops/fused_ce.py``), and every launch counter's increment must land
(``kernels.count_launch``).  Nothing compiles here: ``subprocess.Popen``,
``_stale``, ``_nvcc`` and ``ctypes.CDLL`` are stood in for, and each
thread switch is forced every microsecond to provoke the races."""

import importlib
import sys
import threading

import pytest

from distkeras_tpu_torch import kernels

# the modules (the package's ``ops`` exports functions of the same names)
fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")

THREADS = 8


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run(target, n=THREADS):
    """Start ``n`` threads at one barrier on ``target(i)``; join them."""
    barrier = threading.Barrier(n)
    errors = []

    def body(i):
        try:
            barrier.wait(timeout=10)
            target(i)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_load_compiles_once_from_eight_threads(monkeypatch, tmp_path,
                                               fast_switching):
    built, starts, loaded = set(), [], []
    entered = threading.Semaphore(0)

    class FakeCompile:
        def __init__(self, cmd, **kw):
            starts.append(cmd)
            self.returncode = 0
            self._out = cmd[cmd.index("-o") + 1]
            self._name = next(n for n in kernels.KERNELS
                              if self._out.endswith(f"lib{n}.so"))

        def communicate(self):
            # hold the compile until every thread has asked for the
            # library: without the lock each would start its own nvcc
            for _ in range(THREADS):
                entered.acquire(timeout=10)
            built.add(self._name)
            # nvcc's output name, which the build moves into place
            with open(self._out, "wb") as f:
                f.write(b"lib")
            return "", None

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(kernels, "_stale", lambda name: name not in built)
    monkeypatch.setattr(kernels.subprocess, "Popen", FakeCompile)
    monkeypatch.setattr(kernels.ctypes, "CDLL",
                        lambda path: loaded.append(path) or object())

    def load(i):
        entered.release()
        kernels.load("fused_ce")

    _run(load)
    assert len(starts) == 1
    assert built == {"fused_ce"}
    assert loaded == [str(kernels.library_path("fused_ce"))] * THREADS


@pytest.mark.parametrize("module,name", [
    (fa, "flash_attention_fwd_sm90"), (fa, "flash_attention_bwd_dq_sm90"),
    (ce, "fused_ce_fwd")], ids=["fwd_sm90", "dq_sm90", "ce_fwd"])
def test_entry_binds_once_from_eight_threads(monkeypatch, module, name,
                                             fast_switching):
    loads = []

    class FakeLib:
        def __getattr__(self, attr):
            fn = type("Fn", (), {})()
            fn.name = attr
            return fn

    def fake_load(lib_name):
        loads.append(lib_name)
        return FakeLib()

    monkeypatch.setattr(kernels, "load", fake_load)
    monkeypatch.setattr(module, "_fns", {})
    got = []
    _run(lambda i: got.append(module._entry(name)))
    assert len(loads) == 1
    assert len({id(fn) for fn in got}) == 1 and got[0].name == name
    assert got[0].restype is not None and got[0].argtypes


def test_launch_counters_sum_exactly(fast_switching):
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_by_variant = {"sm90": 0, "simt": 0}
    per_thread = 2000

    def bump(i):
        variant = ("sm90", "simt")[i % 2]
        for _ in range(per_thread):
            kernels.count_launch(wrapper, "launches", "launches_by_variant",
                                 variant)

    _run(bump)
    assert wrapper.launches == THREADS * per_thread
    assert wrapper.launches_by_variant == {"sm90": THREADS // 2 * per_thread,
                                           "simt": THREADS // 2 * per_thread}


def test_the_wrappers_count_through_the_lock():
    """Every launch counter of the kernels' wrappers goes through
    ``count_launch`` (a ``+=`` on a function attribute is not atomic)."""
    import inspect
    for module in (fa, ce):
        src = inspect.getsource(module)
        assert "launches += 1" not in src and "] += 1" not in src
        assert "count_launch(" in src
