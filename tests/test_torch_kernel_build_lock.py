"""The kernel build across processes, on the CPU.

The cross-process parameter-server engine runs its LM workers as separate
interpreters, and each one that finds a kernel library stale builds it.
Two of them must not both start ``nvcc`` into one file, and neither may
load a file that the other is still writing: ``kernels.build`` holds an
``fcntl.flock`` on ``BUILD_DIR/.lock`` around the check, the compile and
the load, and ``nvcc`` writes to a temporary name that ``os.replace``
puts in place.

Here ``nvcc`` is a script put first on ``PATH``: it logs its start, waits,
and writes its output in slow chunks that end in a trailer.  Two child
processes, released together, call ``kernels.build(["fused_ce"])`` into
one empty build directory and read the library back: the fake must run
once, and both must read the whole file."""

import os
import stat
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CHUNKS = 12
TRAILER = b"END-OF-LIBRARY\n"

FAKE_NVCC = '''#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(f"{{os.getpid()}}\\n")
time.sleep(0.3)
with open(out, "wb") as f:
    for i in range({chunks}):
        f.write(b"chunk %02d\\n" % i)
        f.flush()
        time.sleep(0.03)
    f.write({trailer!r})
'''

CHILD = textwrap.dedent('''
    import os, sys, time
    from distkeras_tpu_torch import kernels
    go, ready = sys.argv[1], sys.argv[2]
    open(ready, "w").close()
    while not os.path.exists(go):
        time.sleep(0.001)
    built = kernels.build(["fused_ce"])
    data = kernels.library_path("fused_ce").read_bytes()
    print(len(built), data.endswith({trailer!r}), data.count(b"chunk"))
''')


def test_two_processes_build_once_and_read_a_whole_library(tmp_path):
    bindir, build_dir = tmp_path / "bin", tmp_path / "build"
    bindir.mkdir()
    log, go = tmp_path / "nvcc.log", tmp_path / "go"
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     chunks=CHUNKS, trailer=TRAILER))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    env = dict(os.environ,
               PATH=f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                   if p),
               DISTKERAS_TPU_TORCH_BUILD_DIR=str(build_dir),
               OMP_NUM_THREADS="1")
    code = CHILD.format(trailer=TRAILER)
    ready = [tmp_path / f"ready{i}" for i in range(2)]
    children = [subprocess.Popen(
        [sys.executable, "-c", code, str(go), str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in ready]
    # release both at once, when each has imported the port
    deadline = time.monotonic() + 120
    while not all(r.exists() for r in ready):
        assert all(c.poll() is None for c in children), \
            [c.communicate() for c in children]
        assert time.monotonic() < deadline
        time.sleep(0.005)
    go.write_text("")
    outs = [c.communicate(timeout=120) for c in children]
    for c, (out, err) in zip(children, outs):
        assert c.returncode == 0, err
    starts = log.read_text().split()
    assert len(starts) == 1, f"nvcc ran {len(starts)} times"
    results = sorted(tuple(out.split()) for out, _ in outs)
    # one child compiled, the other found the library built; both read
    # every chunk and the trailer
    assert results == [("0", "True", str(CHUNKS)),
                       ("1", "True", str(CHUNKS))]
    lib = build_dir / "libfused_ce.so"
    assert lib.read_bytes().endswith(TRAILER)
    # no temporary output left behind; the lock file stays
    assert sorted(p.name for p in build_dir.iterdir()) == [
        ".lock", "libfused_ce.so"]
