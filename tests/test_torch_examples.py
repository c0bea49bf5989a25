"""The reference workloads' examples on the port
(``python -m distkeras_tpu_torch.examples.<name>``), at tiny sizes on the
CPU (``--device cpu``): each exits 0 and prints its accuracy line.  The
runs start together, as subprocesses, and load nothing of jax, Keras or
the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--rows", "64", "--test-rows", "32", "--epochs", "1",
        "--batch-size", "16", "--device", "cpu"]
RUNS = {
    "mnist_mlp_single": ["mnist_mlp_single"],
    "mnist_convnet_adag": ["mnist_convnet_adag", "--window", "2"],
    "cifar10_downpour": ["cifar10_downpour", "--window", "2"],
    "cifar10_downpour_host_ps": ["cifar10_downpour", "--window", "2",
                                 "--execution", "host_ps", "--workers",
                                 "2", "--wire", "bfloat16"],
    "higgs_workflow": ["higgs_workflow"],
}
#: the line each example ends with
ACCURACY = {"higgs_workflow": "EAMSGD "}
CHECK = ("import runpy, sys; sys.argv = sys.argv[1:]; "
         "runpy.run_module(sys.argv[0], run_name='__main__'); "
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'keras', 'distkeras_tpu', 'ml_dtypes')); "
         "print('banned', bad)")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    cwd = tmp_path_factory.mktemp("examples")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", CHECK,
         f"distkeras_tpu_torch.examples.{args[0]}", *args[1:], *TINY],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in RUNS.items()}
    return {name: (p, *p.communicate(timeout=240))
            for name, p in procs.items()}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_each_example_runs_on_the_cpu(runs, name):
    proc, out, err = runs[name]
    assert proc.returncode == 0, err[-2000:]
    lines = out.strip().splitlines()
    assert lines[-1] == "banned []"
    want = ACCURACY.get(name, "test accuracy: ")
    assert lines[-2].startswith(want), out
