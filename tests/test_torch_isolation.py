"""The port stands alone: no module of ``distkeras_tpu_torch``, and none
of the card scripts (``chip_smoke.py``, ``tools/profile_torch_slice.py``,
``tools/compare_simt_builds.py``, ``tools/time_simt_builds.py``,
``tools/simt_backward_share.py``, ``tools/simt_forward_share.py``,
``tools/host_ps_threads.py``, ``tools/gloo_device_ops.py``), imports
jax or the JAX package; importing the port pulls in no jax, nor does a
run of ``python -m distkeras_tpu_torch.dryrun`` and its ranks; and its
entry points refuse to drop to the CPU when no CUDA card is present."""

import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distkeras_tpu_torch as port
from distkeras_tpu_torch import (Dense, FittedModel, ModelPredictor,
                                 Sequential, transformer_lm)
from distkeras_tpu_torch.job_deployment import Job

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "distkeras_tpu", "ml_dtypes",
          "keras"}
TINY = dict(vocab_size=16, seq_len=8, d_model=8, num_heads=2,
            num_layers=1, mlp_dim=8)


def port_files():
    files = sorted((ROOT / "distkeras_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tools" / "profile_torch_slice.py",
                    ROOT / "tools" / "compare_simt_builds.py",
                    ROOT / "tools" / "time_simt_builds.py",
                    ROOT / "tools" / "simt_backward_share.py",
                    ROOT / "tools" / "simt_forward_share.py",
                    ROOT / "tools" / "host_ps_threads.py",
                    ROOT / "tools" / "gloo_device_ops.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


#: the modules of the decode, packing, serving, host-PS and online slices
#: (data/packing.py, resilience.py, networking.py, applykernel.py and
#: ps_sharding.py are copies of numpy-only parts of the JAX package, kept
#: in the port)
NEW_MODULES = ("core/decode.py", "core/quant.py", "data/packing.py",
               "serving.py", "resilience.py", "networking.py",
               "parameter_servers.py", "workers.py", "applykernel.py",
               "ps_sharding.py", "streaming.py", "job_deployment.py",
               "ps_worker_main.py", "ps_shard_main.py",
               "deployment_online.py", "parallel/moe.py",
               "parallel/collective.py", "parallel/pipeline.py",
               "parallel/pp_transformer.py", "dryrun.py", "native.py",
               "utils.py", "core/keras_adapter.py", "data/datasets.py",
               "examples/mnist_mlp_single.py",
               "examples/mnist_convnet_adag.py",
               "examples/cifar10_downpour.py", "examples/higgs_workflow.py",
               "examples/loadgen.py")


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = port_files()
    assert len(files) >= 15
    for rel in NEW_MODULES:
        assert ROOT / "distkeras_tpu_torch" / rel in files, rel
    for path in files:
        bad = imported_roots(path) & BANNED
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_resilience_imports_only_numpy_torch_and_the_stdlib():
    """Every import of ``resilience.py``, the function-level ones of the
    journal and the supervisors included, is the standard library, numpy,
    torch or the port's own modules."""
    path = ROOT / "distkeras_tpu_torch" / "resilience.py"
    roots = imported_roots(path)
    allowed = set(sys.stdlib_module_names) | {"__future__", "numpy",
                                              "torch"}
    assert roots and roots <= allowed, sorted(roots - allowed)
    relative = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            relative |= ({node.module} if node.module
                         else {a.name for a in node.names})
    assert relative == {"networking", "checkpoint", "parameter_servers",
                        "ps_sharding"}, relative


def test_importing_the_port_loads_no_jax():
    code = ("import sys, distkeras_tpu_torch, distkeras_tpu_torch.kernels; "
            "import distkeras_tpu_torch.core.decode, "
            "distkeras_tpu_torch.core.quant, "
            "distkeras_tpu_torch.data.packing, "
            "distkeras_tpu_torch.serving, distkeras_tpu_torch.resilience, "
            "distkeras_tpu_torch.networking, "
            "distkeras_tpu_torch.parameter_servers, "
            "distkeras_tpu_torch.workers, distkeras_tpu_torch.applykernel, "
            "distkeras_tpu_torch.ps_sharding, distkeras_tpu_torch.streaming, "
            "distkeras_tpu_torch.job_deployment, "
            "distkeras_tpu_torch.ps_worker_main, "
            "distkeras_tpu_torch.ps_shard_main, "
            "distkeras_tpu_torch.deployment_online, "
            "distkeras_tpu_torch.parallel.moe, "
            "distkeras_tpu_torch.parallel.collective, "
            "distkeras_tpu_torch.native, distkeras_tpu_torch.utils, "
            "distkeras_tpu_torch.core.keras_adapter, "
            "distkeras_tpu_torch.examples.mnist_mlp_single, "
            "distkeras_tpu_torch.examples.mnist_convnet_adag, "
            "distkeras_tpu_torch.examples.cifar10_downpour, "
            "distkeras_tpu_torch.examples.higgs_workflow, "
            "distkeras_tpu_torch.examples.loadgen; "
            "import chip_smoke; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(BANNED)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_native_routes_load_no_jax_keras_or_the_jax_packages_modules(
        tmp_path):
    """Encoding and decoding a message, a native axpy and a native
    ``read_csv`` load the port's own builds (``distkeras_tpu_torch._*``)
    and nothing of jax, Keras or the JAX package: no module of theirs, and
    no shared object from the JAX package's directory."""
    csv = tmp_path / "t.csv"
    csv.write_text("label,a,b\n1,0.5,2\n0,1.5,-3\n")
    code = (
        "import sys, numpy as np\n"
        "from distkeras_tpu_torch import applykernel, networking\n"
        "from distkeras_tpu_torch.data import datasets\n"
        "msg = {'w': [np.arange(6, dtype=np.float32)], 'clock': 3}\n"
        "out = networking.decode_message(networking.encode_message(msg))\n"
        "assert out['clock'] == 3\n"
        "dst = np.zeros(6, np.float32)\n"
        "applykernel.axpy(applykernel.resolve('native'), dst, out['w'][0], "
        "0.5)\n"
        "assert dst[2] == 1.0\n"
        f"ds = datasets.read_csv({str(csv)!r}, 'label')\n"
        "assert ds['features'].shape == (2, 2)\n"
        "assert networking._native.__name__ == "
        "'distkeras_tpu_torch._wirecodec'\n"
        "assert datasets._native_csv.__name__ == "
        "'distkeras_tpu_torch._csvloader'\n"
        "jax_dir = %r\n"
        "bad = sorted(m for m, mod in sys.modules.items() if "
        f"m.split('.')[0] in {sorted(BANNED)!r} or "
        "str(getattr(mod, '__file__', '') or '').startswith(jax_dir))\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(bad, jax_dir + '_' in maps)\n"
        % (str(ROOT / "distkeras_tpu") + os.sep))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"


def test_a_rank_started_through_initialize_from_env_loads_no_jax(tmp_path):
    """A rank child of a coordinated ``Job`` of 2 processes, joined through
    ``initialize_from_env`` over gloo, runs the MoE layer across both
    ranks and has loaded neither jax nor the JAX package."""
    import torch_ranks as tr
    script = tmp_path / "rank.py"
    script.write_text(
        "import sys, numpy as np, torch\n"
        "from distkeras_tpu_torch.job_deployment import "
        "initialize_from_env\n"
        "initialize_from_env()\n"
        "from distkeras_tpu_torch.parallel import Mesh, moe\n"
        "mesh = Mesh(np.array(['cpu'] * 2, dtype=object), ('model',))\n"
        "g = torch.Generator().manual_seed(0)\n"
        "x, r = torch.randn(2, 4, 8, generator=g), torch.randn(8, 4)\n"
        "w1, w2 = torch.randn(2, 8, 16), torch.randn(2, 16, 8)\n"
        "y, _ = moe.moe_mlp(x, r, w1, torch.zeros(2, 16), w2, "
        "torch.zeros(2, 8), mesh=mesh)\n"
        "assert y.shape == (2, 4, 8)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(BANNED)!r}))\n")
    job = Job("iso", str(script), hosts=["127.0.0.1"] * 2, backend="gloo",
              coordinator_port=tr.free_port(),
              env={"OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)})
    assert job.host_env(0)["DISTKERAS_TPU_BACKEND"] == "gloo"
    outs = []
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(os.environ, **job.host_env(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert outs == ["[]", "[]"]


def test_the_dryrun_main_loads_no_jax():
    """``python -m distkeras_tpu_torch.dryrun 1 cpu``: the driver and its
    rank child (``python -m distkeras_tpu_torch.dryrun --rank``) finish
    every part with finite losses and neither has loaded jax or the JAX
    package (tests/test_torch_dryrun.py runs 2 and 4 ranks)."""
    import json
    out = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.dryrun", "1", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["modules"] == [] and len(result["ranks"]) == 1
    for rank in result["ranks"]:
        assert rank["modules"] == []
        for part in ("adag", "transformer", "ulysses_fsdp",
                     "pipeline_gpipe", "pipeline_1f1b"):
            assert all(map(math.isfinite, (rank[part] if part == "adag"
                                           else [rank[part]]))), part


@pytest.mark.parametrize("main", ["ps_worker_main", "ps_shard_main"])
def test_the_process_mains_print_their_usage_and_load_no_jax(main):
    """``python -m distkeras_tpu_torch.<main>`` with no arguments exits 2
    with its usage line; run as ``__main__`` in one interpreter, it leaves
    no jax module loaded."""
    out = subprocess.run([sys.executable, "-m", f"distkeras_tpu_torch.{main}"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2
    assert out.stderr.startswith(
        f"usage: python -m distkeras_tpu_torch.{main} <config.json>")
    code = ("import runpy, sys\n"
            "sys.argv = ['main']\n"
            "try:\n"
            f"    runpy.run_module('distkeras_tpu_torch.{main}', "
            "run_name='__main__', alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    print(e.code)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(BANNED)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["2", "[]"]


def test_a_worker_process_without_a_device_asks_for_the_card(tmp_path):
    """A worker config without ``device`` gets the card rule: with no card
    the child raises (exit 1, "no CUDA device") and never trains on the
    CPU."""
    import json

    import numpy as np

    from distkeras_tpu_torch.core.model import serialize_model
    from distkeras_tpu_torch.ps_worker_main import save_model_blob
    model = Sequential([Dense(3)], input_shape=(4,), device="cpu")
    save_model_blob(str(tmp_path / "m.npz"), serialize_model(model))
    np.savez(tmp_path / "s.npz", x=np.zeros((8, 4), np.float32),
             y=np.zeros((8, 3), np.float32))
    cfg = tmp_path / "w.json"
    cfg.write_text(json.dumps({
        "algorithm": "downpour", "model_path": str(tmp_path / "m.npz"),
        "shard_paths": [str(tmp_path / "s.npz")],
        "result_paths": [str(tmp_path / "r.npz")],
        "worker_optimizer": "sgd", "loss": "mse", "ps_host": "127.0.0.1",
        "ps_port": 1, "features_col": "features", "label_col": "label"}))
    out = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.ps_worker_main",
         str(cfg), "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    if torch.cuda.is_available():  # pragma: no cover - the card's machine
        return
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "r.npz").exists()


def test_entry_points_default_to_the_card(tmp_path):
    """``device=None`` means CUDA: without a card every entry point raises
    rather than running on the CPU; with one, it builds on the card."""
    fitted = FittedModel(transformer_lm(**TINY, device="cpu"))
    path = str(tmp_path / "m.npz")
    fitted.save(path)
    calls = {
        "transformer_lm": lambda: transformer_lm(**TINY),
        "Sequential": lambda: Sequential([Dense(3)], input_shape=(4,)),
        "FittedModel.load": lambda: FittedModel.load(path),
        "ModelPredictor": lambda: ModelPredictor(fitted).model,
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            built = call()
            model = built.model if isinstance(built, FittedModel) else built
            assert model.device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    # the PS trainers' worker threads and processes run on the card too
    for execution in ("host_ps", "process_ps"):
        if torch.cuda.is_available():
            trainer = port.ADAG(fitted, num_workers=2, execution=execution)
            assert trainer.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port.ADAG(fitted, num_workers=2, execution=execution)
    assert "transformer_lm" in port.__all__
