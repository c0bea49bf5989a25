"""The port stands alone: no module of ``distkeras_tpu_torch``, and none
of the card scripts (``chip_smoke.py``, ``tools/profile_torch_slice.py``,
``tools/compare_simt_builds.py``), imports jax or the JAX package; importing the port pulls
in no jax; and its entry points refuse to drop to the CPU when no CUDA
card is present."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distkeras_tpu_torch as port
from distkeras_tpu_torch import (Dense, FittedModel, ModelPredictor,
                                 Sequential, transformer_lm)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "distkeras_tpu"}
TINY = dict(vocab_size=16, seq_len=8, d_model=8, num_heads=2,
            num_layers=1, mlp_dim=8)


def port_files():
    files = sorted((ROOT / "distkeras_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tools" / "profile_torch_slice.py",
                    ROOT / "tools" / "compare_simt_builds.py"]


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


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = port_files()
    assert len(files) >= 15
    for path in files:
        bad = imported_roots(path) & BANNED
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, distkeras_tpu_torch, distkeras_tpu_torch.kernels; "
            "import chip_smoke; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(BANNED)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


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
    assert "transformer_lm" in port.__all__
