"""Checkpoints and metrics of the port (``distkeras_tpu_torch/checkpoint.py``,
``metrics.py``) against the JAX package's behaviour.

The npz ``Checkpointer`` round-trips the port's ``DistState`` (center,
per-worker params with BatchNorm's statistics, per-worker optimizer
states with their integer counts, the round clock), keeps ``max_to_keep``
files, writes atomically and refuses a structure or shape mismatch.  A
run of the distributed trainer killed after an epoch, or mid-epoch with
``checkpoint_unit="round"``, and resumed, ends with the uninterrupted
run's weights to the bit; the three resume refusals of the JAX trainer
hold.  ``flops_per_example`` equals the JAX value for every zoo model and
for attention layers with GQA and a window; ``peak_flops`` knows the H100
SXM, PCIe and NVL parts by their device names, each its own figure.
"""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as port
from distkeras_tpu.metrics import flops_per_example as jax_flops
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu_torch import Dataset, Sequential
from distkeras_tpu_torch.checkpoint import (Checkpointer, foreign_checkpoints,
                                            make_checkpointer, tree_leaves)
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.metrics import (EpochMetrics, MetricsLogger,
                                         annotate, flops_per_example,
                                         peak_flops, trace)
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.parallel import SPMDEngine, get_mesh

torch.set_num_threads(1)

D, C = 10, 3


def mlp(bn=False):
    mid = [pl.BatchNormalization()] if bn else []
    return Sequential([pl.Dense(16, activation="relu"), *mid,
                       pl.Dense(C, activation="softmax")],
                      input_shape=(D,), compute_dtype="float32",
                      device="cpu", generator=torch.Generator().manual_seed(1))


def dataset(rows=128, seed=1):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (C, D))
    labels = rng.integers(0, C, rows)
    x = (protos[labels] + 0.3 * rng.standard_normal((rows, D))).astype(
        np.float32)
    return Dataset({"features": x,
                    "label_encoded": np.eye(C, dtype=np.float32)[labels]})


def cpu_mesh(n):
    return get_mesh(n, devices=["cpu"] * n)


def adag(**kw):
    kw = {**dict(mesh=cpu_mesh(4), batch_size=8, num_epoch=2,
                 communication_window=2, label_col="label_encoded",
                 worker_optimizer="adam", learning_rate=1e-3, seed=3), **kw}
    return port.ADAG(mlp(), **kw)


def same_weights(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.get_weights(),
                                                    b.get_weights()))


# -- the Checkpointer -------------------------------------------------------

def test_roundtrip_of_a_tree(tmp_path):
    class Pair(NamedTuple):
        a: object
        b: object

    ck = Checkpointer(str(tmp_path))
    state = {"params": [torch.arange(6.0).reshape(2, 3), torch.ones(4)],
             "opt": Pair((7, [torch.full((2,), 2.0)]), ()),
             "half": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
             "step": 7, "none": None}
    ck.save(1, state)
    target = {"params": [torch.zeros(2, 3), torch.zeros(4)],
              "opt": Pair((0, [torch.zeros(2)]), ()),
              "half": torch.zeros(2, dtype=torch.bfloat16),
              "step": 0, "none": None}
    got = ck.restore(target)
    assert torch.equal(got["params"][0], state["params"][0])
    assert isinstance(got["opt"], Pair) and got["opt"].a[0] == 7
    assert isinstance(got["opt"].a[0], int) and got["opt"].b == ()
    assert got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], state["half"])
    assert got["step"] == 7 and got["none"] is None
    assert len(tree_leaves(state)) == 6


def test_retention_latest_and_atomic_files(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, [torch.full((2,), float(s))], meta={"unit": "epoch"})
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.npz", "ckpt_4.npz"]
    assert ck.restore([torch.zeros(2)], step=3)[0].tolist() == [3.0, 3.0]
    assert ck.read_meta() == {"unit": "epoch"}


def test_mismatch_and_empty_directory_raise(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore([torch.zeros(2)])
    ck.save(1, [torch.zeros(2)])
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore([torch.zeros(2), torch.zeros(2)])
    with pytest.raises(ValueError, match="shape"):
        ck.restore([torch.zeros(3)])


def test_backends(tmp_path):
    assert isinstance(make_checkpointer(str(tmp_path)), Checkpointer)
    with pytest.raises(NotImplementedError, match="orbax"):
        make_checkpointer(str(tmp_path), "orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        make_checkpointer(str(tmp_path), "zarr")
    os.makedirs(tmp_path / "5")
    assert foreign_checkpoints(str(tmp_path), "npz") == [5]
    Checkpointer(str(tmp_path)).save(2, [torch.zeros(1)])
    assert foreign_checkpoints(str(tmp_path), "orbax") == [2]
    assert foreign_checkpoints(str(tmp_path / "missing"), "npz") == []


def test_dist_state_roundtrip_with_batchnorm_and_adam(tmp_path):
    """center, per-worker params (statistics included), Adam's counts and
    moments and the round clock come back exactly."""
    engine = SPMDEngine(mlp(bn=True), "categorical_crossentropy", "adam",
                        cpu_mesh(2), "adag", 2, 1e-2)
    data = dataset()
    from distkeras_tpu_torch.parallel import shape_epoch_data
    xb, yb, mb, _ = shape_epoch_data(data["features"],
                                     data["label_encoded"], 2, 2, 8)
    state = engine.init_state()
    state, _ = engine.run_epoch(state, xb, yb, mb, engine.worker_rngs(0))
    ck = Checkpointer(str(tmp_path))
    ck.save(state.round_idx, state)
    fresh = engine.init_state()
    back = engine.put_state(ck.restore(fresh))
    assert back.round_idx == state.round_idx == 4
    for got, want in zip(tree_leaves(back), tree_leaves(state)):
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want)
        else:
            assert got == want and type(got) is type(want)


# -- resume through the trainer ---------------------------------------------

def test_epoch_resume_bit_identical(tmp_path):
    data = dataset()
    full = adag().train(data)
    ck_dir = str(tmp_path / "ck")
    adag(checkpoint_dir=ck_dir, num_epoch=1).train(data)
    assert Checkpointer(ck_dir).latest_step() == 1
    assert Checkpointer(ck_dir).read_meta() == {"engine": "spmd",
                                                "unit": "epoch"}
    resumed = adag(checkpoint_dir=ck_dir)
    fitted = resumed.train(data, resume=True)
    assert same_weights(full, fitted)
    assert len(resumed.get_history()) == 2  # the second epoch's rounds
    assert Checkpointer(ck_dir).latest_step() == 2


def test_round_resume_bit_identical(tmp_path):
    """rounds per epoch = 128 / (4·2·8) = 2, so 4 global rounds: a run
    killed after round 3 (mid-epoch 2) and resumed trains one round and
    ends with the uninterrupted run's weights."""
    data = dataset()
    full = adag().train(data, shuffle=True)
    ck_dir = str(tmp_path / "ck_round")
    kw = dict(checkpoint_dir=ck_dir, checkpoint_unit="round",
              checkpoint_every=1)
    first = adag(**kw).train(data, shuffle=True)
    assert same_weights(full, first)  # the round unit runs the same rounds
    ck = Checkpointer(ck_dir)
    assert ck.latest_step() == 4
    assert ck.read_meta()["rounds_per_epoch"] == 2
    os.unlink(ck._path(4))
    resumed = adag(**kw)
    assert same_weights(full, resumed.train(data, shuffle=True, resume=True))
    assert len(resumed.get_history()) == 1


def test_resume_refusals(tmp_path):
    data = dataset()
    with pytest.raises(ValueError, match="needs checkpoint_dir"):
        adag().train(data, resume=True)
    # steps written by the other backend: resuming would silently retrain
    foreign = tmp_path / "foreign"
    os.makedirs(foreign / "3")
    with pytest.raises(ValueError, match="other backend"):
        adag(checkpoint_dir=str(foreign)).train(data, resume=True)
    # a step means what the saving run meant by it
    ck_dir = str(tmp_path / "ck_unit")
    adag(checkpoint_dir=ck_dir, num_epoch=1).train(data)
    with pytest.raises(ValueError, match="checkpoint_unit"):
        adag(checkpoint_dir=ck_dir, checkpoint_unit="round").train(
            data, resume=True)
    round_dir = str(tmp_path / "ck_rpe")
    adag(checkpoint_dir=round_dir, checkpoint_unit="round",
         num_epoch=1).train(data)
    with pytest.raises(ValueError, match="rounds_per_epoch"):
        adag(checkpoint_dir=round_dir, checkpoint_unit="round",
             batch_size=4).train(data, resume=True)


def test_resume_with_nothing_saved_starts_fresh(tmp_path):
    data = dataset()
    full = adag().train(data)
    fitted = adag(checkpoint_dir=str(tmp_path / "empty")).train(
        data, resume=True)
    assert same_weights(full, fitted)


# -- metrics ----------------------------------------------------------------

def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path)
    log.log(step=1, loss=torch.tensor(0.5), examples_per_sec=10)
    log.log(step=2, loss=np.float32(0.25))
    log.close()
    lines = [json.loads(l) for l in open(path)]
    assert [l["loss"] for l in lines] == [0.5, 0.25]
    assert log.scalar_series("step") == [1, 2]
    row = EpochMetrics(num_chips=2).epoch(0, 100, 2.0, 0.1)
    assert row["examples_per_sec"] == 50.0
    assert row["examples_per_sec_per_chip"] == 25.0


def test_trainer_emits_metrics(tmp_path):
    path = str(tmp_path / "m.jsonl")
    t = adag(metrics_path=path)
    t.train(dataset())
    assert len(t.metrics) == 2
    assert all(e["examples_per_sec_per_chip"] > 0 for e in t.metrics)
    assert all(e["examples"] == 128 for e in t.metrics)
    assert len(open(path).readlines()) == 2


def test_trace_and_annotate_on_the_cpu(tmp_path):
    with trace(str(tmp_path)):
        with annotate("round"):
            torch.ones(4).sum()
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))
    with trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")


@pytest.mark.parametrize("name", ["mnist_mlp", "mnist_convnet", "digits_mlp",
                                  "digits_convnet", "cifar10_convnet",
                                  "higgs_mlp"])
def test_flops_per_example_matches_jax(name):
    model = getattr(zoo, name)("bfloat16", device="cpu")
    before = [w.copy() for w in model.get_weights()]
    want = jax_flops(getattr(jax_zoo, name)("bfloat16"))
    assert flops_per_example(model) == want
    assert flops_per_example(model, backward=False) == want / 3
    # the shapes come from a copy on the meta device: the model keeps its
    # weights
    assert all(np.array_equal(a, b)
               for a, b in zip(before, model.get_weights()))


@pytest.mark.parametrize("extra", [dict(), dict(num_kv_heads=1),
                                   dict(causal=True, attention_window=3)])
def test_flops_of_attention_layers_match_jax(extra):
    def stack(m):
        return [m.Embedding(50, 16), m.MultiHeadAttention(4, 4, **extra),
                m.TransformerBlock(4, 4, 32, **extra), m.Dense(50)]
    jm = JaxSequential(stack(jl), input_shape=(12,), compute_dtype="float32")
    pm = Sequential(stack(pl), input_shape=(12,), compute_dtype="float32",
                    device="cpu")
    assert flops_per_example(pm) == jax_flops(jm)


def test_peak_flops():
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops("NVIDIA H100 SXM5 80GB") == 989e12
    # the PCIe and NVL parts peak lower: each has its own figure
    assert peak_flops("NVIDIA H100 PCIe") == 756.5e12
    assert peak_flops("NVIDIA H100 NVL") == 835.5e12
    assert peak_flops("cpu") is None
    assert peak_flops("TPU v5 lite") is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA H100 PCIe", 756.5e12), ("NVIDIA H100 NVL", 835.5e12),
    ("nvidia h100 pcie", 756.5e12), ("NVIDIA H100 NVL 94GB", 835.5e12)])
def test_peak_flops_by_name(name, peak):
    """Each name matches its own row, and only that row: the table's
    first-match order cannot hand one part another's peak."""
    from distkeras_tpu_torch.metrics import _PEAK_FLOPS
    assert peak_flops(name) == peak
    assert sum(key.lower() in name.lower() for key, _ in _PEAK_FLOPS) == 1
