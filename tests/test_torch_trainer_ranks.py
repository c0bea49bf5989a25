"""The port's distributed trainers across ranks (one worker a rank, 2
ranks over gloo on the CPU) against the JAX trainers on ``get_mesh(2)``
and against the port's one-process 2-worker trainers.

One job of 2 ranks starts once (tests/torch_ranks.py) and trains, from
tests/test_torch_dist_trainers.py's numpy weights and rows: ADAG,
DOWNPOUR, DynSGD, AEASGD, EAMSGD, Averaging and Ensemble; ADAG writing
epoch- and round-unit checkpoints, and resuming from checkpoints this
process wrote; ADAG with validation and early stopping.  Every rank
returns the same histories and models; they agree with JAX within
``TOL`` and with the one-process trainers to the bit, and a checkpoint
written by either side continues on the other to the bit of the
uninterrupted one-process run.
"""

import json
import os

import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as port
from distkeras_tpu_torch import Dataset

import torch_ranks as tr
from test_torch_dist_trainers import (COMMON, TOL, TRAINER_CASES, cpu_mesh,
                                      dataset, jax_model, numpy_weights,
                                      port_model)

torch.set_num_threads(1)

LOCAL_CASES = {"AveragingTrainer": dict(worker_optimizer="adam",
                                        learning_rate=1e-2),
               "EnsembleTrainer": dict(worker_optimizer="adam",
                                       learning_rate=1e-2)}
ADAG = dict(COMMON, **TRAINER_CASES["ADAG"])
UNITS = ("epoch", "round")


def kwargs(name):
    base = TRAINER_CASES.get(name) or LOCAL_CASES[name]
    return dict(COMMON, num_epoch=2, **base)


def one_process(data, name, kw, resume=False, validation=None):
    """The same run in this process on the repeated-device 2-worker mesh,
    in torch_ranks's result layout."""
    return tr.trainer_run(name, np.load(data), cpu_mesh(2), kw,
                          resume=resume, validation=validation)


def ckpt_kw(tmp, who, unit, epochs):
    return dict(ADAG, num_epoch=epochs, checkpoint_unit=unit,
                checkpoint_dir=str(tmp / f"{who}_{unit}"))


def drop_latest(directory):
    """Remove the newest step, so a resume starts mid-epoch (round unit)."""
    steps = sorted(int(f[5:-4]) for f in os.listdir(directory)
                   if f.startswith("ckpt_"))
    os.unlink(os.path.join(directory, f"ckpt_{steps[-1]}.npz"))
    return steps[-2]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_ranks")
    weights = numpy_weights()
    data, _ = dataset()
    val, _ = dataset(rows=48, seed=2)
    data_path = str(tmp / "data.npz")
    np.savez(data_path, x=data["features"], y=data["label_encoded"],
             xv=val["features"], yv=val["label_encoded"],
             features=data["features"].shape[1],
             classes=data["label_encoded"].shape[1], nw=len(weights),
             **{f"w{i}": w for i, w in enumerate(weights)})
    # the steps the ranks resume from, written here first
    for unit in UNITS:
        one_process(data_path, "ADAG", ckpt_kw(tmp, "proc", unit, 1))
        if unit == "round":
            drop_latest(tmp / "proc_round")
    trainers = {name: kwargs(name) for name in
                [*TRAINER_CASES, *LOCAL_CASES]}
    trainers["ADAG"]["metrics_path"] = str(tmp / "metrics.jsonl")
    checkpoints = {}
    for unit in UNITS:
        checkpoints[f"write_{unit}"] = (ckpt_kw(tmp, "ranks", unit, 1),
                                        False)
        checkpoints[f"resume_{unit}"] = (ckpt_kw(tmp, "proc", unit, 2),
                                         True)
    early = dict(ADAG, num_epoch=4, early_stopping_patience=1,
                 early_stopping_min_delta=10.0)
    job = tr.Ranks(2, {"cases": [{"name": "t", "kind": "trainers",
                                  "data": data_path,
                                  "trainers": trainers,
                                  "checkpoints": checkpoints,
                                  "early": early}]},
                   tmp / "job", timeout=240)
    return tmp, job, data_path


def flat_weights(ws):
    """The arrays of a model's weights, or of every ensemble member's."""
    return [w for m in ws for w in m] if isinstance(ws[0], list) else ws


def assert_same(got, want):
    np.testing.assert_array_equal(got["history"], want["history"])
    a, b = flat_weights(got["weights"]), flat_weights(want["weights"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", [*sorted(TRAINER_CASES), *LOCAL_CASES])
def test_trainers_on_two_ranks_match_jax_and_one_process(ranks, name):
    _, job, data = ranks
    kw = kwargs(name)
    jdata, _ = dataset()
    jkw = {k: v for k, v in kw.items() if k != "metrics_path"}
    jt = getattr(jdk, name)(jax_model(numpy_weights()), num_workers=2,
                            **jkw)
    jfit = jt.train(jdk.Dataset(jdata), shuffle=True)
    want = one_process(data, name, kw)
    results = [r["t"][name] for r in job.results()]
    for got in results:
        assert_same(got, want)
        assert len(got["history"]) == len(jt.get_history()) >= 4
        np.testing.assert_allclose(got["history"], jt.get_history(), **TOL)
        jw = ([m.get_weights() for m in jfit] if isinstance(jfit, list)
              else jfit.get_weights())
        if name == "EnsembleTrainer":  # every member on every rank
            assert len(got["weights"]) == len(jw) == 2
            pairs = [(a, b) for ga, ja in zip(got["weights"], jw)
                     for a, b in zip(ga, ja)]
        else:
            pairs = list(zip(got["weights"], jw))
        for a, b in pairs:
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_metrics_count_distinct_cards_and_rank_zero_writes(ranks):
    tmp, job, _ = ranks
    for r in job.results():
        events = r["t"]["ADAG"]["metrics"]
        assert len(events) == 2
        for e in events:  # two workers on one device: one card
            assert e["examples_per_sec_per_chip"] == e["examples_per_sec"]
    lines = [json.loads(line) for line in
             (tmp / "metrics.jsonl").read_text().splitlines()]
    assert sum(e.get("kind") == "epoch" for e in lines) == 2


@pytest.mark.parametrize("unit", UNITS)
def test_checkpoints_interchange_between_ranks_and_one_process(ranks, unit):
    """A step written by the ranks continues in one process, and a step
    written by one process continues on the ranks, each to the bit of the
    uninterrupted one-process run."""
    tmp, job, data = ranks
    whole = one_process(data, "ADAG", dict(ADAG, num_epoch=2))
    results = [r["t"] for r in job.results()]
    rounds = len(whole["history"]) // 2
    skip = rounds - 1 if unit == "round" else rounds
    # the ranks' resume from this process's step
    for res in results:
        got = res[f"resume_{unit}"]
        assert_same(got, {"history": whole["history"][skip:],
                          "weights": whole["weights"]})
        np.testing.assert_array_equal(
            res[f"write_{unit}"]["history"], whole["history"][:rounds])
    # this process's resume from the ranks' step, in the one-process
    # layout
    directory = tmp / f"ranks_{unit}"
    if unit == "round":
        assert drop_latest(directory) == rounds - 1
    got = one_process(data, "ADAG", ckpt_kw(tmp, "ranks", unit, 2),
                      resume=True)
    assert_same(got, {"history": whole["history"][skip:],
                      "weights": whole["weights"]})


def test_early_stopping_decides_alike_on_every_rank(ranks):
    _, job, data = ranks
    blob = np.load(data)
    val = Dataset({"features": blob["xv"], "label_encoded": blob["yv"]})
    want = one_process(data, "ADAG", dict(ADAG, num_epoch=4,
                                    early_stopping_patience=1,
                                    early_stopping_min_delta=10.0),
                       validation=val)
    assert want["stopped_epoch"] == 1 and len(want["validation"]) == 2
    for r in job.results():
        got = r["t"]["early"]
        assert got["stopped_epoch"] == want["stopped_epoch"]
        assert got["validation"] == want["validation"]
        assert_same(got, want)


def test_a_rank_mesh_needs_its_group():
    """The rank mesh's shape without the group: distinct devices refuse,
    naming how to start the ranks; the repeated-device mesh trains in one
    process (port.ADAG takes it as before)."""
    model = port_model(numpy_weights())
    with pytest.raises(RuntimeError, match="start 2 processes"):
        port.ADAG(model, mesh=port.parallel.get_mesh(
            2, devices=["cpu", "meta"]))
    assert port.ADAG(model, mesh=cpu_mesh(2)).num_workers == 2
