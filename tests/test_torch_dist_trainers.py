"""The port's distributed trainers against the JAX package's, on the SPMD
engine.

Each trainer (ADAG, DOWNPOUR, DynSGD, AEASGD, EAMSGD, Averaging, Ensemble)
trains the same f32 MLP from one numpy weight set (a ``FittedModel`` on
both sides) on the same rows, with N workers on the JAX package's virtual
CPU mesh and N workers on the port's repeated-device CPU mesh; the
per-round loss histories and the returned models agree within rtol 1e-5,
atol 1e-6, as the engine's own tests hold them.  Beside that: the window-1
ADAG identity of tests/test_trainers.py:79 (one round equals the mean of
the workers' SGD steps), the LR schedule, accumulation and clipping
through the trainer, validation with early stopping, the port's own ADAG
recipe on the CPU, and every constructor refusal that the JAX trainers
raise on the SPMD engine, which the port raises with the same exception
type; what waits for later slices raises ``NotImplementedError`` naming
its ROADMAP item.
"""

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as port
from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu.core import layers as jl
from distkeras_tpu_torch import Dataset, FittedModel, Sequential
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.core.model import load_jax_weights
from distkeras_tpu_torch.parallel import get_mesh

torch.set_num_threads(1)

D, C = 10, 3
TOL = dict(rtol=1e-5, atol=1e-6)
COMMON = dict(batch_size=8, label_col="label_encoded", seed=3)


def stack(m):
    return [m.Dense(16, activation="relu"), m.Dense(C, activation="softmax")]


def numpy_weights(seed=0):
    rng = np.random.default_rng(seed)
    jm = JaxSequential(stack(jl), input_shape=(D,), compute_dtype="float32")
    shapes = [w.shape for w in jm.get_weights(jm.init(jax.random.PRNGKey(0)))]
    return [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def jax_model(weights):
    jm = JaxSequential(stack(jl), input_shape=(D,), compute_dtype="float32")
    return JaxFitted(jm, jm.set_weights(jm.init(jax.random.PRNGKey(0)),
                                        weights))


def port_model(weights):
    pm = Sequential(stack(pl), input_shape=(D,), compute_dtype="float32",
                    device="cpu")
    return FittedModel(load_jax_weights(pm, weights))


def dataset(rows=160, seed=1):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (C, D))
    labels = rng.integers(0, C, rows)
    x = (protos[labels] + 0.3 * rng.standard_normal((rows, D))).astype(
        np.float32)
    y = np.eye(C, dtype=np.float32)[labels]
    return ({"features": x, "label_encoded": y},
            Dataset({"features": x, "label_encoded": y}))


def cpu_mesh(n):
    return get_mesh(n, devices=["cpu"] * n)


def pair(name, n, weights=None, **kw):
    weights = numpy_weights() if weights is None else weights
    jt = getattr(jdk, name)(jax_model(weights), num_workers=n,
                            **COMMON, **kw)
    pt = getattr(port, name)(port_model(weights), mesh=cpu_mesh(n),
                             **COMMON, **kw)
    return jt, pt


def assert_models_match(jfit, pfit, tol=TOL):
    for a, b in zip(jfit.get_weights(), pfit.get_weights()):
        np.testing.assert_allclose(b, np.asarray(a), **tol)


TRAINER_CASES = {
    "ADAG": dict(communication_window=2, worker_optimizer="adam",
                 learning_rate=1e-2),
    "DOWNPOUR": dict(communication_window=2, worker_optimizer="sgd",
                     learning_rate=0.02),
    "DynSGD": dict(communication_window=3, worker_optimizer="sgd",
                   learning_rate=0.1),
    "AEASGD": dict(communication_window=2, rho=1.0, learning_rate=0.1),
    "EAMSGD": dict(communication_window=2, rho=1.0, learning_rate=0.05,
                   momentum=0.9),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(TRAINER_CASES))
def test_trainer_matches_jax(name, n):
    jdata, pdata = dataset()
    jt, pt = pair(name, n, num_epoch=2, **TRAINER_CASES[name])
    jfit = jt.train(jdk.Dataset(jdata), shuffle=True)
    pfit = pt.train(pdata, shuffle=True)
    assert len(pt.get_history()) == len(jt.get_history()) >= 4
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    assert_models_match(jfit, pfit)
    assert pt.num_workers == n and pt.get_training_time() > 0


def test_averaging_matches_jax():
    jdata, pdata = dataset()
    jt, pt = pair("AveragingTrainer", 4, num_epoch=2,
                  worker_optimizer="adam", learning_rate=1e-2)
    assert pt.communication_window == 1
    assert_models_match(jt.train(jdk.Dataset(jdata)), pt.train(pdata))
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)


def test_ensemble_matches_jax_and_serializes_every_member():
    jdata, pdata = dataset()
    weights = numpy_weights()
    jt = jdk.EnsembleTrainer(jax_model(weights), num_models=3, num_epoch=2,
                             worker_optimizer="adam", learning_rate=1e-2,
                             **COMMON)
    pt = port.EnsembleTrainer(port_model(weights), mesh=cpu_mesh(3),
                              num_epoch=2, worker_optimizer="adam",
                              learning_rate=1e-2, **COMMON)
    jmembers = jt.train(jdk.Dataset(jdata))
    pmembers = pt.train(pdata)
    assert len(pmembers) == pt.num_models == 3
    for jm_, pm_ in zip(jmembers, pmembers):
        assert_models_match(jm_, pm_)
    assert not np.array_equal(pmembers[0].get_weights()[0],
                              pmembers[1].get_weights()[0])
    blob = pt.serialize()
    assert len(blob["ensemble"]) == 3
    again = FittedModel.deserialize(blob["ensemble"][2], device="cpu")
    for a, b in zip(again.get_weights(), pmembers[2].get_weights()):
        np.testing.assert_array_equal(a, b)


def test_window_one_adag_is_the_mean_of_the_workers_sgd_steps():
    """One ADAG round with window 1 equals the all-reduce-mean SGD step
    (tests/test_trainers.py:79): each worker's one step on its batch,
    deltas averaged into the start."""
    _, pdata = dataset(rows=64)
    weights = numpy_weights(5)
    t = port.ADAG(port_model(weights), mesh=cpu_mesh(8), num_epoch=1,
                  communication_window=1, worker_optimizer="sgd",
                  learning_rate=0.1, **COMMON)
    fitted = t.train(pdata)
    x = torch.from_numpy(pdata["features"])
    y = torch.from_numpy(pdata["label_encoded"])
    from distkeras_tpu_torch.core.losses import get_loss
    from distkeras_tpu_torch.core.train import model_params
    deltas = []
    for w in range(8):  # any split into 8 batches of 8: SGD is linear
        model = port_model(weights).model
        loss = get_loss("categorical_crossentropy")(
            y[w * 8:(w + 1) * 8], model(x[w * 8:(w + 1) * 8], train=True))
        grads = torch.autograd.grad(loss, list(model_params(model).values()))
        deltas.append([-0.1 * g for g in grads])
    want = [w + np.mean([d[i].numpy() for d in deltas], axis=0)
            for i, w in enumerate(weights)]
    for a, b in zip(want, fitted.get_weights()):
        np.testing.assert_allclose(b, a, atol=2e-6)


def test_schedule_accumulation_and_clipping_match_jax():
    """lr_schedule's horizon (rounds × window × epochs / accumulation),
    gradient accumulation and global-norm clipping go to the worker
    optimizer as in the JAX engine."""
    jdata, pdata = dataset()
    kw = dict(num_epoch=2, communication_window=2, worker_optimizer="adam",
              learning_rate=1e-2, lr_schedule="warmup_cosine",
              gradient_accumulation=2, gradient_clip_norm=0.5)
    jt, pt = pair("ADAG", 2, **kw)
    jfit = jt.train(jdk.Dataset(jdata))
    pfit = pt.train(pdata)
    assert pt._schedule_steps == jt._schedule_steps
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    assert_models_match(jfit, pfit)


def test_validation_and_early_stopping_match_jax():
    jdata, pdata = dataset()
    jval, pval = dataset(rows=40, seed=9)
    kw = dict(num_epoch=6, communication_window=2, worker_optimizer="adam",
              learning_rate=0.3, early_stopping_patience=1)
    jt, pt = pair("ADAG", 2, **kw)
    jt.train(jdk.Dataset(jdata), validation_data=jdk.Dataset(jval))
    pt.train(pdata, validation_data=pval)
    np.testing.assert_allclose(pt.validation_history, jt.validation_history,
                               **TOL)
    assert pt.stopped_epoch == jt.stopped_epoch
    assert [e["kind"] for e in pt.metrics] == [e["kind"] for e in jt.metrics]


def test_port_adag_recipe_on_the_cpu():
    """The verify recipe's flow, on the CPU at a small size: MinMax ->
    OneHot -> ADAG (4 workers on one device) -> ModelPredictor ->
    LabelIndex -> Accuracy."""
    from distkeras_tpu_torch.data import load_mnist
    train, test = load_mnist(n_train=512, n_test=128)
    scale = port.MinMaxTransformer(0, 1, 0, 255)
    train, test = scale.transform(train), scale.transform(test)
    train = port.OneHotTransformer(10).transform(train)
    t = port.ADAG(port.mnist_mlp("float32", device="cpu"), mesh=cpu_mesh(4),
                  batch_size=32, num_epoch=2, communication_window=4,
                  label_col="label_encoded", worker_optimizer="adam",
                  learning_rate=1e-3)
    pred = port.ModelPredictor(t.train(train), device="cpu").predict(test)
    acc = port.AccuracyEvaluator().evaluate(
        port.LabelIndexTransformer().transform(pred))
    assert acc > 0.8
    assert t.metrics[-1]["examples_per_sec_per_chip"] > 0


# -- refusals ---------------------------------------------------------------

# constructor keywords the JAX trainers refuse on the SPMD engine
SPMD_REFUSALS = [
    ("ADAG", dict(parallelism_factor=0)),
    ("ADAG", dict(parallelism_factor=2)),
    ("ADAG", dict(comm_overlap=True)),
    ("DOWNPOUR", dict(comm_overlap=False)),
    ("ADAG", dict(ps_shards=0)),
    ("ADAG", dict(ps_shards=2)),
    ("ADAG", dict(recovery=True)),
    ("DynSGD", dict(elastic=True)),
    ("ADAG", dict(lease_windows=0)),
    ("ADAG", dict(lease_timeout=0.0)),
    ("ADAG", dict(ps_core="nope")),
    ("ADAG", dict(ps_core="threaded")),
    ("ADAG", dict(coalesce=False)),
    ("ADAG", dict(apply_kernel="numpy")),
    ("ADAG", dict(apply_kernel="bogus")),
    ("ADAG", dict(stream=True)),
    ("ADAG", dict(horizon_windows=4)),
    ("ADAG", dict(max_horizons=2)),
    ("ADAG", dict(row_sparse=True)),
    ("AEASGD", dict(row_sparse=True)),
    ("ADAG", dict(ps_bind_host="")),
    ("ADAG", dict(ps_bind_host="0.0.0.0")),
    ("ADAG", dict(ps_advertise_host="10.0.0.1")),
    ("ADAG", dict(ps_placement="cloud")),
    ("ADAG", dict(ps_placement="process")),
    ("ADAG", dict(partition_windows=-1)),
    ("ADAG", dict(partition_windows=2)),
    ("ADAG", dict(freeze_deadline=0.0)),
    ("ADAG", dict(freeze_deadline=5.0)),
    ("EAMSGD", dict(scratch_dir="/nonexistent")),
    ("ADAG", dict(checkpoint_unit="step")),
    ("ADAG", dict(checkpoint_backend="zarr")),
    ("ADAG", dict(wire_dtype="topk", wire_topk=0.0)),
    ("ADAG", dict(wire_dtype="topk", wire_topk_dtype="fp8")),
    ("ADAG", dict(wire_topk_dtype="int8")),
    ("ADAG", dict(gradient_accumulation=0)),
    ("ADAG", dict(gradient_clip_norm=-1.0)),
    ("ADAG", dict(early_stopping_patience=0)),
    ("AveragingTrainer", dict(early_stopping_patience=2)),
    ("EnsembleTrainer", dict(early_stopping_patience=2)),
]


@pytest.mark.parametrize("name,kw", SPMD_REFUSALS,
                         ids=[f"{n}-{'-'.join(k)}" for n, k in SPMD_REFUSALS])
def test_constructor_refusals_match_jax(name, kw):
    weights = numpy_weights()
    with pytest.raises(ValueError):
        getattr(jdk, name)(jax_model(weights), num_workers=2, **kw)
    with pytest.raises(ValueError):
        getattr(port, name)(port_model(weights), mesh=cpu_mesh(2), **kw)


def test_train_refusals_match_jax(tmp_path):
    jdata, pdata = dataset(rows=32)
    weights = numpy_weights()
    for kw, exc in ((dict(fault_tolerance=True), ValueError),
                    (dict(fault_injection={1: 2}), ValueError)):
        with pytest.raises(exc):
            jdk.ADAG(jax_model(weights), num_workers=2, **kw).train(
                jdk.Dataset(jdata))
        with pytest.raises(exc):
            port.ADAG(port_model(weights), mesh=cpu_mesh(2), **kw).train(
                pdata)
    with pytest.raises(ValueError, match="validation_data"):
        port.ADAG(port_model(weights), mesh=cpu_mesh(2),
                  early_stopping_patience=1).train(pdata)


@pytest.mark.parametrize("execution", ["host_ps", "process_ps"])
def test_parameter_server_engines_wait_for_item_6(execution):
    # host_ps arrived (A6a): its training is held to the JAX package's in
    # tests/test_torch_host_ps_parity.py; a mesh given there names the
    # device and the worker count.  process_ps still waits for item 6
    if execution == "process_ps":
        with pytest.raises(NotImplementedError, match="queue A item 6"):
            port.ADAG(port_model(numpy_weights()), mesh=cpu_mesh(2),
                      execution=execution)
        return
    _, pdata = dataset(rows=64)
    t = port.ADAG(port_model(numpy_weights()), mesh=cpu_mesh(2),
                  execution=execution, batch_size=8,
                  label_col="label_encoded", communication_window=2)
    assert t.num_workers == 2 and t.device == torch.device("cpu")
    t.train(pdata)
    assert len(t.get_history()) == 4  # 32 rows a worker, 2 windows of 16
    assert t._ps_server.ps.num_updates == 4


WIRE_CODINGS = [dict(wire_dtype="bfloat16"), dict(wire_dtype="int8"),
                dict(wire_dtype="topk"),
                dict(wire_dtype="topk", wire_topk=0.1,
                     wire_topk_dtype="int8"),
                dict(wire_topk=0.5)]


@pytest.mark.parametrize("kw", WIRE_CODINGS,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              for kw in WIRE_CODINGS])
def test_wire_codings_wait_for_item_6(kw):
    # the JAX class takes them on its SPMD engine and ignores them there;
    # the port refuses them rather than run an uncoded exchange silently
    jdk.ADAG(jax_model(numpy_weights()), num_workers=2, **kw)
    with pytest.raises(NotImplementedError, match="no wire"):
        port.ADAG(port_model(numpy_weights()), mesh=cpu_mesh(2), **kw)
    # host_ps takes every coding, dense and sparse top-k (A6b), as the
    # JAX class does there
    jdk.ADAG(jax_model(numpy_weights()), num_workers=2,
             execution="host_ps", **kw)
    t = port.ADAG(port_model(numpy_weights()), num_workers=2,
                  device="cpu", execution="host_ps", **kw)
    for knob, value in kw.items():
        assert getattr(t, knob) == value


# the parameter-server knobs that the port refuses on the SPMD engine
# (SPMD_REFUSALS) and takes on host_ps, as the JAX class takes them there
HOST_PS_KNOBS = [
    ("ADAG", dict(parallelism_factor=2)),
    ("ADAG", dict(comm_overlap=True)),
    ("DOWNPOUR", dict(comm_overlap=False)),
    ("ADAG", dict(ps_core="threaded")),
    ("ADAG", dict(coalesce=False)),
    ("ADAG", dict(apply_kernel="numpy")),
    ("ADAG", dict(apply_kernel="auto")),
    ("ADAG", dict(ps_bind_host="127.0.0.1")),
    ("ADAG", dict(ps_advertise_host="127.0.0.1")),
    ("ADAG", dict(lease_windows=3, lease_timeout=2.0)),
    ("ADAG", dict(ps_shards=2)),
    ("ADAG", dict(row_sparse=True)),
    ("DynSGD", dict(row_sparse=[0], ps_shards=3)),
]
# ... the knobs of the host-PS engines still to come (item 6) ...
HOST_PS_WAITS = [
    ("ADAG", dict(recovery=True)),
    ("DynSGD", dict(elastic=True)),
    ("ADAG", dict(stream=True)),
    ("ADAG", dict(partition_windows=2)),
]
# ... and the values the JAX class refuses on host_ps too
HOST_PS_REFUSALS = [
    ("ADAG", dict(parallelism_factor=0)),
    ("ADAG", dict(ps_shards=0)),
    ("ADAG", dict(ps_core="nope")),
    ("ADAG", dict(apply_kernel="bogus")),
    ("ADAG", dict(horizon_windows=4)),
    ("AEASGD", dict(row_sparse=True)),
    ("ADAG", dict(row_sparse=True, wire_dtype="int8")),
    ("ADAG", dict(ps_bind_host="")),
    ("ADAG", dict(ps_placement="process")),
    ("ADAG", dict(partition_windows=2, ps_shards=2)),
    ("ADAG", dict(checkpoint_unit="step")),
]


def _ids(cases):
    return [f"{n}-{'-'.join(k)}" for n, k in cases]


@pytest.mark.parametrize("name,kw", HOST_PS_KNOBS, ids=_ids(HOST_PS_KNOBS))
def test_host_ps_takes_the_ps_knobs(name, kw):
    weights = numpy_weights()
    getattr(jdk, name)(jax_model(weights), num_workers=2,
                       execution="host_ps", **kw)
    t = getattr(port, name)(port_model(weights), num_workers=2,
                            device="cpu", execution="host_ps", **kw)
    for knob, value in kw.items():
        assert getattr(t, knob) == value


@pytest.mark.parametrize("name,kw", HOST_PS_WAITS, ids=_ids(HOST_PS_WAITS))
def test_host_ps_knobs_waiting_for_item_6(name, kw):
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        getattr(port, name)(port_model(numpy_weights()), num_workers=2,
                            device="cpu", execution="host_ps", **kw)


@pytest.mark.parametrize("name,kw", HOST_PS_REFUSALS,
                         ids=_ids(HOST_PS_REFUSALS))
def test_host_ps_refusals_match_jax(name, kw):
    weights = numpy_weights()
    with pytest.raises(ValueError):
        getattr(jdk, name)(jax_model(weights), num_workers=2,
                           execution="host_ps", **kw)
    with pytest.raises(ValueError):
        getattr(port, name)(port_model(weights), num_workers=2,
                            device="cpu", execution="host_ps", **kw)


# the sharding, top-k and row-sparse checks (the knobs A6b lifted): the
# port raises the JAX class's ValueError with the JAX class's message
A6B_REFUSALS = [
    ("ADAG", dict(ps_shards=0)),
    ("AEASGD", dict(row_sparse=True)),
    ("EAMSGD", dict(row_sparse=[0])),
    ("ADAG", dict(row_sparse=True, wire_dtype="int8")),
    ("DOWNPOUR", dict(row_sparse=True, wire_dtype="bfloat16")),
    ("DynSGD", dict(row_sparse=True, wire_dtype="topk")),
    ("ADAG", dict(wire_dtype="topk", wire_topk=0.0)),
    ("ADAG", dict(wire_dtype="topk", wire_topk=1.5)),
    ("ADAG", dict(wire_dtype="topk", wire_topk_dtype="fp8")),
    ("ADAG", dict(wire_dtype="int8", wire_topk_dtype="int8")),
    ("ADAG", dict(partition_windows=2, ps_shards=2)),
]


@pytest.mark.parametrize("name,kw", A6B_REFUSALS, ids=_ids(A6B_REFUSALS))
def test_host_ps_sparse_refusals_carry_the_jax_messages(name, kw):
    weights = numpy_weights()
    with pytest.raises(ValueError) as jax_err:
        getattr(jdk, name)(jax_model(weights), num_workers=2,
                           execution="host_ps", **kw)
    with pytest.raises(ValueError) as port_err:
        getattr(port, name)(port_model(weights), num_workers=2,
                            device="cpu", execution="host_ps", **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_host_ps_workers_are_threads_on_one_device():
    model = port_model(numpy_weights())
    t = port.ADAG(model, num_workers=3, parallelism_factor=2,
                  execution="host_ps", device="cpu")
    assert t.num_workers == 3 and t.mesh is None
    assert t.device == torch.device("cpu")
    assert port.ADAG(model, execution="host_ps", device="cpu"
                     ).num_workers == 1
    with pytest.raises(ValueError, match="num_workers"):
        port.ADAG(model, num_workers=0, execution="host_ps", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.ADAG(model, num_workers=2, execution="host_ps")


def test_what_waits_for_later_slices_raises():
    model = port_model(numpy_weights())
    # packing arrived (A5c): segment_col builds a packed engine; its
    # training is held to the JAX package's in tests/test_torch_packing.py
    t = port.ADAG(model, mesh=cpu_mesh(2), segment_col="seg",
                  loss="sparse_categorical_crossentropy_masked_from_logits")
    assert t.segment_col == "seg" and t.service((D,)).packed
    with pytest.raises(ValueError, match="masked"):
        port.ADAG(model, mesh=cpu_mesh(2), segment_col="seg")
    with pytest.raises(NotImplementedError, match="orbax"):
        port.ADAG(model, mesh=cpu_mesh(2), checkpoint_backend="orbax")
    with pytest.raises(ValueError, match="unknown execution"):
        port.ADAG(model, mesh=cpu_mesh(2), execution="threads")


def test_meshes_and_devices():
    model = port_model(numpy_weights())
    t = port.ADAG(model, device="cpu")
    assert t.num_workers == 1 and t.device == torch.device("cpu")
    assert port.ADAG.DEFAULT_WINDOW == 12 and t.communication_window == 12
    assert (port.DOWNPOUR.DEFAULT_WINDOW, port.DynSGD.DEFAULT_WINDOW,
            port.AEASGD.DEFAULT_WINDOW) == (5, 5, 32)
    # the repeated-device mesh is never a default
    with pytest.raises(ValueError, match="exceeds"):
        port.ADAG(model, num_workers=4, device="cpu")
    with pytest.raises(ValueError, match="worker mesh is on"):
        port.ADAG(model, mesh=cpu_mesh(2), device="meta")
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        port.ADAG(model, mesh=get_mesh(2, devices=["cpu", "meta"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.ADAG(model)


def test_elastic_trainers_alpha_and_worker_optimizer():
    model = port_model(numpy_weights())
    a = port.AEASGD(model, mesh=cpu_mesh(2), rho=2.0, learning_rate=0.05)
    assert a._elastic_alpha() == pytest.approx(0.1)
    e = port.EAMSGD(model, mesh=cpu_mesh(2), momentum=0.8,
                    worker_optimizer="adam")
    opt = e.worker_optimizer
    assert opt.name == "sgd" and opt.hyper["nesterov"] is True
    assert opt.hyper["momentum"] == 0.8 and e.momentum == 0.8
    assert issubclass(port.ADAG, port.AsynchronousDistributedTrainer)
    assert issubclass(port.SynchronousDistributedTrainer,
                      port.DistributedTrainer)
