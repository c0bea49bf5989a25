"""The port's ConvNet/MLP zoo against the JAX package's.

For each of the six zoo models one weight set is drawn with numpy, set into
the JAX model and saved as the framework's npz blob, and the port loads the
blob (``FittedModel.load``).  At f32 the two then agree, on one batch of
eight rows with one-hot labels, in the model outputs (softmax
probabilities), the categorical cross-entropy, the gradient of every
parameter, and the parameters after one Adam step of ``make_train_step``
(Adam at epsilon 1e-4, as in tests/test_torch_train.py: where a
gradient is exactly zero on one side and f32 rounding noise on the other,
Keras's 1e-7 would turn the noise into steps of ~lr/30), all within
rtol/atol 1e-5 (the stepped parameters within 1e-3 of the learning rate:
a gradient that f32 rounding moves by 1e-4 of itself, at a size near
Adam's epsilon, moves its step by ~1e-4 of the learning rate).  The CIFAR-10 ConvNet's
Dropout draws its mask from the JAX key chain here and hands the same mask
to the port (JAX threefry and torch generators never agree).

Beside that: a 16-step ``SingleTrainer`` run of the MNIST ConvNet at f32
against the JAX ``SingleTrainer`` (loss traces within 1e-4, relative),
BatchNorm's running statistics through the train steps, the predictor over
(N, 784) rows, and the blob round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import SingleTrainer as JaxTrainer
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core import optimizers as jax_opt
from distkeras_tpu.core import train as jax_train
from distkeras_tpu.core.losses import get_loss as jax_loss
from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu.data.dataset import Dataset as JaxDataset
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.predictors import ModelPredictor as JaxPredictor
from distkeras_tpu_torch import (Dataset, FittedModel, ModelPredictor,
                                 SingleTrainer)
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.core import optimizers
from distkeras_tpu_torch.core.losses import get_loss
from distkeras_tpu_torch.core.model import Sequential, jax_leaves
from distkeras_tpu_torch.core.train import (TrainState, make_loss_fn,
                                            make_masked_step,
                                            make_train_step, model_params)
from distkeras_tpu_torch.models import zoo

torch.set_num_threads(1)

MODELS = ("mnist_mlp", "mnist_convnet", "digits_mlp", "digits_convnet",
          "cifar10_convnet", "higgs_mlp")
TOL = dict(rtol=1e-5, atol=1e-5)
LOSS = "categorical_crossentropy"
LR, ADAM_EPS = 1e-3, 1e-4
BATCH = 8


def numpy_weights(weights, rng):
    """Kernels N(0, 1/fan_in), biases small: trained-looking scales."""
    out = []
    for w in weights:
        if w.ndim == 1:
            out.append(0.05 * rng.standard_normal(w.shape))
        else:
            fan_in = int(np.prod(w.shape[:-1]))
            out.append(rng.standard_normal(w.shape) / np.sqrt(fan_in))
    return [a.astype(np.float32) for a in out]


def batch_for(model, rng, rows=BATCH):
    """Inputs in [0, 1] (the MinMax-scaled pixels) and one-hot labels."""
    x = rng.uniform(0.0, 1.0, (rows,) + tuple(model.input_shape))
    classes = model.output_shape[-1]
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, rows)]
    return x.astype(np.float32), y


def dropout_mask_of(jm, key, x, params):
    """The JAX Dropout layer's mask for ``apply(..., rng=key)``: the key
    chain of ``Sequential.apply`` (one split per layer) up to that layer,
    and its input's shape."""
    for i, layer in enumerate(jm.layers):
        key, sub = jax.random.split(key)
        if isinstance(layer, jl.Dropout):
            return np.asarray(jax.random.bernoulli(sub, 1.0 - layer.rate,
                                                   x.shape))
        x = layer.apply(params[i], x, compute_dtype=jnp.float32, train=True)
    return None


class FixedDropout:
    """``torch.rand`` for the port's Dropout: uniforms that fall below the
    keep probability exactly where the JAX mask keeps."""

    def __init__(self, monkeypatch, mask):
        if mask is None:
            return
        u = torch.from_numpy(np.where(mask, 0.25, 0.75).astype(np.float32))
        real = torch.rand

        def rand(shape, *args, **kwargs):
            if tuple(shape) == tuple(u.shape):
                return u.clone()
            return real(shape, *args, **kwargs)
        monkeypatch.setattr(torch, "rand", rand)


@pytest.fixture(scope="module", params=MODELS)
def pair(request, tmp_path_factory):
    """The JAX side's results for one model, and the port model loaded
    from the same blob."""
    name = request.param
    jm = getattr(jax_zoo, name)("float32")
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(MODELS.index(name))
    params = jm.set_weights(params, numpy_weights(jm.get_weights(params),
                                                  rng))
    path = str(tmp_path_factory.mktemp(name) / "blob.npz")
    JaxFitted(jm, params).save(path)
    x, y = batch_for(jm, rng)
    key = jax.random.PRNGKey(7)
    mask = dropout_mask_of(jm, key, x, params)
    compute = jax_train.make_loss_fn(jm, LOSS)
    (loss, _), grads = jax.value_and_grad(compute, has_aux=True)(
        params, x, y, key)
    tx, opt_state = jax_opt.build(jax_opt.Adam(LR, epsilon=ADAM_EPS),
                                  params)
    state = jax_train.TrainState(params, opt_state, jnp.zeros((), jnp.int32))
    new_state, step_loss = jax_train.make_train_step(jm, LOSS, tx)(
        state, (x, y), key)
    return dict(name=name, jm=jm, path=path, x=x, y=y, mask=mask,
                outputs=np.asarray(jm.apply(params, x)),
                loss=float(loss), step_loss=float(step_loss),
                grads=[np.asarray(g)
                       for g in jax.tree_util.tree_leaves(grads)],
                weights=jm.get_weights(params),
                stepped=jm.get_weights(new_state.params))


def port_model(pair):
    model = FittedModel.load(pair["path"], device="cpu").model
    assert model.to_json() == pair["jm"].to_json()
    return model


def test_outputs_match_jax(pair):
    model = port_model(pair)
    with torch.no_grad():
        got = model(torch.from_numpy(pair["x"])).numpy()
    np.testing.assert_allclose(got, pair["outputs"], **TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_loss_and_gradients_match_jax(pair, monkeypatch):
    model = port_model(pair)
    FixedDropout(monkeypatch, pair["mask"])
    value, stats = make_loss_fn(model, LOSS)(
        torch.from_numpy(pair["x"]), torch.from_numpy(pair["y"]),
        torch.Generator())
    assert stats == {}
    np.testing.assert_allclose(value.item(), pair["loss"], **TOL)
    params = list(model_params(model).values())
    grads = torch.autograd.grad(value, params)
    assert len(grads) == len(pair["grads"])
    for got, want in zip(grads, pair["grads"]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_one_adam_step_matches_jax(pair, monkeypatch):
    model = port_model(pair)
    FixedDropout(monkeypatch, pair["mask"])
    params = model_params(model)
    tx, opt_state = optimizers.build(optimizers.Adam(LR, epsilon=ADAM_EPS),
                                     params)
    state, loss = make_train_step(model, LOSS, tx)(
        TrainState(params, opt_state, 0),
        (torch.from_numpy(pair["x"]), torch.from_numpy(pair["y"])),
        torch.Generator())
    assert state.step == 1
    np.testing.assert_allclose(float(loss), pair["step_loss"], **TOL)
    for got, want, before in zip(model.get_weights(), pair["stepped"],
                                 pair["weights"]):
        assert not np.array_equal(want, before) or np.array_equal(got,
                                                                  before)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * LR)


def test_weights_and_spec_cross_in_both_directions(pair, tmp_path):
    """The port's blob of the same model loads back in the JAX package
    and predicts what the port predicts."""
    model = port_model(pair)
    for got, want in zip(model.get_weights(), pair["weights"]):
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "port.npz")
    FittedModel(model).save(path)
    back = JaxFitted.load(path)
    np.testing.assert_allclose(back.predict(pair["x"]),
                               FittedModel(model).predict(pair["x"]), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_builders_default_to_the_card(name):
    """``device=None`` means CUDA: without a card a builder raises; with
    one, it builds there."""
    builder = getattr(zoo, name)
    if torch.cuda.is_available():
        assert builder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder()
    assert builder("float32", device="cpu").compute_dtype == "float32"


def mnist_rows(rows, seed):
    from distkeras_tpu_torch.data import (MinMaxTransformer,
                                          OneHotTransformer, load_mnist)
    train, _ = load_mnist(n_train=rows, n_test=8, seed=seed)
    train = MinMaxTransformer(0, 1, 0, 255).transform(train)
    return OneHotTransformer(10).transform(train)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_single_trainer_16_steps_match_jax(optimizer):
    """SingleTrainer over mnist_convnet at f32: 256 synthetic MNIST rows,
    batch 16, one epoch, from the same numpy weights on both sides: the
    16 losses agree within 1e-4 (relative)."""
    data = mnist_rows(256, seed=3)
    jm = jax_zoo.mnist_convnet("float32")
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm.get_weights(params), np.random.default_rng(9))
    params = jm.set_weights(params, weights)
    port = zoo.mnist_convnet("float32", device="cpu").set_weights(weights)
    kw = dict(batch_size=16, num_epoch=1, label_col="label_encoded",
              loss=LOSS, worker_optimizer=optimizer,
              learning_rate=1e-3 if optimizer == "adam" else 0.01)
    jt = JaxTrainer(JaxFitted(jm, params), **kw)
    jt.train(JaxDataset({c: data[c] for c in data.columns}))
    pt = SingleTrainer(FittedModel(port), device="cpu", **kw)
    pt.train(data)
    want, got = np.asarray(jt.get_history()), np.asarray(pt.get_history())
    assert len(got) == len(want) == 16
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def BN_LAYERS(mod):
    """A conv stack with batch norm (the conv bias left out, as before any
    batch norm: its gradient is exactly zero there, so only rounding noise
    would drive it)."""
    return [mod.Conv2D(4, 3, use_bias=False), mod.BatchNormalization(0.9),
            mod.AveragePooling2D(2, padding="same"),
            mod.GlobalAveragePooling2D(),
            mod.Dense(3, activation="softmax")]


def bn_pair(seed=0):
    jm = JaxSequential(BN_LAYERS(jl), input_shape=(7, 7, 2),
                       compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    pm = Sequential(BN_LAYERS(pl), input_shape=(7, 7, 2),
                    compute_dtype="float32", device="cpu")
    rng = np.random.default_rng(seed)
    weights = numpy_weights(jm.get_weights(params), rng)
    weights = [1.0 + np.abs(w) if path.endswith(("scale", "var")) else w
               for (path, _), w in zip(jax_leaves(pm), weights)]
    params = jm.set_weights(params, weights)
    pm.set_weights(weights)
    x = rng.standard_normal((6, 7, 7, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    return jm, params, pm, x, y


def test_batchnorm_leaves_in_jax_order():
    jm, params, pm, _, _ = bn_pair()
    assert [p for p, _ in jax_leaves(pm)] == [
        "0/kernel", "1/offset", "1/scale", "1/stats/mean", "1/stats/var",
        "4/bias", "4/kernel"]
    assert [w.shape for w in pm.get_weights()] == [
        w.shape for w in jm.get_weights(params)]
    assert pm.has_stats() and jm.has_stats()


def test_batchnorm_stats_through_the_train_step_match_jax():
    """Three Adam steps of ``make_train_step``: the merged running
    statistics and every trained parameter equal the JAX step's; the
    optimizer never moves the statistics on its own."""
    jm, params, pm, x, y = bn_pair(1)
    tx, opt_state = jax_opt.build(jax_opt.Adam(0.01, epsilon=ADAM_EPS),
                                  params)
    jstate = jax_train.TrainState(params, opt_state, jnp.zeros((), jnp.int32))
    jstep = jax_train.make_train_step(jm, LOSS, tx)
    pparams = model_params(pm)
    ptx, popt = optimizers.build(
        optimizers.Adam(0.01, epsilon=ADAM_EPS), pparams)
    pstate = TrainState(pparams, popt, 0)
    pstep = make_train_step(pm, LOSS, ptx)
    stats0 = pm.get_weights()[3:5]
    for i in range(3):
        xb, yb = x[2 * i:2 * i + 2], y[2 * i:2 * i + 2]
        jstate, jloss = jstep(jstate, (xb, yb), jax.random.PRNGKey(i))
        pstate, ploss = pstep(pstate, (torch.from_numpy(xb),
                                       torch.from_numpy(yb)))
        np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    for got, want in zip(pm.get_weights(), jm.get_weights(jstate.params)):
        np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(pm.get_weights()[3], stats0[0])


@pytest.mark.parametrize("mask", ["padded", "all_padding"])
def test_batchnorm_stats_through_the_masked_step(mask):
    """The masked step merges the statistics after the update as the JAX
    step does, and a fully padded batch leaves them as they were."""
    jm, params, pm, x, y = bn_pair(2)
    w = (np.array([1, 1, 1, 1, 0, 0], np.float32) if mask == "padded"
         else np.zeros(6, np.float32))
    tx, opt_state = jax_opt.build(jax_opt.Adam(0.01, epsilon=ADAM_EPS),
                                  params)
    jnew, _, jloss, _ = jax_train.make_masked_step(jm, LOSS, tx)(
        params, opt_state, x, y, w, jax.random.PRNGKey(0))
    pparams = model_params(pm)
    ptx, popt = optimizers.build(
        optimizers.Adam(0.01, epsilon=ADAM_EPS), pparams)
    before = pm.get_weights()
    _, ploss, wsum = make_masked_step(pm, LOSS, ptx)(
        TrainState(pparams, popt, 0), torch.from_numpy(x),
        torch.from_numpy(y), w)
    assert wsum == float(w.sum())
    np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    for got, want in zip(pm.get_weights(), jm.get_weights(jnew)):
        np.testing.assert_allclose(got, want, **TOL)
    if mask == "all_padding":
        for got, old in zip(pm.get_weights(), before):
            np.testing.assert_array_equal(got, old)


def test_model_predictor_over_rows_matches_jax():
    """ModelPredictor over (N, 784) rows, in batches that leave a ragged
    tail, appends the same prediction column as the JAX predictor."""
    jm = jax_zoo.mnist_mlp("float32")
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm.get_weights(params), np.random.default_rng(4))
    params = jm.set_weights(params, weights)
    rows = np.random.default_rng(5).uniform(0, 1, (37, 784)).astype(
        np.float32)
    want = JaxPredictor(JaxFitted(jm, params), batch_size=16).predict(
        JaxDataset({"features": rows}))["prediction"]
    port = zoo.mnist_mlp("float32", device="cpu").set_weights(weights)
    got = ModelPredictor(FittedModel(port), batch_size=16,
                         device="cpu").predict(Dataset({"features": rows}))
    assert got.columns == ["features", "prediction"]
    np.testing.assert_allclose(got["prediction"], want, **TOL)


def test_conv_blob_round_trip_is_bit_identical(tmp_path):
    """save → load → predict gives the same bits, BatchNorm statistics
    included, at bf16."""
    model = Sequential(BN_LAYERS(pl), input_shape=(7, 7, 2),
                       compute_dtype="bfloat16", device="cpu",
                       generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.layers[1].stats.mean.fill_(0.25)
    x = np.random.default_rng(6).standard_normal((5, 7, 7, 2)).astype(
        np.float32)
    path = str(tmp_path / "bn.npz")
    FittedModel(model).save(path)
    back = FittedModel.load(path, device="cpu")
    np.testing.assert_array_equal(back.predict(x),
                                  FittedModel(model).predict(x))
    assert float(back.model.layers[1].stats.mean[0]) == 0.25


def test_categorical_crossentropy_on_softmax_outputs_matches_jax():
    rng = np.random.default_rng(8)
    p = rng.dirichlet(np.ones(10), size=6).astype(np.float32)
    p[0, 3] = 0.0  # clipped at epsilon on both sides
    y = np.eye(10, dtype=np.float32)[[3, 1, 2, 3, 4, 5]]
    np.testing.assert_allclose(
        float(get_loss(LOSS)(torch.from_numpy(y), torch.from_numpy(p))),
        float(jax_loss(LOSS)(y, p)), rtol=1e-6)
