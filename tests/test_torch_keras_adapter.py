"""The port's Keras adapter (``distkeras_tpu_torch.core.keras_adapter``)
against Keras and the JAX package's adapter, at f32 on the CPU.

A Keras MLP and a Keras Functional ConvNet convert to port models whose
forward equals the Keras forward and the JAX converted forward; the
flat weight list is the JAX adapter's, array for array; branching graphs
are refused as the JAX adapter refuses them; a trainer takes a Keras
model; ``utils.serialize_keras_model`` of a Keras model gives the JAX
package's blob, and each package loads the other's.  Keras costs seconds
to import, so this file holds only the cases that need it (the adapter
never imports Keras itself: ``tests/test_torch_utils.py`` checks that)."""

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import jax

from distkeras_tpu.core import keras_adapter as jka
from distkeras_tpu.utils import (deserialize_keras_model as j_deserialize,
                                 serialize_keras_model as j_serialize)
from distkeras_tpu_torch import Dataset, OneHotTransformer, SingleTrainer
from distkeras_tpu_torch import utils
from distkeras_tpu_torch.core import keras_adapter as ka

torch.set_num_threads(1)


def keras_mlp():
    return keras.Sequential([
        keras.layers.Input((16,)),
        keras.layers.Dense(32, activation="relu"),
        keras.layers.Dense(4, activation="softmax"),
    ])


def keras_functional_convnet():
    """The reference's MNIST-ConvNet idiom: a linear chain built with the
    functional API, BatchNorm and LayerNorm-free."""
    inp = keras.layers.Input((8, 8, 1))
    h = keras.layers.Conv2D(4, 3, padding="same", activation="relu")(inp)
    h = keras.layers.MaxPooling2D(2)(h)
    h = keras.layers.Conv2D(8, 3, padding="valid", activation="relu")(h)
    h = keras.layers.AveragePooling2D(1)(h)
    h = keras.layers.Flatten()(h)
    h = keras.layers.Dense(16, activation="relu")(h)
    h = keras.layers.Dropout(0.1)(h)
    out = keras.layers.Dense(4, activation="softmax")(h)
    return keras.Model(inp, out)


def port_forward(km, x):
    m = ka.convert_keras_model(km, device="cpu")
    m.set_weights(ka.keras_weights(km))
    m.compute_dtype = "float32"
    return m(torch.from_numpy(x)).detach().numpy()


def jax_forward(km, x):
    m = jka.convert_keras_model(km)
    params = m.set_weights(m.init(jax.random.PRNGKey(0), m.input_shape),
                           jka.keras_weights(km))
    m.compute_dtype = "float32"
    return np.asarray(m.apply(params, x))


@pytest.mark.parametrize("make,shape,tol", [
    (keras_mlp, (8, 16), 1e-5),
    (keras_functional_convnet, (4, 8, 8, 1), 1e-4)],
    ids=["mlp", "functional-convnet"])
def test_converted_forward_equals_keras_and_jax(make, shape, tol):
    km = make()
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = port_forward(km, x)
    np.testing.assert_allclose(got, np.asarray(km(x, training=False)),
                               atol=tol)
    np.testing.assert_allclose(got, jax_forward(km, x), atol=tol)
    for mine, theirs in zip(ka.keras_weights(km), jka.keras_weights(km)):
        np.testing.assert_array_equal(mine, theirs)
    assert ka.convert_keras_model(km, device="cpu").to_json() == \
        jka.convert_keras_model(km).to_json()


def test_branching_graphs_are_refused_as_in_jax():
    inp = keras.layers.Input((16,))
    h = keras.layers.Dense(16, activation="relu")(inp)
    merge = keras.Model(inp, keras.layers.Add()([inp, h]))
    inp2 = keras.layers.Input((16,))
    shared = keras.layers.Dense(16)
    twice = keras.Model(inp2, shared(shared(inp2)))
    inp3 = keras.layers.Input((16,))
    multi = keras.Model(inp3, [keras.layers.Dense(4)(inp3),
                               keras.layers.Dense(2)(inp3)])
    lstm = keras.Sequential([keras.layers.Input((4, 16)),
                             keras.layers.LSTM(8)])
    for km, match in ((merge, "merge"), (twice, "called 2 times"),
                      (multi, "outputs"), (lstm, "Unsupported Keras")):
        with pytest.raises(ValueError, match=match):
            jka.convert_keras_model(km)
        with pytest.raises(ValueError, match=match):
            ka.convert_keras_model(km, device="cpu")


def test_a_trainer_takes_a_keras_model():
    km = keras_mlp()
    rng = np.random.default_rng(2)
    protos = rng.uniform(-1, 1, (4, 16))
    labels = rng.integers(0, 4, 256)
    x = (protos[labels] + 0.2 * rng.standard_normal((256, 16))).astype(
        np.float32)
    ds = OneHotTransformer(4).transform(
        Dataset({"features": x, "label": labels.astype(np.int64)}))
    t = SingleTrainer(km, batch_size=32, num_epoch=3,
                      label_col="label_encoded", worker_optimizer="adam",
                      learning_rate=5e-3, device="cpu")
    assert t.master_model.to_json() == jka.convert_keras_model(km).to_json()
    fitted = t.train(ds)
    acc = float(np.mean(np.argmax(fitted.predict(x[:128]), -1)
                        == labels[:128]))
    assert acc > 0.8, acc


def test_keras_blobs_cross_both_ways():
    km = keras_mlp()
    x = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    mine, theirs = utils.serialize_keras_model(km), j_serialize(km)
    assert mine["model"] == theirs["model"]
    for a, b in zip(mine["weights"], theirs["weights"]):
        np.testing.assert_array_equal(a, b)
    port = utils.deserialize_keras_model(theirs, device="cpu")
    jfit = j_deserialize(mine)
    port.model.compute_dtype = jfit.model.compute_dtype = "float32"
    np.testing.assert_allclose(port.predict(x), np.asarray(km(x)),
                               atol=1e-5)
    np.testing.assert_allclose(port.predict(x), jfit.predict(x), atol=1e-6)
