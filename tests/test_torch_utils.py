"""The port's ``utils`` function by function against the JAX package's
``distkeras_tpu/utils.py``: one-hot vectors, row dicts, the seeded
shuffle, ``precache``, the seeded uniform re-init (the same weights to
the bit, the input model untouched), the history averages, and model
blobs that cross both ways through ``serialize_keras_model`` /
``deserialize_keras_model``.  Without a Keras module imported, the
adapter raises ``TypeError`` instead of importing Keras, and
``honor_platform_env`` (a ``jax.config`` switch) has no counterpart."""

import sys

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import utils as jutils
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import FittedModel as JFitted
from distkeras_tpu.core.model import Sequential as JSequential
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu_torch import Dataset, Dense, FittedModel, Sequential, utils
from distkeras_tpu_torch.core import keras_adapter

torch.set_num_threads(1)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((8,), (6, 8), (3,), (8, 3))]


def port_fitted(seed=0):
    m = Sequential([Dense(8, activation="relu"),
                    Dense(3, activation="softmax")], input_shape=(6,),
                   compute_dtype="float32", device="cpu")
    return FittedModel(m).set_weights(_weights(seed))


def jax_fitted(seed=0):
    m = JSequential([jl.Dense(8, activation="relu"),
                     jl.Dense(3, activation="softmax")], input_shape=(6,),
                    compute_dtype="float32")
    params = m.init(jax.random.PRNGKey(0), (6,))
    return JFitted(m, m.set_weights(params, _weights(seed)))


@pytest.mark.parametrize("value,n", [(0, 3), (2, 3), (9.0, 10), (4, 5)])
def test_to_dense_vector(value, n):
    got, want = utils.to_dense_vector(value, n), jutils.to_dense_vector(
        value, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_new_dataframe_row():
    row = {"a": 1, "b": "x"}
    got = utils.new_dataframe_row(row, "c", 3)
    assert got == jutils.new_dataframe_row(row, "c", 3)
    assert list(got) == ["a", "b", "c"]
    assert "c" not in row


@pytest.mark.parametrize("seed", [0, 7, None])
def test_shuffle_and_precache(seed):
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20)
    mine = utils.shuffle(Dataset({"features": x, "label": y}), seed)
    theirs = jutils.shuffle(JDataset({"features": x, "label": y}), seed)
    if seed is not None:
        np.testing.assert_array_equal(mine["features"], theirs["features"])
        np.testing.assert_array_equal(mine["label"], theirs["label"])
    assert sorted(mine["label"]) == list(y)
    ds = Dataset({"features": x, "label": y})
    assert utils.precache(ds) is ds


@pytest.mark.parametrize("constraints,seed", [((-0.5, 0.5), 0),
                                              ((-0.05, 0.05), 3),
                                              ((0.0, 1.0), 11)])
def test_uniform_weights_same_bits_as_jax(constraints, seed):
    fitted = port_fitted()
    before = fitted.get_weights()
    got = utils.uniform_weights(fitted, constraints, seed)
    want = jutils.uniform_weights(jax_fitted(), constraints, seed)
    for a, b in zip(got.get_weights(), want.get_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(fitted.get_weights(), before):  # the input is kept
        np.testing.assert_array_equal(a, b)
    lo, hi = constraints
    assert all(((w >= lo) & (w <= hi)).all() for w in got.get_weights())


@pytest.mark.parametrize("histories", [[], [0.5], [3.0, 1.0, 2.0]])
def test_history_average(histories):
    assert utils.history_average(histories) == \
        jutils.history_average(histories)


def test_history_executors_average():
    hs = [[3.0, 2.0], np.array([4.0, 1.0]), 0.5]
    assert utils.history_executors_average(hs) == \
        jutils.history_executors_average(hs)


def test_model_blobs_cross_both_ways():
    x = np.random.default_rng(1).standard_normal((5, 6)).astype(np.float32)
    mine = utils.serialize_keras_model(port_fitted(2))
    theirs = jutils.serialize_keras_model(jax_fitted(2))
    assert mine["model"] == theirs["model"]
    for a, b in zip(mine["weights"], theirs["weights"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    port = utils.deserialize_keras_model(theirs, device="cpu")
    jfit = jutils.deserialize_keras_model(mine)
    np.testing.assert_allclose(port.predict(x), np.asarray(jfit.predict(x)),
                               atol=1e-6)


def test_without_keras_imported_the_adapter_raises_and_imports_none(
        monkeypatch):
    monkeypatch.delitem(sys.modules, "keras", raising=False)
    with pytest.raises(TypeError, match="none is imported"):
        utils.serialize_keras_model(object())
    with pytest.raises(TypeError, match="none is imported"):
        keras_adapter.convert_keras_model(object(), device="cpu")
    assert "keras" not in sys.modules


def test_honor_platform_env_has_no_counterpart():
    assert hasattr(jutils, "honor_platform_env")
    assert not hasattr(utils, "honor_platform_env")
