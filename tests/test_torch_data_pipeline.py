"""The port's copy of the dist-keras data pipeline against the JAX
package's: the eight transformers, the five evaluators, the workload
datasets (their synthetic stand-ins, the ``.npz`` lookup and
``read_csv``), and the MNIST flow of the transformer → trainer →
predictor → evaluator pipeline on the CPU.

The pipeline is numpy, so every comparison is exact: the same inputs give
the same arrays to the bit (``LossEvaluator`` computes its loss through
each package's own loss, within 1e-6).
"""

import numpy as np
import pytest
import torch

import distkeras_tpu.data.datasets as jax_datasets
import distkeras_tpu.data.transformers as jax_transformers
import distkeras_tpu.evaluators as jax_evaluators
import distkeras_tpu_torch.data.datasets as datasets
import distkeras_tpu_torch.data.transformers as transformers
import distkeras_tpu_torch.evaluators as evaluators
from distkeras_tpu.data.dataset import Dataset as JaxDataset
from distkeras_tpu_torch import (AccuracyEvaluator, Dataset,
                                 LabelIndexTransformer, MinMaxTransformer,
                                 ModelPredictor, OneHotTransformer,
                                 SingleTrainer, mnist_mlp)

torch.set_num_threads(1)


def both(columns):
    """The same columns as a port Dataset and a JAX Dataset."""
    return Dataset(dict(columns)), JaxDataset(dict(columns))


def assert_same_dataset(got, want):
    assert got.columns == want.columns
    for name in got.columns:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)


RNG = np.random.default_rng(0)
ROWS = {"features": (RNG.uniform(0, 255, (12, 16))).astype(np.float32),
        "label": RNG.integers(0, 5, 12),
        "prediction": RNG.dirichlet(np.ones(5), 12).astype(np.float32)}

TRANSFORMERS = [
    ("MinMaxTransformer", dict(n_min=-1, n_max=1, o_min=0, o_max=255)),
    ("StandardScaleTransformer", dict(output_col="scaled")),
    ("DenseTransformer", {}),
    ("ReshapeTransformer", dict(shape=(4, 4, 1), output_col="image")),
    ("OneHotTransformer", dict(output_dim=5)),
    ("LabelIndexTransformer", {}),
    ("LabelVectorTransformerUDF", dict(fn=lambda row: row[::-1] * 2,
                                       input_col="features",
                                       output_col="udf")),
]


@pytest.mark.parametrize("name,kwargs", TRANSFORMERS,
                         ids=[t[0] for t in TRANSFORMERS])
def test_transformers_equal_jax(name, kwargs):
    ours, theirs = both(ROWS)
    got = getattr(transformers, name)(**kwargs).transform(ours)
    want = getattr(jax_transformers, name)(**kwargs)(theirs)
    assert_same_dataset(got, want)


def test_transformer_base_and_exports():
    assert issubclass(transformers.MinMaxTransformer,
                      transformers.Transformer)
    names = {n for n in dir(jax_transformers) if n.endswith("Transformer")
             or n.endswith("UDF")}
    assert names <= set(dir(transformers))
    with pytest.raises(NotImplementedError):
        transformers.Transformer().transform(Dataset(ROWS))


LABELS = np.array([0, 1, 1, 0, 1, 0, 1, 1, 0, 0])
SCORES = np.array([0.1, 0.9, 0.6, 0.6, 0.4, 0.2, 0.8, 0.6, 0.3, 0.7])

EVALUATORS = [
    ("AccuracyEvaluator", {}),
    ("F1Evaluator", dict(average="binary")),
    ("F1Evaluator", dict(average="macro", metric="precision")),
    ("F1Evaluator", dict(average="micro", metric="recall")),
    ("TopKAccuracyEvaluator", dict(k=1)),
    ("TopKAccuracyEvaluator", dict(k=2)),
    ("AUCEvaluator", {}),
]


@pytest.mark.parametrize("name,kwargs", EVALUATORS,
                         ids=[f"{e[0]}-{i}" for i, e in enumerate(EVALUATORS)])
def test_evaluators_equal_jax(name, kwargs):
    """Class indices (with ties in the scores) and two-column
    probabilities, one-hot and index labels."""
    probs = np.stack([1 - SCORES, SCORES], axis=1)
    cols = {"prediction_index": (SCORES > 0.5).astype(np.int64),
            "prediction": probs, "label": LABELS,
            "onehot": np.eye(2)[LABELS]}
    ours, theirs = both(cols)
    got = getattr(evaluators, name)(**kwargs).evaluate(ours)
    want = getattr(jax_evaluators, name)(**kwargs).evaluate(theirs)
    assert got == want
    if "label_col" not in kwargs and name != "AUCEvaluator":
        kw = dict(kwargs, label_col="onehot")
        assert (getattr(evaluators, name)(**kw).evaluate(ours)
                == getattr(jax_evaluators, name)(**kw).evaluate(theirs))


@pytest.mark.parametrize("loss", ["categorical_crossentropy",
                                  "mean_squared_error"])
def test_loss_evaluator_matches_jax(loss):
    probs = RNG.dirichlet(np.ones(4), 9).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[RNG.integers(0, 4, 9)]
    ours, theirs = both({"prediction": probs, "label_encoded": onehot})
    got = evaluators.LossEvaluator(loss).evaluate(ours)
    want = jax_evaluators.LossEvaluator(loss).evaluate(theirs)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_evaluators_refuse_what_jax_refuses():
    bad = Dataset({"prediction_index": np.array([0.0, np.nan]),
                   "label": np.array([0, 1])})
    with pytest.raises(ValueError, match="NaN"):
        evaluators.AccuracyEvaluator().evaluate(bad)
    with pytest.raises(ValueError, match="binary"):
        evaluators.AUCEvaluator().evaluate(Dataset({
            "prediction": np.array([0.1, 0.5, 0.9]),
            "label": np.array([0, 1, 2])}))
    with pytest.raises(ValueError, match="unknown average"):
        evaluators.F1Evaluator(average="weighted")


@pytest.mark.parametrize("loader,kwargs", [
    ("load_mnist", dict(n_train=300, n_test=50)),
    ("load_mnist", dict(n_train=40, n_test=10, seed=5, noise=0.9)),
    ("load_cifar10", dict(n_train=60, n_test=20)),
    ("load_atlas_higgs", dict(n_train=500, n_test=100)),
])
def test_synthetic_datasets_are_bit_identical(loader, kwargs, monkeypatch):
    """No ``.npz`` anywhere: both packages make the same synthetic
    arrays from the same seed."""
    for mod in (datasets, jax_datasets):
        monkeypatch.setattr(mod, "_DATA_DIRS", [""])
    got = getattr(datasets, loader)(**kwargs)
    want = getattr(jax_datasets, loader)(**kwargs)
    for g, w in zip(got, want):
        assert_same_dataset(g, w)


def test_real_npz_is_found_first(tmp_path, monkeypatch):
    """A ``<name>.npz`` under the data directory is loaded (reshaped,
    cast and cut) instead of the stand-in, identically."""
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (20, 28, 28)).astype(np.uint8),
             y_train=rng.integers(0, 10, 20),
             x_test=rng.integers(0, 256, (6, 28, 28)).astype(np.uint8),
             y_test=rng.integers(0, 10, 6))
    for mod in (datasets, jax_datasets):
        monkeypatch.setattr(mod, "_DATA_DIRS", [str(tmp_path)])
    assert datasets.has_real_data("mnist")
    assert not datasets.has_real_data("cifar10")
    got = datasets.load_mnist(n_train=15, n_test=4)
    want = jax_datasets.load_mnist(n_train=15, n_test=4)
    assert got[0]["features"].shape == (15, 784)
    for g, w in zip(got, want):
        assert_same_dataset(g, w)


def test_load_digits_matches_jax_where_sklearn_imports():
    """The real digits set where scikit-learn is installed; without it
    both packages raise ImportError."""
    try:
        import sklearn  # noqa: F401
    except ImportError:
        for loader in (datasets.load_digits, jax_datasets.load_digits):
            with pytest.raises(ImportError):
                loader()
        return
    got = datasets.load_digits(n_train=1000, n_test=200, seed=3)
    want = jax_datasets.load_digits(n_train=1000, n_test=200, seed=3)
    for g, w in zip(got, want):
        assert_same_dataset(g, w)


@pytest.mark.parametrize("features", [None, ["b", "a"]])
def test_read_csv_matches_jax(tmp_path, features):
    path = tmp_path / "rows.csv"
    path.write_text("a,b,label,c\n1.5,2,1,-3e2\n4,5.25,0,6\n7,8,1,9\n")
    got = datasets.read_csv(str(path), "label", features)
    want = jax_datasets.read_csv(str(path), "label", features)
    assert_same_dataset(got, want)
    with pytest.raises(ValueError, match="not in CSV header"):
        datasets.read_csv(str(path), "missing")
    with pytest.raises(ValueError, match="empty"):
        datasets.read_csv(str(path), "label", [])


def test_read_csv_imports_no_native_parser():
    """The port's read_csv imports no native parser of the JAX package's:
    its native route is the port's own build of its own copy of
    ``csrc/csvloader.cpp``, loaded under the port's name."""
    import inspect
    source = inspect.getsource(datasets)
    assert "import _csvloader" not in source
    assert "distkeras_tpu._csvloader" not in source
    assert datasets._csv_module().__name__ == \
        "distkeras_tpu_torch._csvloader"


def test_mnist_flow_through_single_trainer_and_predictor():
    """The MNIST flow of the package's verify recipe, at a CPU size:
    MinMax → OneHot → SingleTrainer → ModelPredictor → LabelIndex →
    Accuracy.  The synthetic classes are learnable: accuracy passes 0.8
    and the loss falls."""
    train, test = datasets.load_mnist(n_train=512, n_test=128)
    scale = MinMaxTransformer(0, 1, 0, 255)
    train, test = scale.transform(train), scale.transform(test)
    train = OneHotTransformer(10, input_col="label",
                              output_col="label_encoded").transform(train)
    trainer = SingleTrainer(mnist_mlp("float32", device="cpu"),
                            batch_size=32, num_epoch=2,
                            label_col="label_encoded",
                            worker_optimizer="adam", learning_rate=1e-3,
                            device="cpu")
    fitted = trainer.train(train)
    history = trainer.get_history()
    assert len(history) == 2 * 16
    assert np.mean(history[16:]) < np.mean(history[:16])
    predicted = ModelPredictor(fitted, device="cpu").predict(test)
    assert predicted["prediction"].shape == (128, 10)
    indexed = LabelIndexTransformer().transform(predicted)
    assert AccuracyEvaluator().evaluate(indexed) >= 0.8
