"""The port's serving slice as a whole against the JAX package.

A small ``transformer_lm`` (vocab 64, seq 32, d_model 32, 4 heads, 2 kv
heads, 2 layers, mlp 64) in its learned-position and rope + window=8
forms gets weights drawn with numpy; the JAX package saves it as its npz
blob, the port loads that blob, and ``ModelPredictor.predict`` must agree:
at f32 to atol 1e-4 (f32 sum order only), at bf16 to atol 5e-2.  At bf16
both run the plain attention path on the CPU, but XLA by default lets a
fusion skip the rounding of intermediate bf16 values
(``--xla_allow_excess_precision``, on by default) where the port rounds
every bf16 result; on these logits (max ~4) that gap is 0.03-0.04, and
with the flag off it falls to ~7e-3, which is sum order alone.
The blob goes back the other way too, and the config JSON and the weight
order are the JAX package's.
"""

import json

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.data.dataset import Dataset as JaxDataset
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.predictors import ModelPredictor as JaxPredictor
from distkeras_tpu_torch import (Dataset, FittedModel, ModelPredictor,
                                 Sequential, load_jax_weights,
                                 transformer_lm)
from distkeras_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, seq_len=32, d_model=32, num_heads=4,
             num_kv_heads=2, num_layers=2, mlp_dim=64)
FORMS = {"full": dict(),
         "rope_window": dict(positional="rope", attention_window=8)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def numpy_weights(model, params, seed):
    """Weights from a numpy seed, in the JAX layout: ~unit-scale tables,
    1/sqrt(fan_in) kernels, LayerNorm scales near 1, nonzero biases."""
    rng = np.random.default_rng(seed)
    out = []
    for w in model.get_weights(params):
        if w.ndim == 2:
            a = rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
        else:
            a = 0.1 * rng.standard_normal(w.shape) + (w == 1.0)
        out.append(a.astype(np.float32))
    return out


def jax_fitted(form, dtype, seed=0):
    model = jax_lm(**SMALL, **FORMS[form], compute_dtype=dtype)
    params = model.init(jax.random.PRNGKey(0))
    params = model.set_weights(params, numpy_weights(model, params, seed))
    return JaxFitted(model, params)


def tokens(seed, rows=10):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (rows, SMALL["seq_len"])).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_jax_blob_predicts_the_same_in_the_port(form, dtype, tmp_path):
    jf = jax_fitted(form, dtype)
    path = str(tmp_path / "jax.npz")
    jf.save(path)
    x = tokens(1)
    # 10 rows in batches of 4: a ragged last batch on both sides (the JAX
    # side takes its sharded route over the virtual devices)
    want = JaxPredictor(jf, batch_size=4).predict(
        JaxDataset({"features": x}))["prediction"]
    port = FittedModel.load(path, device="cpu")
    flash_attention.launches = 0
    got = ModelPredictor(port, batch_size=4, device="cpu").predict(
        Dataset({"features": x}))
    assert got.columns == ["features", "prediction"]
    pred = got["prediction"]
    assert pred.shape == want.shape == (10, SMALL["seq_len"],
                                        SMALL["vocab_size"])
    assert pred.dtype == np.float32
    np.testing.assert_allclose(pred, np.asarray(want), atol=TOL[dtype])
    assert flash_attention.launches == 0  # CPU tensors: the plain path


@pytest.mark.parametrize("form", sorted(FORMS))
def test_port_blob_loads_back_in_jax(form, tmp_path):
    jf = jax_fitted(form, "float32", seed=2)
    # deserialize is the JAX package's name for from_blob
    port = FittedModel.deserialize(jf.serialize(), device="cpu")
    path = str(tmp_path / "port.npz")
    port.save(path)
    back = JaxFitted.load(path)
    assert back.model.to_json() == jf.model.to_json()
    for a, b in zip(back.get_weights(), jf.get_weights()):
        np.testing.assert_array_equal(a, b)
    x = tokens(3, rows=4)
    np.testing.assert_allclose(port.predict(x, batch_size=2),
                               back.predict(x), atol=1e-4)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_weight_order_and_config_match_jax(form):
    jf = jax_fitted(form, "bfloat16", seed=4)
    port = transformer_lm(**SMALL, **FORMS[form], device="cpu")
    # same constructor arguments → the same JSON, byte for byte
    assert port.to_json() == jf.model.to_json()
    spec = json.loads(port.to_json())
    block = spec["layers"][1 if form == "rope_window" else 2]
    assert block["kind"] == "TransformerBlock"
    assert "rope_theta" not in block  # class defaults stay out of the JSON
    assert Sequential.from_json(jf.model.to_json(),
                                device="cpu").to_json() == port.to_json()
    in_memory = FittedModel.from_blob(jf.serialize(), device="cpu")
    assert in_memory.model.to_json() == port.to_json()
    assert port.set_weights(jf.get_weights()) is port
    got = port.get_weights()
    want = jf.get_weights()
    assert [w.shape for w in got] == [w.shape for w in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="weight count"):
        load_jax_weights(port, want[:-1])
    with pytest.raises(ValueError, match="shape"):
        load_jax_weights(port, [w.T for w in want])


def test_generator_seeds_initialisation():
    a = transformer_lm(**SMALL, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    b = transformer_lm(**SMALL, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    c = transformer_lm(**SMALL, device="cpu",
                       generator=torch.Generator().manual_seed(6))
    for x, y in zip(a.get_weights(), b.get_weights()):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y)
               for x, y in zip(a.get_weights(), c.get_weights()))
    with pytest.raises(ValueError, match="positional"):
        transformer_lm(**SMALL, positional="alibi", device="cpu")


def test_predictor_needs_fitted_model():
    with pytest.raises(TypeError, match="FittedModel"):
        ModelPredictor(transformer_lm(**SMALL, device="cpu"), device="cpu")
