"""The port's training path against the JAX package: ``SingleTrainer``
over a small ``transformer_lm``, the masked train step, dropout in train
mode, and what the slice refuses until it is ported.

Both trainers start from the same numpy-drawn weights (a FittedModel on
each side: the two packages' generators differ) and train at f32 on the
x+1 next-token task.  The per-batch losses agree to rtol 1e-4 and the
final weights to atol 1e-4.  The optimizers are Adam with epsilon 1e-4,
and SGD with Nesterov momentum under a warm-up cosine schedule, global-
norm clipping and shuffled epochs: without RoPE a key bias has an
exact-zero gradient (softmax ignores a constant added to a row), so both
packages hold only f32 rounding noise (~1e-9) there, which Adam at its
Keras epsilon of 1e-7 would turn into steps of ~lr/30 in opposite
directions; at 1e-4 it stays below 1e-7 of a step.  (The Adam rule itself
is held against optax at its default epsilon in
tests/test_torch_losses_optimizers.py.)
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import SingleTrainer as JaxTrainer
from distkeras_tpu.core import optimizers as jax_opt
from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.core import train as jax_train
from distkeras_tpu.core.train import make_masked_step as jax_masked_step
from distkeras_tpu.data.dataset import Dataset as JaxDataset
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.core.layers import Dense as JaxDense
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu_torch import (Dataset, Dense, Dropout, FittedModel,
                                 ModelPredictor, Sequential, SingleTrainer,
                                 TransformerBlock, transformer_lm)
from distkeras_tpu_torch.core import optimizers
from distkeras_tpu_torch.core.layers import _dropout
from distkeras_tpu_torch.core.train import (TrainState, batch_epoch_data,
                                            init_state, make_epoch_runner,
                                            make_loss_fn, make_masked_step,
                                            model_params)

torch.set_num_threads(1)

SMALL = dict(vocab_size=16, seq_len=32, d_model=32, num_heads=4,
             num_kv_heads=2, num_layers=2, mlp_dim=64,
             compute_dtype="float32")
FORMS = {"full": dict(),
         "rope_window": dict(positional="rope", attention_window=8)}
# trainer settings per case: (optimizer from a package, more keywords,
# shuffle)
SETTINGS = {
    "adam": (lambda pkg: pkg.Adam(3e-3, epsilon=1e-4), {}, False),
    "sgd_nesterov_scheduled_shuffled": (
        lambda pkg: pkg.SGD(0.1, momentum=0.9, nesterov=True),
        dict(lr_schedule="warmup_cosine", gradient_clip_norm=1.0), True),
}
TRAIN = dict(batch_size=16, num_epoch=2,
             loss="sparse_categorical_crossentropy_from_logits")


def numpy_weights(model, params, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
             if w.ndim == 2 else 0.1 * rng.standard_normal(w.shape)
             + (w == 1.0)).astype(np.float32)
            for w in model.get_weights(params)]


def both_fitted(form, seed=0):
    """The same weights as a JAX FittedModel and a port FittedModel."""
    jm = jax_lm(**SMALL, **FORMS[form])
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm, params, seed)
    port = transformer_lm(**SMALL, **FORMS[form], device="cpu")
    port.set_weights(weights)
    return JaxFitted(jm, jm.set_weights(params, weights)), FittedModel(port)


def lm_data(seed, rows=40):
    x = np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (rows, SMALL["seq_len"])).astype(np.int32)
    return x, ((x + 1) % SMALL["vocab_size"]).astype(np.int64)


def assert_same_training(jt, jfit, pt, pfit):
    np.testing.assert_allclose(pt.get_history(), jt.get_history(),
                               rtol=1e-4)
    for a, b in zip(pfit.get_weights(), jfit.get_weights()):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_single_trainer_matches_jax(form, setting):
    jf, pf = both_fitted(form)
    x, y = lm_data(1)  # 40 rows in batches of 16: a padded tail batch
    opt, extra, shuffle = SETTINGS[setting]
    jt = JaxTrainer(jf, **TRAIN, **extra, worker_optimizer=opt(jax_opt))
    jfit = jt.train(JaxDataset({"features": x, "label": y}),
                    shuffle=shuffle)
    pt = SingleTrainer(pf, **TRAIN, **extra,
                       worker_optimizer=opt(optimizers), device="cpu")
    pfit = pt.train(Dataset({"features": x, "label": y}), shuffle=shuffle)
    assert len(pt.get_history()) == 6
    assert_same_training(jt, jfit, pt, pfit)
    # the trainer copied the weights it started from: its input is intact
    for a, b in zip(pf.get_weights(), jf.get_weights()):
        np.testing.assert_array_equal(a, b)
    # the trained model is what ModelPredictor serves
    served = ModelPredictor(pfit, batch_size=3, device="cpu").predict(
        Dataset({"features": x[:5]}))["prediction"]
    np.testing.assert_allclose(served, jfit.predict(x[:5]), atol=1e-4)
    assert pt.get_training_time() > 0.0
    assert pt.serialize()["model"] == jfit.model.to_json()


def test_validation_and_early_stopping_match_jax():
    """min_delta larger than any gain: every epoch after the first counts
    as no improvement, so patience 2 stops after the third epoch."""
    jf, pf = both_fitted("full", seed=4)
    x, y = lm_data(5, rows=32)
    xv, yv = lm_data(6, rows=8)
    kw = dict(TRAIN, num_epoch=5, worker_optimizer="adam",
              learning_rate=3e-3, early_stopping_patience=2,
              early_stopping_min_delta=10.0)
    jt = JaxTrainer(jf, **kw)
    jt.train(JaxDataset({"features": x, "label": y}),
             validation_data=JaxDataset({"features": xv, "label": yv}))
    pt = SingleTrainer(pf, **kw, device="cpu")
    pt.train(Dataset({"features": x, "label": y}),
             validation_data=Dataset({"features": xv, "label": yv}))
    assert pt.stopped_epoch == jt.stopped_epoch == 2
    np.testing.assert_allclose(pt.validation_history, jt.validation_history,
                               rtol=1e-4)
    np.testing.assert_allclose(pt.get_history(), jt.get_history(),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="validation_data"):
        SingleTrainer(pf, **kw, device="cpu").train(
            Dataset({"features": x, "label": y}))


def small_mlp():
    """A two-layer MLP on both sides with the same weights."""
    jm = JaxSequential([JaxDense(8, activation="relu"), JaxDense(3)],
                       input_shape=(5,), compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm, params, 7)
    pm = Sequential([Dense(8, activation="relu"), Dense(3)],
                    input_shape=(5,), compute_dtype="float32",
                    device="cpu")
    pm.set_weights(weights)
    return jm, jm.set_weights(params, weights), pm


@pytest.mark.parametrize("weights", ["padded", "all_padding"])
def test_masked_step_matches_jax(weights):
    """Σwᵢ·lossᵢ / max(Σw, 1) over wrap-padded rows; a batch of padding
    only is a true no-op (Adam would move on a zero gradient)."""
    jm, jparams, pm = small_mlp()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = rng.standard_normal((6, 3)).astype(np.float32)
    w = (np.array([1, 1, 1, 1, 0, 0], np.float32) if weights == "padded"
         else np.zeros(6, np.float32))
    jtx, jstate = jax_opt.build("adam", jparams, learning_rate=0.01)
    jnew, jnew_state, jloss, jwsum = jax.jit(jax_masked_step(
        jm, "mse", jtx))(jparams, jstate, x, y, w, jax.random.PRNGKey(0))
    params = model_params(pm)
    tx, opt_state = optimizers.build("adam", params, learning_rate=0.01)
    before = [p.detach().clone() for p in params.values()]
    with torch.no_grad():  # the mean over the 4 real rows only
        real_mean = ((torch.from_numpy(y[:4])
                      - pm(torch.from_numpy(x[:4]))) ** 2).mean()
    state, loss, wsum = make_masked_step(pm, "mse", tx)(
        TrainState(params, opt_state, 0), torch.from_numpy(x),
        torch.from_numpy(y), w)
    assert wsum == float(jwsum)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    for a, b in zip(pm.get_weights(), jm.get_weights(jnew)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    if weights == "all_padding":
        assert state.opt_state is opt_state
        for p, b in zip(params.values(), before):
            torch.testing.assert_close(p.detach(), b, atol=0, rtol=0)
        # the masked mean of the padded rows alone is 0 on both sides
        assert float(loss) == float(jloss) == 0.0
    else:
        assert state.opt_state is not opt_state
        torch.testing.assert_close(loss, real_mean, atol=1e-6, rtol=1e-6)


def test_train_helpers_match_jax():
    """The epoch stacking (wrap-padded tail and its mask), the unmasked
    train-mode loss, and ``init_state`` building parameters and their
    optimizer state."""
    jm, jparams, pm = small_mlp()
    rng = np.random.default_rng(10)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    y = rng.standard_normal((7, 3)).astype(np.float32)
    got, want = batch_epoch_data(x, y, 3), jax_train.batch_epoch_data(x, y, 3)
    assert got[3] == want[3] == 3
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    value, stats = make_loss_fn(pm, "mse")(torch.from_numpy(x),
                                           torch.from_numpy(y))
    assert stats == {}  # no BatchNorm: an empty statistics aux, as in JAX
    jvalue, _ = jax_train.make_loss_fn(jm, "mse")(jparams, x, y, None)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue),
                               rtol=1e-6)
    fresh = Sequential([Dense(4), Dense(2)], compute_dtype="float32",
                       device="cpu")
    state, tx = init_state(fresh, torch.Generator().manual_seed(0), (5,),
                           "adam", learning_rate=0.1)
    assert list(state.params) == ["0/bias", "0/kernel", "1/bias",
                                  "1/kernel"]
    assert state.params["0/kernel"].shape == (5, 4) and state.step == 0
    grads = [torch.ones_like(p) for p in state.params.values()]
    updates, _ = tx.update(grads, state.opt_state,
                           list(state.params.values()))
    for u in updates:  # Adam's first step: -lr·g/(|g| + eps)
        torch.testing.assert_close(u, torch.full_like(u, -0.1 / (1 + 1e-7)))


def test_dropout_is_identity_at_inference():
    x = torch.randn(4, 10, generator=torch.Generator().manual_seed(0))
    layer = Dropout(0.5)
    assert layer(x) is x
    assert layer(x, train=False, generator=torch.Generator()) is x
    block = TransformerBlock(2, 4, 16, dropout=0.3, causal=True)
    block.build((6, 8), torch.Generator().manual_seed(1), "cpu")
    h = torch.randn(2, 6, 8, generator=torch.Generator().manual_seed(2))
    eval_out = block(h, torch.float32)
    block.dropout = 0.0
    torch.testing.assert_close(eval_out, block(h, torch.float32,
                                               train=True), atol=0, rtol=0)


def test_dropout_train_mode_statistics_and_determinism():
    rate, n = 0.3, 200_000
    x = torch.ones(n)
    out = _dropout(torch.Generator().manual_seed(0), rate, x, True)
    kept = out != 0
    share = kept.double().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) < 3 * sigma
    # inverted dropout: the kept values are scaled by 1 / (1 - rate)
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / (1 - rate)))
    again = _dropout(torch.Generator().manual_seed(0), rate, x, True)
    torch.testing.assert_close(out, again, atol=0, rtol=0)
    other = _dropout(torch.Generator().manual_seed(1), rate, x, True)
    assert not torch.equal(out, other)
    with pytest.raises(ValueError, match="generator"):
        Dropout(0.5)(x, train=True)


def test_transformer_block_drops_both_residual_branches():
    """Train mode draws one mask for the attention branch, then one for
    the MLP branch, from the generator it is given."""
    block = TransformerBlock(2, 4, 16, dropout=0.4, causal=True)
    block.build((6, 8), torch.Generator().manual_seed(1), "cpu")
    x = torch.randn(2, 6, 8, generator=torch.Generator().manual_seed(2))
    got = block(x, torch.float32, train=True,
                generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    f32 = torch.float32
    h = block.attn(block.ln1(x, f32), f32)
    x1 = x + _dropout(g, 0.4, h, True)
    h = block.ln2(x1, f32)
    h = torch.nn.functional.gelu(h @ block.mlp_w1 + block.mlp_b1,
                                 approximate="tanh")
    want = x1 + _dropout(g, 0.4, h @ block.mlp_w2 + block.mlp_b2, True)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert not torch.allclose(got, block(x, f32))


def test_dropout_trains_through_the_trainer():
    """A dropout LM trains (the generator reaches every block) and stays
    deterministic for one seed."""
    x, y = lm_data(9, rows=16)
    histories = []
    for _ in range(2):
        model = transformer_lm(**{**SMALL, "dropout": 0.2}, device="cpu")
        t = SingleTrainer(model, **dict(TRAIN, worker_optimizer="adam",
                                        learning_rate=3e-3), device="cpu")
        t.train(Dataset({"features": x, "label": y}))
        histories.append(t.get_history())
    assert histories[0] == histories[1]


@pytest.mark.parametrize("case", ["segment_col", "segment_col_unmasked",
                                  "packed_runner", "segment_ids",
                                  "keras_model"])
def test_what_waits_for_later_slices_raises(case):
    """Sequence packing arrived with its slice: ``segment_col``, the
    packed runner and ``segment_ids`` now work (checked against the JAX
    package in tests/test_torch_packing.py); an unmasked loss with
    ``segment_col`` still raises.  The Keras adapter arrived too: a Keras
    model trains (against Keras and the JAX adapter in
    tests/test_torch_keras_adapter.py), and what is no model raises."""
    model = transformer_lm(**SMALL, device="cpu")
    rope = transformer_lm(**FORMS["rope_window"], **SMALL, device="cpu")
    x = torch.zeros(2, 32, dtype=torch.int64)
    seg = torch.ones(2, 32, dtype=torch.int64)
    if case == "segment_col":
        t = SingleTrainer(rope, segment_col="seg", device="cpu",
                          batch_size=2,
                          loss="sparse_categorical_crossentropy_masked")
        t.train(Dataset({"features": x.numpy(), "label": x.numpy() - 1,
                         "seg": seg.numpy()}))
        assert t.segment_col == "seg" and len(t.get_history()) == 1
    elif case == "segment_col_unmasked":
        with pytest.raises(ValueError, match="masked"):
            SingleTrainer(model, segment_col="seg", device="cpu",
                          loss="sparse_categorical_crossentropy")
    elif case == "packed_runner":
        tx = optimizers.build_tx("sgd", model_params(rope))
        state = TrainState(model_params(rope), tx.init(
            list(model_params(rope).values())), 0)
        _, losses = make_epoch_runner(
            rope, "sparse_categorical_crossentropy_masked_from_logits", tx,
            packed=True)(state, x[None], x[None], seg[None],
                         np.ones((1, 2), np.float32))
        assert losses.shape == (1,)
    elif case == "segment_ids":
        # one segment per row is the unpacked forward
        assert torch.equal(rope(x, segment_ids=seg), rope(x))
        with pytest.raises(ValueError, match="rope"):
            model(x, segment_ids=seg)
    else:
        keras = pytest.importorskip("keras")
        km = keras.Sequential([keras.layers.Input((6,)),
                               keras.layers.Dense(3, activation="softmax")])
        t = SingleTrainer(km, batch_size=8, device="cpu")
        rng = np.random.default_rng(0)
        t.train(Dataset({
            "features": rng.standard_normal((32, 6)).astype(np.float32),
            "label": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]}))
        assert len(t.get_history()) == 4
        assert [type(layer).__name__ for layer in t.master_model.layers] \
            == ["Dense"]
        with pytest.raises(TypeError, match="Cannot interpret model"):
            SingleTrainer(object(), device="cpu")


def test_trainer_defaults_to_the_card():
    model = transformer_lm(**SMALL, device="cpu")
    if torch.cuda.is_available():
        assert SingleTrainer(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SingleTrainer(model)
