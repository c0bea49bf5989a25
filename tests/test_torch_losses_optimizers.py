"""The port's losses and optimizers against the JAX package's.

Every loss name is held against ``distkeras_tpu.core.losses`` at f32
(atol 1e-5 on unit-scale values), its ``per_example`` form included.
Every optimizer name is held against optax through
``distkeras_tpu.core.optimizers.build``, step by step on the same
gradients, at rtol 1e-5: with its defaults, with a warm-up cosine
schedule and global-norm clipping, and with a cosine schedule and
gradient accumulation K = 2.  The parameters include a BatchNorm-style
``stats`` subtree, which both sides mask out of the update rule.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.core import losses as jax_losses
from distkeras_tpu.core import optimizers as jax_opt
from distkeras_tpu_torch.core import losses, optimizers

torch.set_num_threads(1)

B, S, C = 3, 5, 7


def loss_inputs(name, rng):
    """(y_true, y_pred) of the shapes and ranges the loss is used on."""
    logits = rng.standard_normal((B, S, C)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if "sparse" in name:
        labels = rng.integers(0, C, (B, S))
        if "masked" in name:
            labels[0, :2] = -1
            labels[2, :] = -1  # an example with no valid position
        return labels, (logits if "logits" in name else probs)
    if name.startswith("categorical"):
        onehot = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, S))]
        return onehot, (logits if "logits" in name else probs)
    if name.startswith("binary"):
        y = rng.integers(0, 2, (B, C)).astype(np.float32)
        p = 1 / (1 + np.exp(-logits[:, 0]))
        return y, (logits[:, 0] if "logits" in name else p)
    if name in ("kullback_leibler_divergence", "kld"):
        return probs[:, 0], np.roll(probs[:, 0], 1, axis=-1)
    if name in ("hinge", "squared_hinge"):
        return rng.integers(0, 2, (B, C)).astype(np.float32), logits[:, 0]
    if name in ("poisson", "mean_squared_logarithmic_error", "msle",
                "mean_absolute_percentage_error", "mape"):
        return (rng.poisson(2.0, (B, C)).astype(np.float32) + 0.5,
                np.abs(logits[:, 0]) + 0.1)
    return logits[:, 0], rng.standard_normal((B, C)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(losses._LOSSES))
def test_loss_and_per_example_match_jax(name):
    assert sorted(losses._LOSSES) == sorted(jax_losses._LOSSES)
    y, p = loss_inputs(name, np.random.default_rng(len(name)))
    jfn, tfn = jax_losses.get_loss(name), losses.get_loss(name)
    ty, tp = torch.from_numpy(np.asarray(y)), torch.from_numpy(p)
    got = tfn(ty, tp)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(y, p)),
                               atol=1e-5, rtol=1e-5)
    # bf16 predictions still compute in f32
    assert tfn(ty, tp.to(torch.bfloat16)).dtype == torch.float32
    per = losses.per_example(tfn)(ty, tp)
    assert per.shape == (B,)
    np.testing.assert_allclose(
        per.numpy(), np.asarray(jax_losses.per_example(jfn)(y, p)),
        atol=1e-5, rtol=1e-5)


def make_params(rng):
    """The JAX params pytree (a list of layer dicts, one with BatchNorm
    stats) and the port's path → tensor dict in the same leaf order."""
    jp = [{"kernel": rng.standard_normal((4, 3)), "bias": rng.standard_normal(3)},
          {"scale": 1 + 0.1 * rng.standard_normal(3),
           "offset": rng.standard_normal(3),
           "stats": {"mean": rng.standard_normal(3),
                     "var": rng.random(3) + 0.5}},
          {"kernel": rng.standard_normal((3, 2))}]
    jp = [{k: (np.float32(v) if not isinstance(v, dict) else
               {kk: np.float32(vv) for kk, vv in v.items()})
           for k, v in layer.items()} for layer in jp]
    port = {}
    for i, layer in enumerate(jp):
        for k in sorted(layer):
            if isinstance(layer[k], dict):
                for kk in sorted(layer[k]):
                    port[f"{i}/{k}/{kk}"] = torch.tensor(layer[k][kk])
            else:
                port[f"{i}/{k}"] = torch.tensor(layer[k])
    return jp, port


VARIANTS = {
    "defaults": dict(steps=4),
    "schedule_clip": dict(steps=5, learning_rate=0.02,
                          lr_schedule="warmup_cosine", total_steps=5,
                          gradient_clip_norm=0.5),
    "accumulate": dict(steps=6, learning_rate=0.02,
                       lr_schedule={"name": "cosine", "alpha": 0.1},
                       total_steps=3, gradient_accumulation=2),
}
NAMES = ["sgd", "adam", "adamw", "adagrad", "adadelta", "rmsprop", "nadam",
         "adamax", "lamb", "lion"]


def run_both(spec, steps, seed=0, **kw):
    rng = np.random.default_rng(seed)
    jparams, port = make_params(rng)
    jtx, jstate = jax_opt.build(spec if isinstance(spec, str)
                                else jax_opt.Optimizer(spec.name,
                                                       **spec.hyper),
                                jparams, **kw)
    jupdate = jax.jit(jtx.update)  # one compile instead of eager cond
    ttx, tstate = optimizers.build(spec, port, **kw)
    plist = list(port.values())
    for _ in range(steps):
        grads = [rng.standard_normal(p.shape).astype(np.float32)
                 for p in plist]
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams), grads)
        updates, jstate = jupdate(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tupdates, tstate = ttx.update([torch.from_numpy(g) for g in grads],
                                      tstate, plist)
        optimizers.apply_updates(plist, tupdates)
        for want, got in zip(jax.tree_util.tree_leaves(jparams), plist):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name, variant):
    kw = dict(VARIANTS[variant])
    run_both(name, kw.pop("steps"), seed=NAMES.index(name), **kw)


@pytest.mark.parametrize("spec", [
    optimizers.SGD(0.05, momentum=0.9, nesterov=True),
    optimizers.RMSprop(0.01, rho=0.8, momentum=0.5),
    optimizers.Adam(0.01, beta_1=0.8, epsilon=1e-3),
    optimizers.Optimizer("lion", learning_rate=1e-3, weight_decay=0.1),
], ids=["sgd_nesterov", "rmsprop_momentum", "adam_hyper", "lion_decay"])
def test_keras_constructors_match_optax(spec):
    run_both(spec, 4, seed=11)


def test_schedules_match_optax():
    for spec, kw in (("warmup_cosine", {}),
                     ({"name": "warmup_cosine", "warmup_steps": 3,
                       "end_value": 1e-4, "init_value": 1e-3}, {}),
                     ({"name": "cosine", "alpha": 0.2}, {})):
        got = optimizers.get_schedule(spec, 0.05, total_steps=12)
        want = jax_opt.get_schedule(spec, 0.05, total_steps=12)
        for count in range(15):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-5, atol=1e-9)
    assert optimizers.get_schedule("constant", 0.05) == 0.05
    assert optimizers.get_schedule(None, 0.05) == 0.05
    with pytest.raises(ValueError, match="decay_steps"):
        optimizers.get_schedule("cosine", 0.05)
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        optimizers.get_schedule("step", 0.05, 10)
    with pytest.raises(ValueError, match="gradient_accumulation"):
        optimizers.build("adam", {"w": torch.zeros(2)},
                         gradient_accumulation=0)
