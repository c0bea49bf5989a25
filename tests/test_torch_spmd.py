"""The port's SPMD engine (``distkeras_tpu_torch/parallel/spmd.py``)
against the JAX package's ``SPMDEngine`` on the virtual CPU mesh of
tests/conftest.py.

One numpy-drawn weight set goes into both packages (``set_weights`` and
``load_jax_weights``), the same rows go through both ``shape_epoch_data``,
and one epoch of at least 3 rounds (a wrap-padded tail with fully padded
batches included) runs on each.  For every algorithm (adag, downpour,
dynsgd, aeasgd, eamsgd, local) and N in {1, 2, 4} workers, at f32, the
per-round losses and the final center params agree within rtol 1e-5,
atol 1e-6 (read: 2.4e-7 absolute at most: both compute in f32 in other
orders).  With a BatchNormalization layer the statistics are synced into
every worker and the center (0 in every delta) and the same comparison
holds within rtol 1e-4, atol 2e-5: the layer's batch variance differs
from XLA's in the last bits (first-round loss 9e-7 apart), and the
running variance carries that through the rounds.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.core import layers as jl
from distkeras_tpu.core import optimizers as jopt
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu.parallel import get_mesh as jax_mesh
from distkeras_tpu.parallel.spmd import SPMDEngine as JaxEngine
from distkeras_tpu.parallel.spmd import shape_epoch_data as jax_shape
from distkeras_tpu_torch.core import layers as pl
from distkeras_tpu_torch.core import optimizers as popt
from distkeras_tpu_torch.core.model import Sequential
from distkeras_tpu_torch.data.pipeline import round_stream
from distkeras_tpu_torch.parallel import (DistState, SPMDEngine, get_mesh,
                                          shape_epoch_data)

torch.set_num_threads(1)

D, C, ROWS, WINDOW, BATCH = 12, 4, 200, 3, 8
LOSS = "categorical_crossentropy"
TOL = dict(rtol=1e-5, atol=1e-6)
BN_TOL = dict(rtol=1e-4, atol=2e-5)
ALGOS = ("adag", "downpour", "dynsgd", "aeasgd", "eamsgd", "local")
ALPHA = {"aeasgd": 0.05, "eamsgd": 0.05}


def optimizer(pkg, algo, bn=False):
    """The trainers' worker optimizers: adam for the adaptive family and
    the local trainers, SGD for AEASGD, Nesterov SGD for EAMSGD.  Before
    a BatchNormalization layer the bias of the Dense layer has a gradient
    of exactly 0 in exact arithmetic, and f32 rounding noise on either
    side, which Adam at Keras's epsilon of 1e-7 turns into steps of ~lr:
    the BatchNorm cases take Adam at epsilon 1e-3 (as the zoo tests take
    1e-4)."""
    if algo == "aeasgd":
        return "sgd"
    if algo == "eamsgd":
        return pkg.SGD(learning_rate=0.02, momentum=0.9, nesterov=True)
    if bn:
        return pkg.Adam(learning_rate=0.01, epsilon=1e-3)
    return "adam"


def models(bn=False, dropout=False):
    def stack(m):
        mid = [m.BatchNormalization()] if bn else []
        mid += [m.Dropout(0.3)] if dropout else []
        return [m.Dense(16, activation="relu"), *mid,
                m.Dense(C, activation="softmax")]
    jm = JaxSequential(stack(jl), input_shape=(D,), compute_dtype="float32")
    pm = Sequential(stack(pl), input_shape=(D,), compute_dtype="float32",
                    device="cpu")
    return jm, pm


def weights_and_data(jm, seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    params = jm.init(jax.random.PRNGKey(0))
    ws = [(0.3 * rng.standard_normal(w.shape)).astype(np.float32)
          if w.ndim > 1 else np.asarray(w) for w in jm.get_weights(params)]
    x = rng.standard_normal((rows, D)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, rows)]
    return jm.set_weights(params, ws), ws, x, y


def run_jax(algo, n, bn=False, epochs=1):
    jm, _ = models(bn)
    params, _, x, y = weights_and_data(jm)
    engine = JaxEngine(jm, LOSS, optimizer(jopt, algo, bn), jax_mesh(n),
                       algo, WINDOW, 0.01, alpha=ALPHA.get(algo))
    state = engine.init_state(jax.random.PRNGKey(0), (D,),
                              initial_params=params)
    xb, yb, mb, _ = jax_shape(x, y, n, WINDOW, BATCH)
    rngs = engine.worker_rngs(1)
    losses = []
    for _ in range(epochs):
        state, ls = engine.run_epoch(state, xb, yb, mb, rngs)
        losses.append(np.asarray(ls))
    return (np.concatenate(losses),
            [np.asarray(v) for v in
             jax.tree_util.tree_leaves(jax.device_get(state.center))])


def port_engine(algo, n, bn=False, dropout=False):
    _, pm = models(bn, dropout)
    engine = SPMDEngine(pm, LOSS, optimizer(popt, algo, bn),
                        get_mesh(n, devices=["cpu"] * n), algo, WINDOW, 0.01,
                        alpha=ALPHA.get(algo))
    return engine


def run_port(algo, n, bn=False, epochs=1):
    jm, _ = models(bn)
    _, ws, x, y = weights_and_data(jm)
    engine = port_engine(algo, n, bn)
    state = engine.init_state(initial_params=ws)
    xb, yb, mb, _ = shape_epoch_data(x, y, n, WINDOW, BATCH)
    rngs = engine.worker_rngs(1)
    losses = []
    for _ in range(epochs):
        state, ls = engine.run_epoch(state, xb, yb, mb, rngs)
        losses.append(ls.numpy())
    return np.concatenate(losses), state


def check_against_jax(algo, n, bn, tol, epochs=1):
    jl_, jc = run_jax(algo, n, bn, epochs)
    pl_, state = run_port(algo, n, bn, epochs)
    assert len(pl_) == len(jl_) >= 3
    np.testing.assert_allclose(pl_, jl_, **tol)
    for (k, got), want in zip(state.center.items(), jc):
        np.testing.assert_allclose(got.numpy(), want, err_msg=k, **tol)
    return state


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_engine_matches_jax(algo, n):
    state = check_against_jax(algo, n, False, TOL)
    assert state.round_idx == -(-ROWS // (n * WINDOW * BATCH))


@pytest.mark.parametrize("algo", ALGOS)
def test_engine_with_batchnorm_matches_jax(algo):
    state = check_against_jax(algo, 2, True, BN_TOL)
    stats = [k for k in state.center if "/stats/" in k]
    assert stats == ["1/stats/mean", "1/stats/var"]
    for k in stats:
        for local in state.local:
            if algo == "local":  # independent training: stats stay apart
                assert not torch.equal(local[k], state.center[k])
            else:  # synced: the statistics add 0 to every delta
                assert torch.equal(local[k], state.center[k])


def test_two_epochs_carry_the_optimizer_state():
    """Adam's count and moments persist across rounds and epochs: a
    second epoch matches JAX too."""
    check_against_jax("adag", 2, False, TOL, epochs=2)


def test_each_worker_keeps_its_own_optimizer_state():
    engine = port_engine("adag", 2)
    _, _, x, y = weights_and_data(models()[0])
    state = engine.init_state()
    assert all(torch.equal(p, state.center[k]) for local in state.local
               for k, p in local.items())
    xb, yb, mb, _ = shape_epoch_data(x, y, 2, WINDOW, BATCH)
    state, _ = engine.run_round(state, xb[0], yb[0], mb[0],
                                engine.worker_rngs(0))
    (count0, mu0, _), (count1, mu1, _) = [s[0] for s in state.opt_state]
    assert count0 == count1 == WINDOW
    assert not torch.equal(mu0[0], mu1[0])


def test_run_round_and_streaming_equal_run_epoch():
    _, _, x, y = weights_and_data(models()[0])
    xb, yb, mb, rounds = shape_epoch_data(x, y, 2, WINDOW, BATCH)
    results = []
    for mode in ("epoch", "round", "stream"):
        engine = port_engine("dynsgd", 2)
        state, rngs = engine.init_state(), engine.worker_rngs(3)
        if mode == "epoch":
            state, losses = engine.run_epoch(state, xb, yb, mb, rngs)
            losses = losses.numpy()
        elif mode == "round":
            losses = []
            for r in range(rounds):
                state, loss = engine.run_round(state, xb[r], yb[r], mb[r],
                                               rngs)
                losses.append(loss.item())
            losses = np.asarray(losses, np.float32)
        else:
            state, losses = engine.run_epoch_streaming(
                state, round_stream(x, y, 2, WINDOW, BATCH), rngs)
        results.append((losses, state))
    (l0, s0) = results[0]
    for losses, state in results[1:]:
        np.testing.assert_array_equal(losses, l0)
        for k in s0.center:
            assert torch.equal(state.center[k], s0.center[k])


def test_a_round_leaves_its_input_state_as_it_was():
    """The rules and the round build new tensors: the state passed in
    (e.g. one kept for a checkpoint) keeps its values."""
    engine = port_engine("aeasgd", 2)
    _, _, x, y = weights_and_data(models()[0])
    xb, yb, mb, _ = shape_epoch_data(x, y, 2, WINDOW, BATCH)
    state = engine.init_state()
    kept = {k: v.clone() for k, v in state.center.items()}
    kept_local = [{k: v.clone() for k, v in p.items()} for p in state.local]
    new, _ = engine.run_round(state, xb[0], yb[0], mb[0],
                              engine.worker_rngs(0))
    for k in kept:
        assert torch.equal(state.center[k], kept[k])
        assert not torch.equal(new.center[k], kept[k])
        for p, q in zip(state.local, kept_local):
            assert torch.equal(p[k], q[k])


def test_dropout_generators_per_worker_and_round():
    """Dropout masks come from one generator per (seed, worker, round):
    the same seed repeats a run to the bit, another seed differs."""
    _, _, x, y = weights_and_data(models()[0])
    xb, yb, mb, _ = shape_epoch_data(x, y, 2, WINDOW, BATCH)

    def run(seed):
        engine = port_engine("local", 2, dropout=True)
        state = engine.init_state(torch.Generator().manual_seed(0), (D,))
        state, losses = engine.run_epoch(state, xb, yb, mb,
                                         engine.worker_rngs(seed))
        return losses.numpy(), engine.worker_rngs(seed)

    a, rngs = run(5)
    b, _ = run(5)
    c, _ = run(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len(set(rngs)) == 2


def test_engine_refusals():
    _, pm = models()
    mesh = get_mesh(2, devices=["cpu"] * 2)
    # packed engines build (A5c; run in tests/test_torch_packing.py) and
    # refuse an epoch without segment ids
    packed = SPMDEngine(pm, LOSS, "adam", mesh, "adag", packed=True)
    with pytest.raises(ValueError, match="needs segment ids"):
        packed.run_epoch(packed.init_state(), None, None, None, None)
    with pytest.raises(ValueError, match="unknown algorithm"):
        SPMDEngine(pm, LOSS, "adam", mesh, "hogwild")
    with pytest.raises(ValueError, match="alpha"):
        SPMDEngine(pm, LOSS, "sgd", mesh, "aeasgd")
    with pytest.raises(ValueError, match="mesh on meta"):
        SPMDEngine(pm, LOSS, "adam", get_mesh(1, devices=["meta"]), "adag")
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        SPMDEngine(pm, LOSS, "adam", get_mesh(2, devices=["cpu", "meta"]),
                   "adag")
    engine = SPMDEngine(pm, LOSS, "adam", mesh, "adag")
    with pytest.raises(RuntimeError, match="init_state"):
        engine.run_round(None, np.zeros((5, 2, 1, D), np.float32),
                         np.zeros((5, 2, 1, C), np.float32),
                         np.ones((5, 2, 1), np.float32), [0, 0])
    state = engine.init_state()
    with pytest.raises(ValueError, match="segment ids"):
        engine.run_epoch(state, None, None, None, None, sb=np.zeros(1))
    with pytest.raises(ValueError, match="expects 3"):
        engine.run_epoch_streaming(
            state, iter([(np.zeros(1),) * 4]), engine.worker_rngs(0))


def test_put_state_owns_its_tensors():
    engine = port_engine("adag", 2)
    state = engine.init_state()
    placed = engine.put_state(DistState(
        state.center, state.local, state.opt_state, np.int64(4)))
    assert placed.round_idx == 4 and isinstance(placed.round_idx, int)
    for k, v in placed.center.items():
        assert torch.equal(v, state.center[k])
        assert v.data_ptr() != state.center[k].data_ptr()
