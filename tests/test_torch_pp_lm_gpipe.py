"""``PipelineTransformerLM`` under GPipe across 8 gloo CPU ranks against
the JAX class on the same mesh of 8 CPU devices (``tests/conftest.py``),
at f32 and ``vocab 32, seq 16, d_model 16, 2 heads, 4 layers, mlp 32``,
from one numpy-seeded weight tree and batch (``torch_ranks.lm_tree``),
on the mesh (2, 4) ('data', 'stage') at M = 2: one layer a stage.

The rules of ``tests/test_torch_parallel_ranks.py``: each rank's step-1
gradients, summed by the train step's rule (``grad_axes``) and gathered,
equal JAX's per parameter within 1e-5 of the tensor's largest element;
the step-1 loss JAX's within rtol 1e-5; the losses of three Adam steps
(epsilon 1e-4) JAX's within rtol 2e-4; the shards have JAX's local
shapes (``addressable_shards``), and the bubble fraction is JAX's.  The
helpers serve the other ``tests/test_torch_pp_lm_*.py`` files, one JAX
program (a mesh and a schedule) a file, each compiling in ~10 s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_ranks as tr
from distkeras_tpu.parallel import _compat
from distkeras_tpu.parallel.pp_transformer import (
    PipelineTransformerLM as JaxPLM)
from distkeras_tpu_torch.parallel import Mesh, PipelineTransformerLM
from distkeras_tpu_torch.parallel.transformer import _jax_leaves

torch.set_num_threads(1)

TINY = dict(vocab_size=32, seq_len=16, d_model=16, num_heads=2,
            num_layers=4, mlp_dim=32)
LR, STEPS = 1e-2, 3
#: name: (mesh shape, the LM's knobs, batch)
CASES = {"gpipe_2x4_m2": ((2, 4), dict(num_microbatches=2), 8)}


def seed_of(name):
    return sum(map(ord, name))


def axis_names(shape):
    return ("data", "stage", "model")[:len(shape)]


def spec_of(name, cases, **extra):
    shape, knobs, batch = cases[name]
    return {"name": name, "kind": "pp_lm", "shape": list(shape),
            "cfg": TINY, "knobs": knobs, "seed": seed_of(name),
            "batch": batch, "lr": LR, "steps": STEPS, **extra}


def start_ranks(cases, tmp_path_factory, **extra):
    """Each case's rank results by name, the ranks started at once in one
    group of 8, the JAX programs computed while they run."""
    group = tr.Ranks(8, {"cases": [spec_of(n, cases, **extra)
                                   for n in cases]},
                     tmp_path_factory.mktemp("pp_lm"), timeout=180)
    for name in cases:
        jax_results(name, *key_of(cases, name))
    res = group.results()
    return {name: [r[name] for r in res] for name in cases}


def key_of(cases, name):
    shape, knobs, batch = cases[name]
    return shape, tuple(sorted(knobs.items())), batch


def jax_lm(shape, knobs):
    mesh = JaxMesh(np.array(jax.devices()[:int(np.prod(shape))])
                   .reshape(shape), axis_names(shape))
    kw = dict(knobs)
    if len(shape) == 3:
        kw["model_axis"] = "model"
    return JaxPLM(**TINY, **kw, mesh=mesh, compute_dtype=jnp.float32)


def port_shapes(shape):
    """The port's full leaf shapes on a mesh of ``shape`` (never bound)."""
    mesh = Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object)
                .reshape(shape), axis_names(shape))
    return PipelineTransformerLM(**TINY, mesh=mesh,
                                 compute_dtype="float32")._shapes()


def local_shapes(mesh, specs, params):
    """Each leaf's shard shape on the first device of the JAX mesh."""
    placed = jax.device_put(params, jax.tree_util.tree_map(
        lambda s: jax.sharding.NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
    return {n: tuple(a.addressable_shards[0].data.shape)
            for n, a in _jax_leaves(placed)}


@functools.lru_cache(maxsize=None)
def jax_results(name, shape, knobs, batch):
    """The JAX LM's step-1 loss and global gradients, local shard shapes,
    bubble fraction and three Adam losses, in one program a step."""
    lm = jax_lm(shape, dict(knobs))
    tree = tr.lm_tree(port_shapes(shape), seed_of(name))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks, labels = tr.lm_batch(TINY, batch, seed_of(name) + 1)
    specs = lm.param_specs()
    grads_of = (lm._local_loss_and_grads_1f1b if lm.schedule == "1f1b"
                else jax.value_and_grad(lm._local_loss))
    grad_fn = _compat.shard_map(
        grads_of, mesh=lm.mesh, in_specs=(specs, P("data"), P("data")),
        out_specs=(P(), specs))
    tx = optax.adam(LR, eps=1e-4)

    @jax.jit
    def step(params, opt_state):
        loss, grads = grad_fn(params, toks, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates), opt_state

    opt_state, losses = tx.init(params), []
    for i in range(STEPS):
        loss, grads, new_params, opt_state = step(params, opt_state)
        if i == 0:
            out = {"loss": float(loss),
                   "grads": dict(_jax_leaves(jax.device_get(grads))),
                   "local": local_shapes(lm.mesh, specs, params),
                   "bubble": lm.bubble_fraction()}
        params = new_params
        losses.append(float(loss))
    out["losses"] = losses
    return out


def want_of(cases, name):
    return jax_results(name, *key_of(cases, name))


def check_gradients(ranks, cases, name):
    want = want_of(cases, name)
    for res in ranks[name]:  # every rank gathers the same gradients
        got = dict(_jax_leaves(res["grads"]))
        assert list(got) == list(want["grads"])
        for pname, jg in want["grads"].items():
            jg = np.asarray(jg)
            np.testing.assert_allclose(got[pname], jg, rtol=0,
                                       atol=1e-5 * np.abs(jg).max() + 1e-9,
                                       err_msg=pname)
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)


def check_losses(ranks, cases, name):
    want = want_of(cases, name)["losses"]
    losses = [res["losses"] for res in ranks[name]]
    assert all(ls == losses[0] for ls in losses)  # every rank holds it
    np.testing.assert_allclose(losses[0], want, rtol=2e-4)
    assert losses[0][-1] < losses[0][0]


def check_shapes(ranks, cases, name):
    want = want_of(cases, name)
    for res in ranks[name]:
        assert res["local_shapes"] == want["local"]
        assert res["bubble"] == pytest.approx(want["bubble"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return start_ranks(CASES, tmp_path_factory)


@pytest.mark.parametrize("name", CASES)
def test_step_one_gradients_match_jax_per_parameter(ranks, name):
    check_gradients(ranks, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_three_adam_steps_match_jax(ranks, name):
    check_losses(ranks, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_shards_and_bubble_match_jax(ranks, name):
    check_shapes(ranks, CASES, name)
