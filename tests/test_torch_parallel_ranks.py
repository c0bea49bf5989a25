"""``ParallelTransformerLM`` across 8 gloo CPU ranks against the JAX LM on
the same mesh of 8 CPU devices (``tests/conftest.py``).

The ranks start once for the file (``torch_ranks``, one group a mesh
size, all at once) and run its cases, each from one numpy-seeded weight
tree and batch, at f32.  This file: (2, 2, 2) dense, ring attention,
GQA, a sliding window and RoPE; (1, 2, 2) Ulysses with the kv-head repeat
(``Hkv % sp != 0``).  ``tests/test_torch_parallel_ranks_moe.py`` runs the
MoE cases with these helpers.  Each rank's step-1 gradients, summed by the train step's rule
(``grad_axes``) and gathered (``gather_params``), must equal JAX's
global gradients per parameter (1e-5 of the tensor's largest element;
the f32 sums in other orders read at most 2.8e-6), its step-1
loss JAX's, and the losses of three Adam steps (epsilon 1e-4, the parity
rule of ``tests/test_torch_train.py``) JAX's within rtol 2e-4, as
``tests/test_parallel_transformer.py:61`` holds its meshes.  Every rank
holds the same losses, and its shards have the JAX local shapes.
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
from distkeras_tpu.parallel.transformer import ParallelTransformerLM as JaxLM
from distkeras_tpu_torch.parallel import Mesh, ParallelTransformerLM
from distkeras_tpu_torch.parallel.transformer import _jax_leaves

torch.set_num_threads(1)

TINY = dict(vocab_size=32, seq_len=16, d_model=16, num_heads=4,
            num_layers=2, mlp_dim=32)
BATCH, LR, STEPS = 4, 1e-2, 3
#: name: (mesh shape, the LM's knobs on top of TINY)
CASES = {
    "dense_ring_gqa_window_rope": ((2, 2, 2), dict(
        num_kv_heads=2, attention_window=6, positional="rope")),
    "ulysses_kv_repeat": ((1, 2, 2), dict(
        num_heads=8, d_model=32, num_kv_heads=2, sp_impl="ulysses",
        positional="rope")),
}


def seed_of(name):
    return sum(map(ord, name))


def start_ranks(cases, tmp_path_factory):
    """Each case's rank results by name: one group of ranks a mesh size,
    all started at once, the JAX programs computed while they run."""
    by_size = {}
    for name, (shape, knobs) in cases.items():
        by_size.setdefault(int(np.prod(shape)), []).append(
            {"name": name, "kind": "lm", "shape": list(shape),
             "cfg": {**TINY, **knobs}, "seed": seed_of(name),
             "batch": BATCH, "lr": LR, "steps": STEPS})
    groups = [tr.Ranks(n, {"cases": specs},
                       tmp_path_factory.mktemp(f"lm_ranks{n}"), timeout=180)
              for n, specs in by_size.items()]
    for name, (shape, knobs) in cases.items():
        jax_results(name, shape, tuple(sorted(knobs.items())))
    return {name: [res[name] for res in g.results()]
            for g in groups for name in g.results()[0]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return start_ranks(CASES, tmp_path_factory)


def local_shapes(mesh, specs, params):
    """Each leaf's shard shape on the first device of the JAX mesh."""
    placed = jax.device_put(params, jax.tree_util.tree_map(
        lambda s: jax.sharding.NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
    return {n: tuple(a.addressable_shards[0].data.shape)
            for n, a in _jax_leaves(placed)}


@functools.lru_cache(maxsize=None)
def jax_results(name, shape, knobs):
    """The JAX LM's step-1 loss and global gradients, local shard shapes
    and three Adam losses on the mesh ``shape`` of CPU devices."""
    cfg = {**TINY, **dict(knobs)}
    mesh = JaxMesh(np.array(jax.devices()[:int(np.prod(shape))])
                   .reshape(shape), ("data", "seq", "model"))
    lm = JaxLM(**cfg, mesh=mesh, compute_dtype=jnp.float32)
    tree = tr.lm_tree(ParallelTransformerLM(
        **cfg, mesh=Mesh(device="cpu"))._shapes(), seed_of(name))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks, labels = tr.lm_batch(cfg, BATCH, seed_of(name) + 1)
    specs, bs = lm.param_specs(), P("data", "seq")
    grad_fn = _compat.shard_map(
        jax.value_and_grad(lm._loss), mesh=mesh,
        in_specs=(specs, bs, bs), out_specs=(P(), specs))
    tx = optax.adam(LR, eps=1e-4)

    @jax.jit
    def step(params, opt_state):  # one program: gradients and the update
        loss, grads = grad_fn(params, toks, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates), opt_state

    opt_state, losses = tx.init(params), []
    for i in range(STEPS):
        loss, grads, new_params, opt_state = step(params, opt_state)
        if i == 0:
            out = {"loss": float(loss),
                   "grads": dict(_jax_leaves(jax.device_get(grads))),
                   "local": local_shapes(mesh, specs, params)}
        params = new_params
        losses.append(float(loss))
    out["losses"] = losses
    return out


def want_of(cases, name):
    shape, knobs = cases[name]
    return jax_results(name, shape, tuple(sorted(knobs.items())))


def check_gradients(ranks, cases, name):
    want = want_of(cases, name)
    got = dict(_jax_leaves(ranks[name][0]["grads"]))
    assert list(got) == list(want["grads"])
    for pname, jg in want["grads"].items():
        jg = np.asarray(jg)
        np.testing.assert_allclose(got[pname], jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max() + 1e-9,
                                   err_msg=pname)
    for res in ranks[name]:
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5)


def check_losses(ranks, cases, name):
    want = want_of(cases, name)["losses"]
    losses = [res["losses"] for res in ranks[name]]
    assert all(ls == losses[0] for ls in losses)  # every rank holds it
    np.testing.assert_allclose(losses[0], want, rtol=2e-4)
    assert losses[0][-1] < losses[0][0]


def check_shapes(ranks, cases, name):
    want = want_of(cases, name)["local"]
    for res in ranks[name]:
        assert res["local_shapes"] == want


@pytest.mark.parametrize("name", CASES)
def test_step_one_gradients_match_jax_per_parameter(ranks, name):
    check_gradients(ranks, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_three_adam_steps_match_jax(ranks, name):
    check_losses(ranks, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_shards_have_the_jax_local_shapes(ranks, name):
    check_shapes(ranks, CASES, name)


def test_a_dense_stack_routes_nothing(ranks):
    for name in CASES:
        assert all(res["dropped"] == [] for res in ranks[name])
