"""ZeRO-1 and FSDP of ``distkeras_tpu_torch/parallel/train_step.py`` on
``ParallelTransformerLM`` across 8 gloo CPU ranks, mesh (4, 1, 2) ('data',
'seq', 'model'), against the port's own unsharded step and the JAX
package's ``zero=True`` / ``fsdp=True`` steps on the same mesh of 8 CPU
devices (``tests/test_zero.py``, ``tests/test_fsdp.py``), from one
numpy-seeded weight tree and batch, three steps of Adam (epsilon 1e-4,
the parity rule of ``tests/test_torch_train.py``):
- the losses equal the port's unsharded run's within rtol 1e-6 (JAX's own
  band, ``tests/test_zero.py:66``) and JAX's ZeRO/FSDP losses within
  rtol 2e-4 (``tests/test_zero.py:67``);
- every Adam moment's local shape, and under FSDP every parameter's
  shape at rest, is JAX's addressable shard shape, leaf by leaf;
- the final parameters, gathered, equal the unsharded run's within JAX's
  band (``tests/test_fsdp.py:97-98``);
- a ZeRO step moves its updated slices in one all-gather, an FSDP step
  gathers its parameters in one all-gather and its gradients in one
  reduce-scatter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_ranks as tr
from distkeras_tpu.parallel.transformer import ParallelTransformerLM as JaxLM
from distkeras_tpu_torch.parallel import Mesh, ParallelTransformerLM
from distkeras_tpu_torch.parallel.transformer import _jax_leaves

torch.set_num_threads(1)

TINY = dict(vocab_size=32, seq_len=16, d_model=16, num_heads=2,
            num_layers=2, mlp_dim=32)
SHAPE, BATCH, LR, EPS, STEPS, SEED = (4, 1, 2), 8, 1e-2, 1e-4, 3, 7
MODES = ("zero", "fsdp")


def tree():
    return tr.lm_tree(ParallelTransformerLM(
        **TINY, mesh=Mesh(device="cpu"))._shapes(), SEED)


def shard_shapes(tree_):
    return {n: tuple(a.addressable_shards[0].data.shape)
            for n, a in _jax_leaves(tree_)}


@functools.lru_cache(maxsize=None)
def jax_run(mode):
    """JAX's losses, Adam first-moment and parameter shard shapes."""
    mesh = JaxMesh(np.array(jax.devices()[:8]).reshape(SHAPE),
                   ("data", "seq", "model"))
    lm = JaxLM(**TINY, mesh=mesh, compute_dtype=jnp.float32)
    params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, tree()),
        jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                               lm.param_specs(),
                               is_leaf=lambda x: isinstance(x, P)))
    opt_state, step = lm.compile_train_step(
        optax.adam(LR, eps=EPS), params, **{mode: True})
    toks, labels = tr.lm_batch(TINY, BATCH, SEED + 1)
    sh = lm.batch_sharding()
    toks, labels = jax.device_put(toks, sh), jax.device_put(labels, sh)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, toks, labels)
        losses.append(float(loss))
    return {"losses": losses, "mu": shard_shapes(opt_state[0].mu),
            "params": shard_shapes(params)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = tr.Ranks(8, {"cases": [{
        "name": "plm", "kind": "zero", "lm": "plm", "shape": list(SHAPE),
        "cfg": TINY, "seed": SEED, "batch": BATCH, "lr": LR, "eps": EPS,
        "steps": STEPS, "modes": ["plain", *MODES]}]},
        tmp_path_factory.mktemp("zero_fsdp"), timeout=180)
    for mode in MODES:
        jax_run(mode)
    return [r["plm"] for r in group.results()]


@pytest.mark.parametrize("mode", MODES)
def test_losses_equal_the_unsharded_port(ranks, mode):
    for res in ranks:
        np.testing.assert_allclose(res[mode]["losses"],
                                   res["plain"]["losses"], rtol=1e-6)
        assert res[mode]["losses"] == ranks[0][mode]["losses"]


@pytest.mark.parametrize("mode", MODES)
def test_losses_match_jax(ranks, mode):
    np.testing.assert_allclose(ranks[0][mode]["losses"],
                               jax_run(mode)["losses"], rtol=2e-4)


@pytest.mark.parametrize("mode", MODES)
def test_moments_have_the_jax_shard_shapes(ranks, mode):
    want = list(jax_run(mode)["mu"].values())
    plain = ranks[0]["plain"]["moment_shapes"]
    for res in ranks:
        assert res[mode]["moment_shapes"] == want
    # the embedding's moments: (32, 16) whole without ZeRO, (8, 16) with
    names = list(jax_run(mode)["mu"])
    i = names.index("embed")
    assert plain[i] == (32, 16) and want[i] == (8, 16)


def test_fsdp_parameters_rest_in_the_jax_shard_shapes(ranks):
    want = jax_run("fsdp")["params"]
    for res in ranks:
        assert res["fsdp"]["param_shapes"] == want
        assert res["zero"]["param_shapes"] == res["plain"]["param_shapes"]


@pytest.mark.parametrize("mode", MODES)
def test_final_parameters_equal_the_unsharded_run(ranks, mode):
    for res in ranks:
        got = dict(_jax_leaves(res[mode]["final"]))
        want = dict(_jax_leaves(res["plain"]["final"]))
        for n, w in want.items():
            np.testing.assert_allclose(got[n], w, rtol=2e-5, atol=1e-6,
                                       err_msg=n)


def test_collectives_of_a_step(ranks):
    for res in ranks:
        zero, fsdp = res["zero"]["comm"], res["fsdp"]["comm"]
        assert zero["all_gather"][0] == STEPS
        assert fsdp["all_gather"][0] == fsdp["reduce_scatter"][0] == STEPS
        assert "reduce_scatter" not in zero
