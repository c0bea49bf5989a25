"""ZeRO-1 and FSDP composed with the 1F1B pipeline: the port's
``PipelineTransformerLM`` on (2, 4) ('data', 'stage'), M = 4, across 8
gloo CPU ranks, at the configuration of ``tests/test_zero.py ::
test_zero_composes_with_pipeline_1f1b`` (vocab 32, seq 8, d_model 8, 2
heads, 4 layers, mlp 16, batch 8, two Adam steps at epsilon 1e-4), from
one numpy-seeded weight tree.  The losses equal the port's unsharded
1F1B run's within rtol 1e-6 and JAX's ``zero=True`` / ``fsdp=True`` runs'
within rtol 2e-4; every Adam moment and, under FSDP, every parameter at
rest has JAX's addressable shard shape: a layer leaf is (n, lps, ...)
with the stage on its first dim, so the data axis takes the first other
dim that it divides.
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
from distkeras_tpu.parallel.pp_transformer import (
    PipelineTransformerLM as JaxPLM)
from distkeras_tpu_torch.parallel import Mesh, PipelineTransformerLM
from distkeras_tpu_torch.parallel.transformer import _jax_leaves

torch.set_num_threads(1)

CFG = dict(vocab_size=32, seq_len=8, d_model=8, num_heads=2, num_layers=4,
           mlp_dim=16)
KNOBS = dict(num_microbatches=4, schedule="1f1b")
SHAPE, BATCH, LR, EPS, STEPS, SEED = (2, 4), 8, 1e-2, 1e-4, 2, 3
MODES = ("zero", "fsdp")


def tree():
    mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(SHAPE),
                ("data", "stage"))
    return tr.lm_tree(PipelineTransformerLM(
        **CFG, mesh=mesh, compute_dtype="float32")._shapes(), SEED)


def shard_shapes(tree_):
    return {n: tuple(a.addressable_shards[0].data.shape)
            for n, a in _jax_leaves(tree_)}


@functools.lru_cache(maxsize=None)
def jax_run(mode):
    mesh = JaxMesh(np.array(jax.devices()[:8]).reshape(SHAPE),
                   ("data", "stage"))
    lm = JaxPLM(**CFG, **KNOBS, mesh=mesh, compute_dtype=jnp.float32)
    params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, tree()),
        jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                               lm.param_specs(),
                               is_leaf=lambda x: isinstance(x, P)))
    opt_state, step = lm.compile_train_step(
        optax.adam(LR, eps=EPS), params, **{mode: True})
    toks, labels = tr.lm_batch(CFG, BATCH, SEED + 1)
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
        "name": "pp", "kind": "zero", "lm": "pp", "shape": list(SHAPE),
        "cfg": CFG, "knobs": KNOBS, "seed": SEED, "batch": BATCH,
        "lr": LR, "eps": EPS, "steps": STEPS,
        "modes": ["plain", *MODES]}]},
        tmp_path_factory.mktemp("zero_fsdp_pp"), timeout=180)
    for mode in MODES:
        jax_run(mode)
    return [r["pp"] for r in group.results()]


@pytest.mark.parametrize("mode", MODES)
def test_losses_equal_the_unsharded_1f1b_run(ranks, mode):
    for res in ranks:
        np.testing.assert_allclose(res[mode]["losses"],
                                   res["plain"]["losses"], rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_losses_match_jax(ranks, mode):
    np.testing.assert_allclose(ranks[0][mode]["losses"],
                               jax_run(mode)["losses"], rtol=2e-4)


@pytest.mark.parametrize("mode", MODES)
def test_moments_have_the_jax_shard_shapes(ranks, mode):
    want = list(jax_run(mode)["mu"].values())
    for res in ranks:
        assert res[mode]["moment_shapes"] == want
    # wq (4 stages, 1 layer, 8, 8): the data axis on its third dim
    i = list(jax_run(mode)["mu"]).index("layers.wq")
    assert want[i] == (1, 1, 4, 8)


def test_fsdp_parameters_rest_in_the_jax_shard_shapes(ranks):
    want = jax_run("fsdp")["params"]
    for res in ranks:
        assert res["fsdp"]["param_shapes"] == want


@pytest.mark.parametrize("mode", MODES)
def test_final_parameters_equal_the_unsharded_run(ranks, mode):
    for res in ranks:
        got = dict(_jax_leaves(res[mode]["final"]))
        for n, w in _jax_leaves(res["plain"]["final"]):
            np.testing.assert_allclose(got[n], w, rtol=2e-5, atol=1e-6,
                                       err_msg=n)
