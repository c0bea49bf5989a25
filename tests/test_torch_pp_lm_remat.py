"""``PipelineTransformerLM`` with ``remat=True`` under the 1F1B schedule
on (2, 2, 2) ('data', 'stage', 'model'), across 8 gloo CPU ranks against
the JAX class's program on the same mesh (the rules and helpers of
``tests/test_torch_pp_lm_gpipe.py``); the same ranks round-trip the
numpy tree through ``load_jax_params`` and ``gather_params``.  Without
ranks: the loader's refusals, the ``schedule`` refusal (JAX's message)
and ``bubble_fraction`` against the JAX class at several M and n.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import torch_ranks as tr
from distkeras_tpu.parallel.pp_transformer import (
    PipelineTransformerLM as JaxPLM)
from distkeras_tpu_torch.parallel import (Mesh, PipelineTransformerLM,
                                          load_jax_params)
from distkeras_tpu_torch.parallel.transformer import _jax_leaves
from test_torch_pp_lm_gpipe import (TINY, check_gradients, check_losses,
                                    check_shapes, port_shapes, seed_of,
                                    start_ranks)

torch.set_num_threads(1)

CASES = {"1f1b_remat_2x2x2": ((2, 2, 2), dict(
    num_microbatches=2, schedule="1f1b", remat=True), 8)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return start_ranks(CASES, tmp_path_factory, roundtrip=True)


@pytest.mark.parametrize("name", CASES)
def test_step_one_gradients_match_jax_per_parameter(ranks, name):
    check_gradients(ranks, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_three_adam_steps_match_jax(ranks, name):
    check_losses(ranks, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_shards_and_bubble_match_jax(ranks, name):
    check_shapes(ranks, CASES, name)


def test_weights_round_trip_on_every_rank(ranks):
    name = "1f1b_remat_2x2x2"
    want = dict(_jax_leaves(tr.lm_tree(port_shapes((2, 2, 2)),
                                       seed_of(name))))
    for res in ranks[name]:
        got = dict(_jax_leaves(res["roundtrip"]))
        assert list(got) == list(want)
        for n, w in want.items():
            np.testing.assert_array_equal(got[n], w, err_msg=n)
        assert set(res["roundtrip"]["layers"]) == {
            "b1", "b2", "ln1", "ln2", "w1", "w2", "wk", "wo", "wq", "wv"}


def unbound_lm(shape=(2, 2, 2)):
    mesh = Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object)
                .reshape(shape), ("data", "stage", "model")[:len(shape)])
    return PipelineTransformerLM(**TINY, mesh=mesh, compute_dtype="float32",
                                 model_axis="model" if len(shape) == 3
                                 else None)


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen"])
def test_loader_refuses_a_wrong_tree(fault):
    lm = unbound_lm()
    tree = tr.lm_tree(lm._shapes(), 0)
    if fault == "missing":
        del tree["layers"]["wq"]
        match = r"missing \['layers\.wq'\], unexpected \[\]"
    elif fault == "extra":
        tree["layers"]["wz"] = tree["layers"]["wq"]
        match = r"missing \[\], unexpected \['layers\.wz'\]"
    else:
        tree["layers"]["w1"] = tree["layers"]["w1"][:1]
        match = r"parameter layers\.w1: shape \(1, 2, 16, 32\)"
    with pytest.raises(ValueError, match=match):
        load_jax_params(lm, tree)


def test_schedule_refusal_is_jax_s():
    mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                   ("data", "stage"))
    with pytest.raises(ValueError) as jax_err:
        JaxPLM(**TINY, mesh=mesh, schedule="interleaved")
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        PipelineTransformerLM(**TINY, mesh=Mesh(
            device="cpu", axis_names=("data", "stage")),
            schedule="interleaved")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("m,n", [(2, 4), (8, 4), (3, 1), (4, 2)])
def test_bubble_fraction_is_jax_s(schedule, m, n):
    mesh = JaxMesh(np.array(jax.devices()[:n]).reshape(1, n),
                   ("data", "stage"))
    want = JaxPLM(**TINY, mesh=mesh, num_microbatches=m, schedule=schedule,
                  compute_dtype=jnp.float32).bubble_fraction()
    port = unbound_lm((1, n))
    port.num_microbatches, port.schedule = m, schedule
    assert port.bubble_fraction() == pytest.approx(want, rel=1e-12)
