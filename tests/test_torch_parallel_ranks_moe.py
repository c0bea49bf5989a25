"""The MoE ``ParallelTransformerLM`` across gloo CPU ranks against the
JAX LM on the same mesh of CPU devices, with the helpers and rules of
``tests/test_torch_parallel_ranks.py`` (step-1 gradients per parameter,
the step-1 loss, three Adam losses at rtol 2e-4, the local shard shapes):
- (2, 2, 2) MoE top-1 at the default capacity factor (2.0), where tokens
  drop;
- (2, 1, 2) MoE top-2 with the fused cross-entropy.

On the same mesh the per-shard capacities, and so the drops, are the JAX
ones, so these cases hold dropped tokens too (the JAX test compares
meshes at capacity factor 8.0 because capacities differ across meshes).
"""

import pytest
import torch

from test_torch_parallel_ranks import (check_gradients, check_losses,
                                       check_shapes, start_ranks)

torch.set_num_threads(1)

CASES = {
    "moe_top1_dropping": ((2, 2, 2), dict(moe_layers=(1,), num_experts=8)),
    "moe_top2_fused_ce": ((2, 1, 2), dict(
        moe_layers=(0,), num_experts=4, router_top_k=2, fused_ce=True)),
}


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
def test_shards_have_the_jax_local_shapes(ranks, name):
    check_shapes(ranks, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_moe_cases_route_and_drop_as_configured(ranks, name):
    """At the default capacity factor (2.0) the top-1 case has
    ceil(2 · T_loc / E) = 2 slots an expert for 8 tokens over 8 experts a
    rank, and some rank drops choices; top-2 over 4 experts has 4 slots an
    expert for 8 tokens' 16 choices."""
    dropped = [d for res in ranks[name] for d in res["dropped"]]
    assert len(dropped) == len(ranks[name])  # one MoE layer a rank
    if name == "moe_top1_dropping":
        assert max(dropped) > 0
    assert all(0.0 <= d < 1.0 for d in dropped)
