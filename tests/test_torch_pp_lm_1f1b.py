"""``PipelineTransformerLM`` under the 1F1B schedule on (2, 4) ('data',
'stage') with M = 8 = 2n distinct microbatches (the regime where the
activation buffer of 2n - 1 inputs differs from GPipe's M, and where a
cotangent delivered to the wrong microbatch would show in the weights'
gradients), across 8 gloo CPU ranks against the JAX class's 1F1B
program on the same mesh, by the rules and helpers of
``tests/test_torch_pp_lm_gpipe.py``.
"""

import pytest
import torch

from test_torch_pp_lm_gpipe import (check_gradients, check_losses,
                                    check_shapes, start_ranks)

torch.set_num_threads(1)

CASES = {"1f1b_2x4_m8": ((2, 4), dict(num_microbatches=8,
                                      schedule="1f1b"), 16)}


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


def test_each_rank_sends_each_microbatch_once_each_way(ranks):
    """Over the one 1F1B step, a stage sends M activations on unless it
    is the last and M f32 cotangents back unless it is the first, each
    (B/dp/M, S, D) at f32."""
    for res in ranks["1f1b_2x4_m8"]:
        _, s = res["coords"]
        one = 16 // 2 // 8 * 16 * 16 * 4
        assert res["ppermute"]["bytes"] == one * 8 * ((s < 3) + (s > 0))
