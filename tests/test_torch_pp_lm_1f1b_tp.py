"""``PipelineTransformerLM`` under the 1F1B schedule on the 3-D mesh
(2, 2, 2) ('data', 'stage', 'model'), M = 2: the hand-built backward
through Megatron-split stages, across 8 gloo CPU ranks against the JAX
class's 1F1B program on the same mesh, by the rules and helpers of
``tests/test_torch_pp_lm_gpipe.py``.
"""

import pytest
import torch

from test_torch_pp_lm_gpipe import (check_gradients, check_losses,
                                    check_shapes, start_ranks)

torch.set_num_threads(1)

CASES = {"1f1b_2x2x2_tp": ((2, 2, 2), dict(num_microbatches=2,
                                           schedule="1f1b"), 8)}


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
