"""``PipelineTransformerLM`` under GPipe on the 3-D mesh (2, 2, 2)
('data', 'stage', 'model'): two layers a stage, each with Megatron
tensor parallelism inside the stage, M = 2, across 8 gloo CPU ranks
against the JAX class on the same mesh, by the rules and helpers of
``tests/test_torch_pp_lm_gpipe.py`` (gradients per parameter, the
step-1 loss, three Adam losses, local shapes and the bubble fraction).
"""

import pytest
import torch

from test_torch_pp_lm_gpipe import (check_gradients, check_losses,
                                    check_shapes, start_ranks)

torch.set_num_threads(1)

CASES = {"gpipe_2x2x2_tp": ((2, 2, 2), dict(num_microbatches=2), 8)}


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
