"""The port's counterpart of ``__graft_entry__.py``
(``distkeras_tpu_torch/dryrun.py``): ``entry()`` and
``dryrun_multichip(n)`` on CPU ranks over gloo.

``dryrun_multichip(4)`` starts its own coordinated job of 4 ranks and runs
the JAX function's four parts at its shapes and factorizations (the ADAG
SPMD round; ``ParallelTransformerLM`` over (data, seq, model) with an MoE
layer, then Ulysses with FSDP; ``PipelineTransformerLM`` under GPipe;
1F1B); the ranks' part also runs as a case of tests/torch_ranks.py on 2
ranks.  Every rank ends with finite losses, the same on every rank of a
part, and loads no JAX.  (tests/test_torch_isolation.py runs ``python -m
distkeras_tpu_torch.dryrun 2 cpu``.)
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _three_factors as jax_three_factors
from distkeras_tpu_torch import dryrun

import torch_ranks as tr

torch.set_num_threads(1)

PARTS = ("transformer", "ulysses_fsdp", "pipeline_gpipe", "pipeline_1f1b")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return tr.Ranks(2, {"cases": [{"name": "d", "kind": "dryrun"}]},
                    tmp_path_factory.mktemp("dryrun"), timeout=180)


def check_ranks(ranks, n):
    dp, sp, tp = jax_three_factors(n)
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["device"] == "cpu"
        assert res["factors"]["transformer"] == [dp, sp, tp]
        assert np.isfinite(res["adag"]).all() and len(res["adag"]) == 1
        for part in PARTS:
            assert np.isfinite(res[part]), part
            assert res[part] == ranks[0][part], part  # one loss a part
        assert res["adag"] == ranks[0]["adag"]


def test_dryrun_multichip_runs_on_four_ranks():
    result = dryrun.dryrun_multichip(4, "cpu", timeout=180)
    assert result["n_devices"] == 4 and len(result["ranks"]) == 4
    check_ranks(result["ranks"], 4)
    assert result["ranks"][0]["factors"]["pipeline"] == [2, 2]
    # the ranks load no JAX (this test process has, for the references)
    assert all(r["modules"] == [] for r in result["ranks"])


def test_the_dryrun_part_of_two_ranks(two):
    ranks = [r["d"] for r in two.results()]
    check_ranks(ranks, 2)
    assert ranks[0]["factors"] == {"transformer": [2, 1, 1],
                                   "pipeline": [1, 2], "1f1b": [1, 2]}


def test_three_factors_is_the_jax_function():
    for n in range(1, 33):
        assert dryrun._three_factors(n) == jax_three_factors(n), n


def test_entry_is_the_flagship_forward_on_the_device():
    fn, (x,) = dryrun.entry(device="cpu")
    assert x.shape == (8, 784) and x.device.type == "cpu"
    y = fn(x)
    assert y.shape == (8, 10) and torch.isfinite(y).all()
    np.testing.assert_allclose(y.sum(-1).detach().numpy(), 1.0, rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.entry()


def test_the_main_refuses_bad_arguments(capsys):
    assert dryrun.main([]) == 2 and dryrun.main(["two"]) == 2
    assert "usage: python -m distkeras_tpu_torch.dryrun" in (
        capsys.readouterr().err)
