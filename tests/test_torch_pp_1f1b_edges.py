"""The edge cases of ``pipeline_1f1b`` (``distkeras_tpu_torch/parallel/
pipeline.py``) against the JAX package's, as ``tests/test_parallelism.py
:: test_pipeline_1f1b_toy_grads_match_autodiff`` takes them: fewer
microbatches than stages (M = 2 < n = 4, on 4 gloo CPU ranks: the ring
is mostly bubble, and most ticks carry nothing), and the one-stage
"ring" (n = 1, M = 3, in this process with no mesh).  The loss and the
head's gradient (rtol 1e-5), each stage's gradient and stage 0's input
cotangent (atol 1e-4) equal JAX's on the same toy stages and inputs
(``torch_ranks.toy_inputs``); ``pipeline_apply`` at n = 1 runs the
microbatches in turn.
"""

import functools

import numpy as np
import pytest
import torch

import torch_ranks as tr
from distkeras_tpu_torch.parallel import pipeline_1f1b, pipeline_apply
from test_torch_pp_schedules import jax_1f1b_case

torch.set_num_threads(1)

FEW = dict(which="1f1b", n=4, m=2, micro_b=2, d=4, seed=13)
ONE = dict(which="1f1b", n=1, m=3, micro_b=2, d=4, seed=14)


@functools.lru_cache(maxsize=None)
def jax_results(name):
    return jax_1f1b_case({"few": FEW, "one": ONE}[name])


@pytest.fixture(scope="module")
def few(tmp_path_factory):
    group = tr.Ranks(4, {"cases": [{"name": "few", "kind": "pipeline",
                                    **FEW}]},
                     tmp_path_factory.mktemp("pp_1f1b_few"), timeout=120)
    jax_results("few")
    jax_results("one")
    return sorted((r["few"] for r in group.results()),
                  key=lambda r: r["stage"])


def one_stage():
    inp = {k: torch.as_tensor(v) for k, v in tr.toy_inputs(ONE).items()}
    return pipeline_1f1b(tr.toy_stage, inp["ws"][0], inp["x"],
                         inp["labels"], tr.toy_head_loss,
                         {"scale": inp["scale"]}), inp


def test_fewer_microbatches_than_stages(few):
    loss, dstage, dhead, dx = jax_results("few")
    n = FEW["n"]
    np.testing.assert_allclose(few[-1]["loss"], loss[n - 1], rtol=1e-5)
    np.testing.assert_allclose(few[-1]["dhead"], dhead[n - 1], rtol=1e-5)
    for s, r in enumerate(few):
        np.testing.assert_allclose(r["dw"], dstage[s], atol=1e-4,
                                   err_msg=f"stage {s}")
    np.testing.assert_allclose(few[0]["dx"], dx[0], atol=1e-4)


def test_fewer_microbatches_send_only_what_they_carry(few):
    """Each rank sends M activations on unless it is the last and M f32
    cotangents back unless it is the first: no bubble tick moves data."""
    one = FEW["micro_b"] * FEW["d"] * 4
    for s, r in enumerate(few):
        _, sent = r["comm"]["ppermute"]
        assert sent == one * FEW["m"] * ((s < FEW["n"] - 1) + (s > 0))


def test_one_stage_ring(few):
    (loss, dstage, dhead, dx), _ = one_stage()
    want = jax_results("one")
    np.testing.assert_allclose(float(loss), want[0][0], rtol=1e-5)
    np.testing.assert_allclose(dstage.numpy(), want[1][0], atol=1e-4)
    np.testing.assert_allclose(float(dhead["scale"]), want[2][0], rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), want[3][0], atol=1e-4)


def test_one_stage_gpipe_is_the_stages_in_turn():
    """``pipeline_apply`` with no mesh: the stage on each microbatch, in
    f32, and autograd through it."""
    inp = {k: torch.as_tensor(v) for k, v in tr.toy_inputs(ONE).items()}
    w = inp["ws"][0].clone().requires_grad_()
    out = pipeline_apply(tr.toy_stage, w, inp["x"])
    want = tr.toy_stage(w, inp["x"])
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    g, = torch.autograd.grad((out * inp["ct"]).sum(), w)
    g_want, = torch.autograd.grad((want * inp["ct"]).sum(), w)
    torch.testing.assert_close(g, g_want, rtol=1e-6, atol=1e-6)
