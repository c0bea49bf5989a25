"""The pipeline schedules of ``distkeras_tpu_torch/parallel/pipeline.py``
on 4 gloo CPU ranks against the JAX package's on 4 of the 8 virtual CPU
devices (``tests/conftest.py``), on JAX's own toy stages ``tanh(h @ w)``
and head ``sum((scale · y - labels)²)`` (``tests/test_parallelism.py:
307-514``), inputs drawn with numpy (``torch_ranks.toy_inputs``).

``pipeline_apply`` (GPipe) runs M = 8 = 2n distinct microbatches, so a
backward that paired one microbatch's cotangent with another's would
show in the gradients: its output equals JAX's within 1e-5, and each
stage's weight gradient and stage 0's input gradient (against one seeded
output cotangent) JAX's within 1e-4, the JAX test's bands.
``pipeline_1f1b`` at M = 6 > n: the loss and the head's gradient on the
last stage (rtol 1e-5), each stage's gradient and stage 0's input
cotangent (atol 1e-4).  ``tests/test_torch_pp_1f1b_edges.py`` has the
edge cases M < n and n = 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_ranks as tr
from distkeras_tpu.parallel import _compat
from distkeras_tpu.parallel.pipeline import pipeline_1f1b as jax_1f1b
from distkeras_tpu.parallel.pipeline import pipeline_apply as jax_apply

torch.set_num_threads(1)

CASES = {"apply_m8": dict(which="apply", n=4, m=8, micro_b=2, d=8, seed=11),
         "1f1b_m6": dict(which="1f1b", n=4, m=6, micro_b=2, d=4, seed=12)}


def jax_stage(w, h):
    return jnp.tanh(h @ w)


def jax_head_loss(hp, y, lbl):
    return jnp.sum((hp["scale"] * y - lbl) ** 2)


def jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("stage",))


def jax_apply_case(case):
    """JAX's (output, stage weight gradients, input gradient) against the
    case's output cotangent."""
    inp = tr.toy_inputs(case)
    fn = _compat.shard_map(
        lambda w, xm: jax.lax.psum(
            jax_apply(jax_stage, w[0], xm, axis_name="stage"), "stage"),
        mesh=jax_mesh(case["n"]), in_specs=(P("stage"), P()),
        out_specs=P())

    @jax.jit
    def run(ws, x, ct):
        out, vjp = jax.vjp(fn, ws, x)
        return (out,) + vjp(ct)

    return [np.asarray(a) for a in run(inp["ws"], inp["x"], inp["ct"])]


def jax_1f1b_case(case):
    """JAX's (loss, dstage, dhead, dx), each stacked over the stages."""
    inp = tr.toy_inputs(case)

    def local(w, h_, xm, lm_):
        loss, dstage, dhead, dx = jax_1f1b(
            jax_stage, w[0], xm, lm_, jax_head_loss, h_, axis_name="stage")
        lead = lambda t: jax.tree_util.tree_map(lambda v: v[None], t)
        return loss[None], lead(dstage), lead(dhead), lead(dx)

    fn = jax.jit(_compat.shard_map(
        local, mesh=jax_mesh(case["n"]),
        in_specs=(P("stage"), P(), P(), P()),
        out_specs=(P("stage"),) * 4))
    loss, dstage, dhead, dx = fn(inp["ws"], {"scale": jnp.asarray(
        inp["scale"])}, inp["x"], inp["labels"])
    return (np.asarray(loss), np.asarray(dstage),
            np.asarray(dhead["scale"]), np.asarray(dx))


@functools.lru_cache(maxsize=None)
def jax_results(name):
    case = CASES[name]
    return (jax_apply_case(case) if case["which"] == "apply"
            else jax_1f1b_case(case))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = tr.Ranks(4, {"cases": [{"name": k, "kind": "pipeline", **c}
                                   for k, c in CASES.items()]},
                     tmp_path_factory.mktemp("pp_schedules"), timeout=120)
    for name in CASES:  # while the ranks run
        jax_results(name)
    res = group.results()
    return {name: sorted((r[name] for r in res), key=lambda r: r["stage"])
            for name in CASES}


def test_pipeline_apply_output_matches_jax(ranks):
    out, _, _ = jax_results("apply_m8")
    got = ranks["apply_m8"]
    np.testing.assert_allclose(got[-1]["out"], out, atol=1e-5)
    for r in got[:-1]:  # zeros but on the last stage
        assert not r["out"].any()


def test_pipeline_apply_gradients_match_jax(ranks):
    _, dws, dx = jax_results("apply_m8")
    got = ranks["apply_m8"]
    for s, r in enumerate(got):
        np.testing.assert_allclose(r["dw"], dws[s], atol=1e-4,
                                   err_msg=f"stage {s}")
    np.testing.assert_allclose(got[0]["dx"], dx, atol=1e-4)


def test_pipeline_apply_transfers(ranks):
    """Each rank posts one transfer a tick in which a microbatch leaves
    or reaches it: stage s at ticks s - 1 .. s + M - 1 forward (M at the
    two ends, M + 1 between) and the same backward; it sends M
    activations on unless it is the last and M cotangents back unless it
    is the first."""
    case = CASES["apply_m8"]
    m, n, one = case["m"], case["n"], case["micro_b"] * case["d"] * 4
    for s, r in enumerate(ranks["apply_m8"]):
        calls, sent = r["comm"]["ppermute"]
        assert calls == 2 * (m + (0 < s < n - 1)), s
        assert sent == one * m * ((s < n - 1) + (s > 0)), s


@pytest.mark.parametrize("part", ["loss", "dstage", "dhead", "dx"])
def test_pipeline_1f1b_matches_jax(ranks, part):
    loss, dstage, dhead, dx = jax_results("1f1b_m6")
    got = ranks["1f1b_m6"]
    n = CASES["1f1b_m6"]["n"]
    if part == "loss":
        np.testing.assert_allclose(got[-1]["loss"], loss[n - 1], rtol=1e-5)
        assert all(r["loss"] == 0.0 for r in got[:-1])
    elif part == "dhead":
        np.testing.assert_allclose(got[-1]["dhead"], dhead[n - 1],
                                   rtol=1e-5)
        assert all(r["dhead"] == 0.0 for r in got[:-1])
    elif part == "dstage":
        for s, r in enumerate(got):
            np.testing.assert_allclose(r["dw"], dstage[s], atol=1e-4,
                                       err_msg=f"stage {s}")
    else:
        np.testing.assert_allclose(got[0]["dx"], dx[0], atol=1e-4)
        assert all(not r["dx"].any() for r in got[1:])
