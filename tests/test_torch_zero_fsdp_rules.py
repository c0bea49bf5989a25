"""The spec rules and the update rule's norms of ZeRO-1 / FSDP
(``distkeras_tpu_torch/parallel/train_step.py``) against the JAX
package's:
- ``shard_specs_over_axis``, ``zero_shard_specs`` and
  ``opt_partition_specs`` give JAX's specs on JAX's own fallback cases
  (``tests/test_zero.py:113-127``, ``tests/test_fsdp.py:128-140``), with
  no ranks; an unknown axis raises JAX's message;
- the norms: JAX runs a ZeRO step's update under plain ``jit`` on the
  logical whole tensors, so ``clip_by_global_norm`` takes the norm of the
  whole model.  ``chain(clip_by_global_norm(c), adam)`` under ZeRO on
  ``ParallelTransformerLM`` over (2, 1, 2), 4 gloo CPU ranks, at a ``c``
  that binds every step (the clipped gradients come out near Adam's
  epsilon, where the update follows their scale), matches
  ``optax.chain(optax.clip_by_global_norm(c), optax.adam)`` under JAX's
  ZeRO within rtol 2e-4 on three losses, and so does FSDP; a clip 5%
  wider misses them by more than five times that band, so a norm taken
  over a rank's slices alone (some 30% short at dp = 2) could not pass.
"""

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
from distkeras_tpu.parallel import train_step as jts
from distkeras_tpu.parallel.transformer import ParallelTransformerLM as JaxLM
from distkeras_tpu_torch.core import optimizers
from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                          opt_partition_specs,
                                          shard_specs_over_axis,
                                          zero_shard_specs)
from distkeras_tpu_torch.parallel.train_step import build_train_step

torch.set_num_threads(1)

TINY = dict(vocab_size=32, seq_len=16, d_model=16, num_heads=2,
            num_layers=2, mlp_dim=32)
CLIP_SHAPE, BATCH, LR, EPS, STEPS, SEED = (2, 1, 2), 8, 1e-2, 1e-4, 3, 17
CLIP = 1e-3


def jax_mesh(shape=(4, 1, 2)):
    return JaxMesh(np.array(jax.devices()[:int(np.prod(shape))])
                   .reshape(shape), ("data", "seq", "model"))


def port_mesh(shape=(4, 1, 2)):
    return Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object)
                .reshape(shape))


def norm(spec):
    """A spec as a tuple without its trailing Nones."""
    s = list(spec)
    while s and s[-1] is None:
        s.pop()
    return tuple(s)


def jax_clip_losses():
    mesh = jax_mesh(CLIP_SHAPE)
    lm = JaxLM(**TINY, mesh=mesh, compute_dtype=jnp.float32)
    tree = tr.lm_tree(ParallelTransformerLM(
        **TINY, mesh=Mesh(device="cpu"))._shapes(), SEED)
    params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                               lm.param_specs(),
                               is_leaf=lambda x: isinstance(x, P)))
    tx = optax.chain(optax.clip_by_global_norm(CLIP),
                     optax.adam(LR, eps=EPS))
    opt_state, step = lm.compile_train_step(tx, params, zero=True)
    toks, labels = tr.lm_batch(TINY, BATCH, SEED + 1)
    sh = lm.batch_sharding()
    toks, labels = jax.device_put(toks, sh), jax.device_put(labels, sh)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, toks, labels)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def clipped(tmp_path_factory):
    case = {"kind": "zero", "lm": "plm", "shape": list(CLIP_SHAPE),
            "cfg": TINY, "seed": SEED, "batch": BATCH, "lr": LR,
            "eps": EPS, "steps": STEPS}
    group = tr.Ranks(4, {"cases": [
        {**case, "name": "clip", "clip": CLIP, "modes": ["zero", "fsdp"]},
        {**case, "name": "wider", "clip": 1.05 * CLIP, "modes": ["zero"]}]},
        tmp_path_factory.mktemp("zero_clip"), timeout=120)
    want = jax_clip_losses()
    return group.results(), want


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_a_norm_rule_under_zero_takes_whole_model_norms(clipped, mode):
    ranks, want = clipped
    for res in ranks:
        assert res["clip"][mode]["losses"] == ranks[0]["clip"][mode]["losses"]
        np.testing.assert_allclose(res["clip"][mode]["losses"], want,
                                   rtol=2e-4)


def test_the_band_sees_a_five_percent_norm_error(clipped):
    ranks, want = clipped
    got = np.asarray(ranks[0]["wider"]["zero"]["losses"][1:])
    gap = np.abs(got - want[1:]) / np.abs(want[1:])
    assert gap.max() > 5 * 2e-4, gap  # five times the band


def test_zero_shard_specs_fallback():
    shapes = {"a": (6, 5), "b": (8, 6), "c": (), "d": (6, 8)}
    specs = {"a": (), "b": (None, "model"), "c": (), "d": ()}
    want = jts.zero_shard_specs(
        {"a": P(), "b": P(None, "model"), "c": P(), "d": P()},
        {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()},
        jax_mesh(), "data")
    got = zero_shard_specs(specs, shapes, port_mesh(), "data")
    assert {k: norm(v) for k, v in got.items()} == {
        k: norm(v) for k, v in want.items()}
    assert norm(got["d"]) == (None, "data")


def test_shard_specs_over_axis_on_params():
    shapes = {"wq": (16, 16), "ln": (6,), "b": (8,)}
    specs = {"wq": (None, "model"), "ln": (), "b": ()}
    want = jts.shard_specs_over_axis(
        {"wq": P(None, "model"), "ln": P(), "b": P()},
        {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()},
        jax_mesh(), "data")
    got = shard_specs_over_axis(specs, shapes, port_mesh(), "data")
    assert {k: norm(v) for k, v in got.items()} == {
        k: norm(v) for k, v in want.items()}
    assert got["wq"] == ("data", "model") and got["ln"] == ()


def test_opt_partition_specs_and_their_zero_slices():
    """Adam's moments inherit their parameters' specs and its counter
    replicates, as JAX's key-path rule gives them; ``zero_shard_specs``
    then slices them as JAX's does."""
    shapes = {"a": (6, 5), "b": (8, 6), "d": (6, 8)}
    specs = {"a": (), "b": (None, "model"), "d": ()}
    jspecs = {"a": P(), "b": P(None, "model"), "d": P()}
    jparams = {k: jnp.zeros(v) for k, v in shapes.items()}
    w_sp, w_shapes = jts.opt_partition_specs(optax.adam(1e-2), jparams,
                                             jspecs)
    w_zero = jts.zero_shard_specs(w_sp, w_shapes, jax_mesh(), "data")
    params = {k: torch.zeros(v) for k, v in shapes.items()}
    g_sp, g_shapes = opt_partition_specs(optimizers.adam(1e-2), params,
                                         specs)
    g_zero = zero_shard_specs(g_sp, g_shapes, port_mesh(), "data")
    for got, want in ((g_sp, w_sp), (g_zero, w_zero)):
        (count, mu, nu), rest = got
        assert count == () and norm(want[0].count) == () and rest == ()
        for mine, theirs in ((mu, want[0].mu), (nu, want[0].nu)):
            assert [norm(s) for s in mine] == [norm(theirs[k])
                                               for k in sorted(theirs)]
    assert [tuple(t.shape) for t in g_shapes[0][1]] == list(shapes.values())


@pytest.mark.parametrize("kind", ["zero_axis", "fsdp_axis"])
def test_an_unknown_axis_raises_jax_s_message(kind):
    mesh = jax_mesh()
    lm = JaxLM(**TINY, mesh=mesh, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as want:
        jts.build_train_step(mesh, lm._loss, lm.param_specs(),
                             P("data", "seq"), optax.adam(1e-2), params,
                             **{kind: "nope"})
    with pytest.raises(ValueError) as got:
        build_train_step(port_mesh(), lambda *a: None, optimizers.adam(1e-2),
                         {"w": torch.zeros(2)}, **{kind: "nope"})
    assert str(got.value) == str(want.value)


def test_mesh_squares_feed_the_norm_rules():
    """Under ``mesh_squares`` a norm rule sums each leaf's squares through
    the step's reduction (here: leaf p held as p + 1 equal slices), and
    ``masked`` hands its inner rule the picked leaves' positions; outside
    it the norms are the tensors' own."""
    reduce = lambda sq, pos: [s * (p + 1) for s, p in zip(sq, pos)]
    g = [torch.ones(4), torch.ones(4)]
    clip = optimizers.clip_by_global_norm(1.0)
    with optimizers.mesh_squares(reduce, 2):
        out, _ = clip.update(g, (), None)
    torch.testing.assert_close(out[0], g[0] / np.sqrt(12.0))
    out, _ = clip.update(g, (), None)
    torch.testing.assert_close(out[0], g[0] / np.sqrt(8.0))
    masked = optimizers.masked(clip, [False, True])
    with optimizers.mesh_squares(reduce, 2):
        out, _ = masked.update(g, masked.init(g), g)
    torch.testing.assert_close(out[1], g[1] / np.sqrt(8.0))
    torch.testing.assert_close(out[0], g[0])
    trust = optimizers.scale_by_trust_ratio()
    p = [torch.full((4,), 2.0), torch.full((4,), 3.0)]
    with optimizers.mesh_squares(reduce, 2):
        out, _ = trust.update(g, (), p)
    # the ratio of the two norms: the reduction scales both alike
    torch.testing.assert_close(out[1], g[1] * 3.0)
