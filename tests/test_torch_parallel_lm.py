"""The port's one-card ParallelTransformerLM against the JAX package.

Both models run the same numpy-seeded weights (drawn for the JAX tree by
its ``init`` rules, LayerNorm scales and biases perturbed, and copied in
through ``load_jax_params``) on a (1, 1, 1) ('data', 'seq', 'model') mesh: the
JAX class under its ``shard_map`` on one CPU device, the port on the CPU.
At f32 the forward logits agree to 1e-5, the loss to rtol 1e-5, every
parameter's gradient to 1e-4 of its largest element, and the losses of
three ``optax.adam`` steps (the port's ``core.optimizers.adam``) to rtol
1e-5, over learned/RoPE positions, the ring and Ulysses schedules, GQA
and MQA, sliding windows, ``ring_block_k`` and ``remat``.

On that mesh the JAX fused CE takes its XLA fallback under ``shard_map``
(``ops/fused_ce.py:172-175``), so JAX's two CE routes are one function
and this file compares the model, not the kernel (tests/test_torch_fused_ce
.py holds the kernels' plain versions against the Pallas kernels): the
port's fused and plain routes are both held against that one function.  JAX's
``ring_block_k`` fails to trace inside the LM on this jax (a scan-carry
varying-axes mismatch in ``ring.py``), so the port's ``ring_block_k``
(the same math in finer chunks) is held against the JAX LM without it,
and against JAX ``ring_self_attention(block_k=)`` at the block level.
``remat`` changes what is recomputed, not the function, so the port's
``remat`` is likewise held against the JAX LM without it (which keeps the
JAX programs quick to compile).
The blocks (``tp_mlp``, ``tp_self_attention``, ``ring_self_attention``,
``ulysses_self_attention``) are compared on their own too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from distkeras_tpu.parallel import _compat
from distkeras_tpu.parallel import ring as jax_ring
from distkeras_tpu.parallel import tp as jax_tp
from distkeras_tpu.parallel import ulysses as jax_ulysses
from distkeras_tpu.parallel.transformer import ParallelTransformerLM as JaxLM
from distkeras_tpu_torch.core import optimizers
from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                          load_jax_params, ring,
                                          ring_self_attention, tp,
                                          ulysses_self_attention)
from distkeras_tpu_torch.parallel.transformer import _jax_leaves

torch.set_num_threads(1)

TINY = dict(vocab_size=48, seq_len=16, d_model=16, num_heads=4,
            num_layers=2, mlp_dim=32)
BATCH = 4
LR = 1e-2
# name: (the JAX model's knobs, what the port adds on top)
CONFIGS = {
    "learned_ring": ({}, {}),
    "rope_ulysses_gqa_window": (dict(positional="rope", sp_impl="ulysses",
                                     num_kv_heads=2, attention_window=5), {}),
    "learned_ulysses_mqa_window_remat": (dict(
        sp_impl="ulysses", num_kv_heads=1, attention_window=6),
        dict(remat=True)),
    "rope_ring_window_block_k_remat": (dict(
        positional="rope", attention_window=3, rope_theta=500.0,
        rope_scale=2.0), dict(ring_block_k=4, remat=True)),
}
BS = P("data", "seq")


def jax_mesh(axes=("data", "seq", "model")):
    return JaxMesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)),
                   axes)


def port_mesh():
    return Mesh(device="cpu")


def batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TINY["vocab_size"],
                        (BATCH, TINY["seq_len"])).astype(np.int32)
    return toks, (toks + 1) % TINY["vocab_size"]


def numpy_tree(lm, seed):
    """Weights for the JAX model's tree, drawn with numpy by the JAX init's
    rules, with LayerNorm scales and biases perturbed so that their
    gradients are not those of ones and zeros."""
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        z = rng.standard_normal(shape)
        if leaf.startswith("ln"):
            z = 1.0 + 0.1 * z
        elif leaf.startswith("b"):
            z = 0.1 * z
        elif leaf in ("embed", "pos"):
            z = 0.02 * z
        else:
            z = z / np.sqrt(shape[-2])
        return z.astype(np.float32)

    def walk(t, prefix=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(t)]
        return draw(prefix[:-1], t)  # a shape
    return walk(lm._shapes_and_specs()[0])


@functools.lru_cache(maxsize=None)
def jax_results(name, dtype="float32"):
    """The JAX model's weights, logits, loss, gradients (in leaf order)
    and three Adam losses, computed once per configuration."""
    mesh = jax_mesh()
    lm = JaxLM(**TINY, **CONFIGS[name][0], mesh=mesh,
               compute_dtype=getattr(jnp, dtype))
    tree = numpy_tree(lm, seed=len(name))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    toks, labels = batch()
    specs = lm.param_specs()

    forward, seen = lm._forward, {}

    def keep_logits(p, t):
        out = forward(p, t)
        seen["logits"] = out[0]
        return out
    lm._forward = keep_logits  # the loss's own forward hands out its logits

    def loss_and_logits(p, t, lab):
        return lm._loss(p, t, lab), seen["logits"]
    fn = jax.jit(_compat.shard_map(
        jax.value_and_grad(loss_and_logits, has_aux=True), mesh=mesh,
        in_specs=(specs, BS, BS),
        out_specs=((P(), P("data", "seq", None)), specs)))
    (loss, logits), grads = fn(params, toks, labels)
    out = dict(tree=tree, logits=np.asarray(logits), loss=float(loss),
               grads=[np.asarray(g) for g in
                      jax.tree_util.tree_leaves(jax.device_get(grads))])
    # the local step of build_train_step (value_and_grad, the optax update,
    # apply_updates), with the gradient program above compiled once
    tx = optax.adam(LR)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    opt_state, losses = tx.init(params), []
    for _ in range(3):
        (loss, _), grads = fn(params, toks, labels)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    out["losses"] = losses
    return out


def port_lm(name, fused, dtype="float32", **extra):
    jax_cfg, port_cfg = CONFIGS[name]
    return ParallelTransformerLM(**TINY, **jax_cfg, **port_cfg, **extra,
                                 mesh=port_mesh(), fused_ce=fused,
                                 compute_dtype=dtype)


def tensors(toks, labels):
    return torch.from_numpy(toks), torch.from_numpy(labels)


def port_steps(lm, params, n=3, **kw):
    opt_state, step = lm.compile_train_step(optimizers.adam(LR), params, **kw)
    toks, labels = tensors(*batch())
    losses = []
    for _ in range(n):
        params, opt_state, loss = step(params, opt_state, toks, labels)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_match_jax(name):
    want = jax_results(name)
    lm = port_lm(name, False)
    params = load_jax_params(lm, want["tree"])
    with torch.no_grad():
        logits = lm._forward(params, tensors(*batch())[0])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_jax(name, fused):
    want = jax_results(name)
    lm = port_lm(name, fused)
    params = load_jax_params(lm, want["tree"])
    loss = lm._loss(params, *tensors(*batch()))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    assert len(grads) == len(want["grads"])
    for pname, g, jg in zip(params, grads, want["grads"]):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max() + 1e-9,
                                   err_msg=pname)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("name", CONFIGS)
def test_three_adam_steps_match_jax(name, fused):
    want = jax_results(name)
    lm = port_lm(name, fused)
    losses = port_steps(lm, load_jax_params(lm, want["tree"]))
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]


def test_bf16_losses_within_a_band_of_jax():
    """bf16 compute: XLA keeps some bf16 roundings in f32 inside its
    fusions (``--xla_allow_excess_precision``) where the port rounds, so
    the two differ by bf16 noise; the mean loss over 64 tokens and its
    three Adam steps stay within 1e-2 (relative) of JAX's."""
    want = jax_results("learned_ring", "bfloat16")
    lm = port_lm("learned_ring", True, "bfloat16")
    params = load_jax_params(lm, want["tree"])
    np.testing.assert_allclose(lm._loss(params, *tensors(*batch())).item(),
                               want["loss"], rtol=1e-2)
    np.testing.assert_allclose(port_steps(lm, params), want["losses"],
                               rtol=1e-2)


def test_zero_and_fsdp_on_one_card_are_the_plain_step():
    want = jax_results("learned_ring")
    runs = []
    for kw in ({}, dict(zero=True), dict(fsdp=True)):
        lm = port_lm("learned_ring", True)
        runs.append(port_steps(lm, load_jax_params(lm, want["tree"]), **kw))
    assert runs[0] == runs[1] == runs[2]


def test_adam_is_optax_adam():
    rng = np.random.default_rng(5)
    params = [rng.standard_normal(s).astype(np.float32) for s in
              ((3, 4), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32)
              for p in params] for _ in range(3)]
    tx = optax.adam(1e-2)
    jp, state = [jnp.asarray(p) for p in params], None
    state = tx.init(jp)
    port = optimizers.adam(1e-2)
    tp_ = [torch.from_numpy(p.copy()) for p in params]
    pstate = port.init(tp_)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        pupd, pstate = port.update([torch.from_numpy(x) for x in g], pstate,
                                   tp_)
        optimizers.apply_updates(tp_, pupd)
    for a, b in zip(tp_, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the blocks on their own
# ---------------------------------------------------------------------------

def block_inputs(seed, hkv=2, h=4, s=16, d=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = lambda *shape: (rng.standard_normal(shape) / np.sqrt(shape[0])
                        ).astype(np.float32)
    return x, w(16, h * d), w(16, hkv * d), w(16, hkv * d), w(h * d, 16)


def test_tp_mlp_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w1, w2 = (rng.standard_normal(s).astype(np.float32) / 4
              for s in ((16, 32), (32, 16)))
    b1, b2 = (0.1 * rng.standard_normal(n).astype(np.float32)
              for n in (32, 16))
    fn = jax.jit(_compat.shard_map(
        lambda *a: jax_tp.tp_mlp(*a, axis_name="model",
                                 compute_dtype=jnp.float32),
        mesh=jax_mesh(), in_specs=(P("data", "seq", None), P(None, "model"),
                                   P("model"), P("model", None), P()),
        out_specs=P("data", "seq", None)))
    want = fn(x, w1, b1, w2, b2)
    got = tp.tp_mlp(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)),
                    compute_dtype=torch.float32, mesh=port_mesh())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("sp_impl", ["ring", "ulysses"])
def test_tp_self_attention_matches_jax(sp_impl):
    x, wq, wk, wv, wo = block_inputs(8)
    pos = np.arange(16)
    kw = dict(num_local_heads=4, head_dim=4, num_local_kv_heads=2,
              seq_axis="seq", causal=True, window=6, sp_impl=sp_impl)
    fn = jax.jit(_compat.shard_map(
        lambda *a: jax_tp.tp_self_attention(
            *a, compute_dtype=jnp.float32, rope_positions=jnp.asarray(pos),
            **kw),
        mesh=jax_mesh(),
        in_specs=(P("data", "seq", None),) + (P(None, "model"),) * 3
        + (P("model", None),), out_specs=P("data", "seq", None)))
    want = fn(x, wq, wk, wv, wo)
    got = tp.tp_self_attention(
        *(torch.from_numpy(a) for a in (x, wq, wk, wv, wo)),
        compute_dtype=torch.float32, rope_positions=torch.from_numpy(pos),
        mesh=port_mesh(), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def qkv(seed, hkv):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 16, n, 8)).astype(np.float32)
                 for n in (4, hkv, hkv))


@pytest.mark.parametrize("causal,block_k,window,hkv", [
    (True, None, None, 4), (True, 4, 5, 2), (False, 8, None, 1)])
def test_ring_self_attention_matches_jax(causal, block_k, window, hkv):
    q, k, v = qkv(9 + hkv, hkv)
    want = jax_ring.ring_self_attention(
        q, k, v, jax_mesh(("seq",)), "seq", causal, None, block_k, window)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = ring_self_attention(*t, Mesh(device="cpu", axis_names=("seq",)),
                              "seq", causal, None, block_k, window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    # and through autograd, against the port's plain attention
    from distkeras_tpu_torch.ops.attention import dot_product_attention
    r = torch.randn(got.shape, generator=torch.Generator().manual_seed(0))
    g1 = torch.autograd.grad((got * r).sum(), t)
    t2 = [a.detach().clone().requires_grad_() for a in t]
    g2 = torch.autograd.grad((dot_product_attention(
        *t2, causal=causal, window=window) * r).sum(), t2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_ulysses_self_attention_matches_jax():
    q, k, v = qkv(12, 2)
    want = jax_ulysses.ulysses_self_attention(
        q, k, v, jax_mesh(("seq",)), "seq", True, None, 7)
    got = ulysses_self_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 Mesh(device="cpu", axis_names=("seq",)),
                                 "seq", True, None, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# parameters, and what the slice refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_init_follows_the_jax_rules_and_tree(positional):
    jlm = JaxLM(**TINY, mesh=jax_mesh(), positional=positional)
    jtree = list(_jax_leaves(jax.device_get(jlm.init(jax.random.PRNGKey(0)))))
    lm = ParallelTransformerLM(**{**TINY, "vocab_size": 512},
                               mesh=port_mesh(), positional=positional)
    params = lm.init(torch.Generator().manual_seed(0))
    assert [n for n, _ in jtree] == list(params)
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        assert p.dtype == torch.float32 and p.requires_grad
        if leaf.startswith("ln"):
            assert bool((p == 1).all()), name
        elif leaf.startswith("b"):
            assert bool((p == 0).all()), name
        elif leaf in ("embed", "pos"):
            assert abs(p.std().item() - 0.02) < 0.004, name
        else:
            want = 1 / np.sqrt(p.shape[-2])
            assert abs(p.std().item() - want) < 0.2 * want, name
    assert lm.compute_dtype == torch.bfloat16
    assert lm.batch_sharding() == torch.device("cpu")


@pytest.mark.parametrize("bad", ["missing", "unexpected", "shape"])
def test_load_jax_params_checks_names_and_shapes(bad):
    tree = jax_results("learned_ring")["tree"]
    tree = {**tree, "layers": [dict(lp) for lp in tree["layers"]]}
    if bad == "missing":
        del tree["layers"][1]["wq"]
    elif bad == "unexpected":
        tree["extra"] = np.zeros(3, np.float32)
    else:
        tree["head"] = tree["head"][:, :-1]
    with pytest.raises(ValueError, match="missing|unexpected|shape"):
        load_jax_params(port_lm("learned_ring", True), tree)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1), (2, 1, 1)])
def test_a_mesh_axis_above_one_raises(shape):
    devices = np.array(["cpu"] * 2, dtype=object).reshape(shape)
    mesh = Mesh(devices)
    assert dict(mesh.shape) == dict(zip(("data", "seq", "model"), shape))
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        ParallelTransformerLM(**TINY, mesh=mesh)
    x = torch.zeros(1, 4, 16)
    w = torch.zeros(16, 16)
    axis = ("data", "seq", "model")[shape.index(2)]
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        tp.row_parallel_dense(x, w, axis_name=axis, mesh=mesh)


def test_moe_layers_and_a_ring_across_cards_raise():
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        ParallelTransformerLM(**TINY, mesh=port_mesh(), moe_layers=(1,))
    mesh = Mesh(np.array(["cpu"] * 2, dtype=object), axis_names=("seq",))
    q = torch.zeros(1, 4, 2, 4)
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        ring.ring_attention(q, q, q, "seq", mesh=mesh)


def test_the_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh()


@pytest.mark.parametrize("bad", [
    dict(num_kv_heads=3), dict(sp_impl="tree"), dict(positional="alibi"),
    dict(positional="rope", num_heads=16), dict(attention_window=0)])
def test_constructor_refuses_what_the_jax_class_refuses(bad):
    kw = {**TINY, **bad}
    with pytest.raises(ValueError):
        JaxLM(**kw, mesh=jax_mesh())
    with pytest.raises(ValueError):
        ParallelTransformerLM(**kw, mesh=port_mesh())
