"""The port's expert parallelism (``distkeras_tpu_torch/parallel/moe.py``)
and the MoE ``ParallelTransformerLM`` on one device against the JAX
package, on the CPU at f32.

- ``topk_routing``: dispatch, combine and the stats equal JAX's at k = 1
  and 2, with tokens dropped at small capacities and none at large ones;
  ``topk_slots`` (the index form) names exactly the slots that dispatch
  marks, with combine's weights; ``top1_routing`` and
  ``load_balance_loss`` (with its gradient) equal JAX's.
- ``moe_mlp`` on a one-device mesh: its output, stats and the gradients
  of every input of ``<y, c> + 0.1 · load_balance_loss(stats)`` equal the
  JAX function under ``shard_map`` (1e-5 of the largest element), at k = 1
  and 2, with and without drops; the index form equals the one-hot
  einsum form within 1e-6 of the largest element (output and gradients:
  their sums run in other orders).
- The MoE LM at (1, 1, 1): the tree's names and order are JAX's, the
  step-1 loss (rtol 1e-5) and every parameter's gradient (1e-5 of its
  largest element) equal JAX's, and so do three Adam losses (epsilon
  1e-4, the parity rule of ``tests/test_torch_train.py``; rtol 1e-5).
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

import torch_ranks as tr
from distkeras_tpu.parallel import _compat
from distkeras_tpu.parallel import moe as jax_moe
from distkeras_tpu.parallel.transformer import ParallelTransformerLM as JaxLM
from distkeras_tpu_torch.core import optimizers
from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                          load_jax_params, moe)
from distkeras_tpu_torch.parallel.transformer import _jax_leaves

torch.set_num_threads(1)


def logits_of(seed, t=32, e=4):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(
        np.float32) * 2.0


ROUTES = [(k, cap) for k in (1, 2) for cap in (3, 6, 40)]


@pytest.mark.parametrize("k,capacity", ROUTES)
def test_topk_routing_matches_jax(k, capacity):
    logits = logits_of(10 * k + capacity)
    jd, jc, js = jax_moe.topk_routing(jnp.asarray(logits), capacity, k)
    d, c, stats = moe.topk_routing(torch.from_numpy(logits), capacity, k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    for key in ("fraction", "prob"):
        np.testing.assert_allclose(stats[key].numpy(), np.asarray(js[key]),
                                   rtol=1e-6, atol=1e-7)
    kept = d.sum().item()
    assert kept <= 32 * k
    if capacity == 3:
        assert kept < 32 * k  # tokens drop at a small capacity
    if capacity == 40:
        assert kept == 32 * k


@pytest.mark.parametrize("k,capacity", ROUTES)
def test_topk_slots_are_the_dispatch_by_index(k, capacity):
    logits = torch.from_numpy(logits_of(10 * k + capacity))
    d, c, stats = moe.topk_routing(logits, capacity, k)
    slots, weights, stats2 = moe.topk_slots(logits, capacity, k)
    t, e = logits.shape
    want = torch.zeros(t, e * capacity + 1)
    comb = torch.zeros(t, e * capacity + 1)
    want.scatter_(1, slots, 1.0)
    comb.scatter_(1, slots, weights)
    np.testing.assert_array_equal(want[:, :-1].numpy(),
                                  d.reshape(t, -1).numpy())
    np.testing.assert_array_equal(comb[:, :-1].numpy(),
                                  c.reshape(t, -1).numpy())
    for key in ("fraction", "prob"):
        assert torch.equal(stats[key], stats2[key])


def test_top1_routing_and_the_router_checks_match_jax():
    logits = logits_of(3)
    jd, jc = jax_moe.top1_routing(jnp.asarray(logits), 5)
    d, c = moe.top1_routing(torch.from_numpy(logits), 5)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)
    for k in (0, 5):
        with pytest.raises(ValueError, match="router k"):
            jax_moe.topk_routing(jnp.asarray(logits), 4, k)
        with pytest.raises(ValueError, match="router k"):
            moe.topk_routing(torch.from_numpy(logits), 4, k)


def test_load_balance_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(4)
    f = rng.dirichlet(np.ones(6)).astype(np.float32)
    p = rng.dirichlet(np.ones(6)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda pp: jax_moe.load_balance_loss(
        {"fraction": jnp.asarray(f), "prob": pp}))(jnp.asarray(p))
    tp_ = torch.from_numpy(p).requires_grad_()
    loss = moe.load_balance_loss({"fraction": torch.from_numpy(f),
                                  "prob": tp_})
    g, = torch.autograd.grad(loss, tp_)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    uniform = {"fraction": torch.full((4,), 0.25),
               "prob": torch.full((4,), 0.25)}
    assert moe.load_balance_loss(uniform).item() == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# moe_mlp on one device
# ---------------------------------------------------------------------------

def mlp_inputs(seed, e=4, d=8, f=16, b=2, s=12):
    rng = np.random.default_rng(seed)
    w = lambda *shape: (rng.standard_normal(shape) / np.sqrt(shape[-2])
                        ).astype(np.float32)
    return (rng.standard_normal((b, s, d)).astype(np.float32), w(d, e),
            w(e, d, f), (0.1 * rng.standard_normal((e, f))).astype(
                np.float32), w(e, f, d),
            (0.1 * rng.standard_normal((e, d))).astype(np.float32),
            rng.standard_normal((b, s, d)).astype(np.float32))


MLP_CASES = [(1, 0.5), (1, 4.0), (2, 0.5), (2, 2.0)]


@functools.lru_cache(maxsize=None)
def jax_mlp(k, cf):
    *args, c = mlp_inputs(int(10 * k + cf))
    mesh = JaxMesh(np.array(jax.devices()[:1]), ("model",))

    def loss(*a):
        y, stats = jax_moe.moe_mlp(*a, axis_name="model",
                                   capacity_factor=cf,
                                   compute_dtype=jnp.float32,
                                   router_top_k=k)
        total = jnp.sum(y * c) + 0.1 * jax_moe.load_balance_loss(stats)
        # the gathered output is typed model-varying: the pmean makes the
        # loss provably replicated, as ParallelTransformerLM's does
        return jax.lax.pmean(total, "model"), (y, stats)
    fn = jax.jit(_compat.shard_map(
        jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True),
        mesh=mesh, in_specs=(P(),) * 6,
        out_specs=((P(), (P("model"), P("model"))), (P(),) * 6)))
    (_, (y, stats)), grads = fn(*args)
    return (np.asarray(y), {k_: np.asarray(v) for k_, v in stats.items()},
            [np.asarray(g) for g in grads])


def port_mlp(k, cf, dispatch):
    *args, c = mlp_inputs(int(10 * k + cf))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, stats = moe.moe_mlp(*ts, axis_name="model", capacity_factor=cf,
                           compute_dtype=torch.float32, router_top_k=k,
                           mesh=Mesh(device="cpu", axis_names=("model",)),
                           dispatch=dispatch)
    loss = ((y * torch.from_numpy(c)).sum()
            + 0.1 * moe.load_balance_loss(stats))
    return y, stats, torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("dispatch", ["index", "onehot"])
@pytest.mark.parametrize("k,cf", MLP_CASES)
def test_moe_mlp_forward_and_gradients_match_jax(k, cf, dispatch):
    wy, wstats, wgrads = jax_mlp(k, cf)
    y, stats, grads = port_mlp(k, cf, dispatch)
    np.testing.assert_allclose(y.detach().numpy(), wy, rtol=0,
                               atol=1e-5 * np.abs(wy).max())
    for key in ("fraction", "prob"):
        np.testing.assert_allclose(stats[key].detach().numpy(), wstats[key],
                                   rtol=1e-6, atol=1e-7)
    for i, (g, jg) in enumerate(zip(grads, wgrads)):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max() + 1e-9,
                                   err_msg=f"input {i}")
    if cf == 0.5:
        assert stats["dropped"].item() > 0


@pytest.mark.parametrize("k,cf", MLP_CASES)
def test_the_index_form_is_the_einsum_form(k, cf):
    yi, si, gi = port_mlp(k, cf, "index")
    yo, so, go = port_mlp(k, cf, "onehot")
    # at k = 2 the einsum's product sums round once where the index
    # form's gate-weighted sum rounds twice
    torch.testing.assert_close(yi, yo, rtol=0,
                               atol=1e-6 * yo.abs().max().item())
    assert torch.equal(si["dropped"], so["dropped"])
    for a, b in zip(gi, go):  # sums in other orders: 1e-6 of the largest
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * b.abs().max().item())


def test_moe_mlp_refuses_what_jax_refuses():
    args = [torch.from_numpy(a) for a in mlp_inputs(0)[:6]]
    mesh = Mesh(device="cpu", axis_names=("model",))
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_mlp(*args, mesh=mesh, dispatch="dense")
    with pytest.raises(ValueError, match="router k"):
        moe.moe_mlp(*args, mesh=mesh, router_top_k=5)


# ---------------------------------------------------------------------------
# the MoE LM at (1, 1, 1)
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=32, seq_len=16, d_model=16, num_heads=4,
            num_layers=2, mlp_dim=32, compute_dtype="float32")
LM_CASES = {
    "top1_ring_learned": dict(moe_layers=(1,), num_experts=4),
    "top2_ulysses_rope_fused": dict(moe_layers=(0, 1), num_experts=4,
                                    router_top_k=2, capacity_factor=1.0,
                                    sp_impl="ulysses", positional="rope",
                                    fused_ce=True, router_aux_weight=0.1),
}
LR, BATCH = 1e-2, 4


@functools.lru_cache(maxsize=None)
def jax_lm(name):
    cfg = {**TINY, **LM_CASES[name], "compute_dtype": jnp.float32}
    mesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                   ("data", "seq", "model"))
    lm = JaxLM(**cfg, mesh=mesh)
    tree = tr.lm_tree(port_lm(name)._shapes(), len(name))
    toks, labels = tr.lm_batch(cfg, BATCH, 5)
    specs, bs = lm.param_specs(), P("data", "seq")
    grad_fn = _compat.shard_map(jax.value_and_grad(lm._loss), mesh=mesh,
                                in_specs=(specs, bs, bs),
                                out_specs=(P(), specs))
    tx = optax.adam(LR, eps=1e-4)

    @jax.jit
    def step(params, opt_state):
        loss, grads = grad_fn(params, toks, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, grads, optax.apply_updates(params, updates), opt_state

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state, losses, grads0 = tx.init(params), [], None
    for _ in range(3):
        loss, grads, params, opt_state = step(params, opt_state)
        grads0 = grads0 or list(_jax_leaves(jax.device_get(grads)))
        losses.append(float(loss))
    return dict(tree=tree, grads=[g for _, g in grads0], losses=losses,
                names=[n for n, _ in grads0])


def port_lm(name, **extra):
    return ParallelTransformerLM(**TINY, **LM_CASES[name], **extra,
                                 mesh=Mesh(device="cpu"))


@pytest.mark.parametrize("name", LM_CASES)
def test_the_moe_tree_is_the_jax_tree(name):
    lm = port_lm(name)
    assert list(lm._shapes()) == jax_lm(name)["names"]
    params = lm.init(torch.Generator().manual_seed(0))
    assert list(params) == jax_lm(name)["names"]
    for n, p in params.items():
        if n.endswith((".b1", ".b2")):
            assert bool((p == 0).all()), n
        elif n.endswith((".w1", ".w2", ".router")):
            fan_in = p.shape[-2]
            assert abs(p.std().item() - fan_in ** -0.5) < 0.2 * fan_in ** -0.5
    moe_layer = LM_CASES[name]["moe_layers"][0]
    assert lm.param_specs()[f"layers.{moe_layer}.w1"] == ("model", None,
                                                          None)
    assert lm.grad_axes()[f"layers.{moe_layer}.router"] == (
        "data", "seq", "model")


@pytest.mark.parametrize("name", LM_CASES)
def test_moe_lm_loss_and_gradients_match_jax(name):
    want = jax_lm(name)
    lm = port_lm(name)
    params = load_jax_params(lm, want["tree"])
    toks, labels = (torch.from_numpy(a) for a in tr.lm_batch(
        {**TINY, **LM_CASES[name]}, BATCH, 5))
    loss = lm._loss(params, toks, labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), want["losses"][0], rtol=1e-5)
    for pname, g, jg in zip(params, grads, want["grads"]):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max() + 1e-9,
                                   err_msg=pname)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", LM_CASES)
def test_moe_lm_three_adam_steps_match_jax(name, remat):
    want = jax_lm(name)
    lm = port_lm(name, remat=remat)
    params = load_jax_params(lm, want["tree"])
    opt_state, step = lm.compile_train_step(optimizers.adam(LR, eps=1e-4),
                                            params)
    toks, labels = (torch.from_numpy(a) for a in tr.lm_batch(
        {**TINY, **LM_CASES[name]}, BATCH, 5))
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, toks, labels)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]


def test_the_router_stats_come_back_from_the_forward():
    lm = port_lm("top2_ulysses_rope_fused")
    params = load_jax_params(lm, jax_lm("top2_ulysses_rope_fused")["tree"])
    toks, _ = tr.lm_batch({**TINY, **LM_CASES["top2_ulysses_rope_fused"]},
                          BATCH, 5)
    with torch.no_grad():
        logits, stats = lm._forward(params, torch.from_numpy(toks))
    assert logits.shape == (BATCH, TINY["seq_len"], TINY["vocab_size"])
    assert len(stats) == 2
    for s in stats:
        assert s["fraction"].sum().item() == pytest.approx(1.0)
        assert s["prob"].sum().item() == pytest.approx(1.0, rel=1e-6)
        assert 0.0 <= s["dropped"].item() < 1.0
