"""Strided and misaligned views at the public kernel entry points.

The JAX ``attention``, ``flash_attention`` and
``fused_softmax_cross_entropy`` take any array.  On the card the port's
entry points hand the kernels a contiguous copy of a view that is not
contiguous or does not start on a 16-byte boundary
(``kernels.kernel_operand``), and the kernel still launches; the raw
wrappers keep refusing such views.  Here the CUDA route is driven with
fake CUDA tensors and a recording launcher (no card: the kernels are not
run, and autograd is never run on fake tensors), and the copy's autograd
on real CPU tensors (the copy rule switched on for the CPU), where the
plain versions compute: a view and its contiguous copy give the same
values and gradients, the gradients in the views' shapes.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import attention

flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
ce_mod = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")

torch.set_num_threads(1)

B, S, H, D = 2, 64, 8, 32


@pytest.fixture()
def seen(monkeypatch):
    """Record the operands of every flash and CE launch (layout only)."""
    calls = []

    def flash_launch(name, ptrs, q, hkv, scale, causal, window):
        calls.append(("flash", name))

    def ce_launch(name, ptrs, logits):
        calls.append(("ce", name))

    real_check = flash_mod._check

    def check(q, k, v):
        calls.append(("operands", [layout(t) for t in (q, k, v)]))
        real_check(q, k, v)

    real_ce_check = ce_mod._check

    def ce_check(logits, labels):
        calls.append(("operands", [layout(logits)]))
        real_ce_check(logits, labels)

    monkeypatch.setattr(flash_mod, "_launch", flash_launch)
    monkeypatch.setattr(flash_mod, "_check", check)
    monkeypatch.setattr(ce_mod, "_launch", ce_launch)
    monkeypatch.setattr(ce_mod, "_check", ce_check)
    monkeypatch.setattr(flash_mod.flash_attention, "launches", 0)
    monkeypatch.setattr(ce_mod.fused_ce_fwd, "launches", 0)
    with warnings.catch_warnings():  # a fake tensor's data_ptr warns
        warnings.simplefilter("ignore", UserWarning)
        yield calls


def layout(t):
    """(contiguous, byte offset into its storage mod 16)."""
    return t.is_contiguous(), (t.storage_offset() * t.element_size()) % 16


def fake_views(kind, dtype=torch.bfloat16):
    """q, k, v as a view of the given kind, on a fake CUDA card."""
    if kind == "chunked":  # one (B, S, 3H, D) projection, split
        return torch.empty(B, S, 3 * H, D, dtype=dtype,
                           device="cuda").chunk(3, dim=2)
    if kind == "transposed":  # BHSD storage seen as BSHD
        return tuple(torch.empty(B, H, S, D, dtype=dtype,
                                 device="cuda").transpose(1, 2)
                     for _ in range(3))
    n = B * S * H * D  # contiguous, one element off a 16-byte boundary
    flat = torch.empty(3 * n + 1, dtype=dtype, device="cuda")
    return tuple(flat.narrow(0, 1 + i * n, n).view(B, S, H, D)
                 for i in range(3))


@pytest.mark.parametrize("kind", ["chunked", "transposed", "misaligned"])
def test_attention_views_reach_the_kernel_contiguous_and_aligned(seen,
                                                                 kind):
    with FakeTensorMode():
        q, k, v = fake_views(kind)
        assert any(layout(t) != (True, 0) for t in (q, k, v))
        out = attention(q, k, v, causal=True)
        assert out.shape == (B, S, H, D) and out.is_contiguous()
    operands = [c[1] for c in seen if c[0] == "operands"]
    assert operands == [[(True, 0)] * 3]
    assert [c for c in seen if c[0] == "flash"] == [
        ("flash", "flash_attention_fwd_sm90")]
    assert flash_mod.flash_attention.launches == 1


@pytest.mark.parametrize("kind", ["chunked", "transposed", "misaligned"])
def test_flash_attention_views_reach_the_kernel_in_f32(seen, kind):
    """The same at f32 through ``flash_attention`` itself (the SIMT
    variant)."""
    with FakeTensorMode():
        q, k, v = fake_views(kind, torch.float32)
        flash_mod.flash_attention(q, k, v, causal=False)
    assert [c[1] for c in seen if c[0] == "operands"] == [[(True, 0)] * 3]
    assert ("flash", "flash_attention_fwd") in seen


@pytest.mark.parametrize("kind", ["chunked", "transposed"])
def test_the_raw_wrappers_still_refuse_views(seen, kind):
    """(A misaligned contiguous view: the next test, since a fake tensor
    reports no address.)"""
    with FakeTensorMode():
        q, k, v = fake_views(kind)
        with pytest.raises(ValueError, match="contiguous"):
            flash_mod.flash_attention_forward(q, k, v, True)
    assert not [c for c in seen if c[0] == "flash"]


def test_the_sm90_wrapper_refuses_a_misaligned_operand(monkeypatch):
    """A real address off a 16-byte boundary is refused by the raw sm90
    wrappers (they never reroute); the entry points copy it first."""
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 2)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_mod._check_tma(torch.empty(1, 4, 1, 8))


def test_flash_backward_copies_a_strided_cotangent(seen, monkeypatch):
    """The autograd Function's backward hands the kernels dO contiguous
    and aligned, whatever view autograd gives it."""
    got = []

    def backward(q, k, v, out, lse, dout, *args):
        got.append(layout(dout))
        return q, k, v
    monkeypatch.setattr(flash_mod, "flash_attention_backward", backward)

    class Ctx:
        args = (True, None, None)

    with FakeTensorMode():
        q, k, v = fake_views("chunked")
        Ctx.saved_tensors = (q, k, v, q, torch.empty(B, H, S,
                                                      device="cuda"))
        dout = torch.empty(B, H, S, D, dtype=torch.bfloat16,
                           device="cuda").transpose(1, 2)
        flash_mod.FlashAttentionFunction.backward(Ctx, dout)
    assert got == [(True, 0)]


@pytest.mark.parametrize("kind", ["transposed", "misaligned"])
def test_fused_ce_views_reach_the_kernel_contiguous(seen, kind):
    with FakeTensorMode():
        if kind == "transposed":
            logits = torch.empty(1000, 64, device="cuda").t()
        else:
            logits = torch.empty(64 * 1000 + 1, dtype=torch.bfloat16,
                                 device="cuda").narrow(0, 1, 64000).view(
                                     64, 1000)
        labels = torch.empty(64, dtype=torch.int64, device="cuda")
        loss = ce_mod.fused_softmax_cross_entropy(logits, labels)
        assert loss.shape == (64,)
        if kind == "transposed":
            with pytest.raises(ValueError, match="contiguous logits"):
                ce_mod.fused_ce_fwd(logits, labels)
    assert [c[1] for c in seen if c[0] == "operands"][0] == [(True, 0)]
    assert ("ce", "fused_ce_fwd") in seen
    assert ce_mod.fused_ce_fwd.launches == 1


def test_kernel_operand_copies_only_what_the_kernels_cannot_read():
    with FakeTensorMode():
        dense = torch.empty(4, 8, dtype=torch.bfloat16, device="cuda")
        assert kernels.kernel_operand(dense) is dense
        aligned = torch.empty(64, dtype=torch.bfloat16,
                              device="cuda").narrow(0, 8, 32)
        assert kernels.kernel_operand(aligned) is aligned
        for view in (dense.t(), torch.empty(64, dtype=torch.bfloat16,
                                            device="cuda").narrow(0, 1, 32)):
            copy = kernels.kernel_operand(view)
            assert copy is not view and layout(copy) == (True, 0)
            assert copy.shape == view.shape
    cpu_view = torch.zeros(4, 8).t()
    assert kernels.kernel_operand(cpu_view) is cpu_view


def real_views(kind, seed, dtype=torch.float32, h=4, hkv=4):
    rng = np.random.default_rng(seed)
    if kind == "chunked":
        leaf = torch.from_numpy(rng.standard_normal(
            (2, 32, 3 * h, 16)).astype(np.float32)).to(dtype)
        leaf.requires_grad_()
        return leaf, leaf.chunk(3, dim=2)
    if kind == "transposed":
        leaf = torch.from_numpy(rng.standard_normal(
            (3, 2, h, 32, 16)).astype(np.float32)).to(dtype)
        leaf.requires_grad_()
        return leaf, tuple(t.transpose(1, 2) for t in leaf.unbind(0))
    n = 2 * 32 * h * 16
    leaf = torch.from_numpy(rng.standard_normal(3 * n + 1).astype(
        np.float32)).to(dtype)
    leaf.requires_grad_()
    return leaf, tuple(p.view(2, 32, h, 16)
                       for p in leaf[1:].split([n, n, n]))


@pytest.mark.parametrize("kind", ["chunked", "transposed", "misaligned"])
def test_view_and_copy_give_the_same_values_and_gradients(kind,
                                                          monkeypatch):
    """On the CPU, with the copy rule switched on for CPU tensors: the
    entry point's copy carries the gradient back into the view's shape,
    and the values equal those of the same call on contiguous copies."""
    monkeypatch.setattr(kernels, "_needs_copy", lambda t: not (
        t.is_contiguous() and layout(t)[1] == 0))
    leaf, views = real_views(kind, seed=len(kind))
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(views[0].shape)).astype(np.float32))
    out = attention(*views, causal=True, impl="pallas")
    (grad,) = torch.autograd.grad((out * r).sum(), leaf)
    assert grad.shape == leaf.shape
    copies = [t.detach().contiguous().requires_grad_() for t in views]
    out_c = attention(*copies, causal=True, impl="pallas")
    grads_c = torch.autograd.grad((out_c * r).sum(), copies)
    torch.testing.assert_close(out, out_c, atol=0, rtol=0)
    grads_v = torch.autograd.grad((attention(
        *views, causal=True, impl="pallas") * r).sum(), views)
    for gv, gc, view in zip(grads_v, grads_c, views):
        assert gv.shape == view.shape
        torch.testing.assert_close(gv, gc, atol=0, rtol=0)


def test_transposed_logits_give_the_same_loss_and_gradient(monkeypatch):
    monkeypatch.setattr(kernels, "_needs_copy",
                        lambda t: not t.is_contiguous())
    rng = np.random.default_rng(2)
    base = torch.from_numpy(rng.standard_normal((50, 12)).astype(
        np.float32)).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, 50, 12))
    loss = ce_mod.fused_softmax_cross_entropy(base.t(), labels)
    (grad,) = torch.autograd.grad(loss.sum(), base)
    assert grad.shape == base.shape
    copy = base.detach().t().contiguous().requires_grad_()
    loss_c = ce_mod.fused_softmax_cross_entropy(copy, labels)
    (grad_c,) = torch.autograd.grad(loss_c.sum(), copy)
    torch.testing.assert_close(loss, loss_c, atol=0, rtol=0)
    torch.testing.assert_close(grad.t(), grad_c, atol=0, rtol=0)
