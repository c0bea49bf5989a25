"""Head dims above 256 on the card: the SIMT kernels take them in chunks.

The reference's kernel takes any head dim (``_pallas_eligible``: "head_dim
is unconstrained").  The port's SIMT kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) take a head dim above 256 in 128-column
chunks, one block per output chunk on the grid's z axis; the variant rules
send every such head dim there, whatever the dtype, and never to the plain
path.  Here the wrappers are driven with fake CUDA tensors and a recording
launcher, and the plain versions, which the card holds the kernels
against, are held at D 300 against the JAX Pallas kernels in interpret
mode (16-row blocks, as in tests/test_torch_flash_backward.py): out and
lse at f32 atol 1e-5, gradients at 1e-4.  The JAX kernel takes equal head
counts, so it gets k and v repeated and its dk, dv are summed over each kv
head's query heads.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distkeras_tpu.ops.flash_attention import _flash_forward
from distkeras_tpu.ops.flash_attention import flash_attention as jax_flash
from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import attention

flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

WIDE = 300


@pytest.fixture()
def launcher(monkeypatch):
    """Record the C launches instead of making them, from zeroed counts."""
    calls = []

    def launch(name, ptrs, q, hkv, scale, causal, window):
        calls.append(dict(name=name, shape=tuple(q.shape), hkv=hkv))
    monkeypatch.setattr(flash_mod, "_launch", launch)
    for fn in (flash_mod.flash_attention, flash_mod.flash_attention_forward):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_variant",
                            dict.fromkeys(flash_mod.FORWARD_VARIANTS, 0))
    bwd = flash_mod.flash_attention_backward
    for kernel in ("dq", "dkv"):
        monkeypatch.setattr(bwd, f"{kernel}_launches", 0)
        monkeypatch.setattr(bwd, f"{kernel}_launches_by_variant",
                            dict.fromkeys(flash_mod.BACKWARD_VARIANTS, 0))

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA call reached the plain path")
    monkeypatch.setattr(importlib.import_module(
        "distkeras_tpu_torch.ops.attention"), "dot_product_attention", plain)
    with warnings.catch_warnings():  # a fake tensor's data_ptr warns
        warnings.simplefilter("ignore", UserWarning)
        yield calls


def fake_cuda(*shapes, dtype):
    return tuple(torch.empty(*s, dtype=dtype, device="cuda") for s in shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wide_forward_launches_the_simt_entry(launcher, dtype):
    with FakeTensorMode():
        q, k, v = fake_cuda((2, 64, 4, WIDE), (2, 64, 2, WIDE),
                            (2, 64, 2, WIDE), dtype=dtype)
        out = attention(q, k, v, causal=True)
        _, lse = flash_mod.flash_attention_forward(q, k, v, True)
        assert out.shape == q.shape and lse.shape == (2, 4, 64)
    assert [c["name"] for c in launcher] == ["flash_attention_fwd"] * 2
    assert {c["shape"] for c in launcher} == {(2, 64, 4, WIDE)}
    assert flash_mod.flash_attention.launches_by_variant == {"sm90": 0,
                                                            "simt": 1}
    assert flash_mod.flash_attention_forward.launches_by_variant == {
        "sm90": 0, "simt": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wide_backward_launches_the_simt_entries(launcher, dtype):
    with FakeTensorMode():
        q, k, v, out, dout = fake_cuda(
            (1, 64, 4, WIDE), (1, 64, 1, WIDE), (1, 64, 1, WIDE),
            (1, 64, 4, WIDE), (1, 64, 4, WIDE), dtype=dtype)
        (lse,) = fake_cuda((1, 4, 64), dtype=torch.float32)
        dq, dk, dv = flash_mod.flash_attention_backward(q, k, v, out, lse,
                                                        dout, True)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape,
                                                  v.shape)
    assert [c["name"] for c in launcher] == ["flash_attention_bwd_dq",
                                             "flash_attention_bwd_dkv"]
    bwd = flash_mod.flash_attention_backward
    assert bwd.dq_launches_by_variant == {"sm90": 0, "simt": 1}
    assert bwd.dkv_launches_by_variant == {"sm90": 0, "simt": 1}


@pytest.mark.parametrize("dtype,d,forward,backward", [
    (torch.bfloat16, 128, "sm90", "sm90"),
    (torch.bfloat16, 136, "sm90", "simt"),
    (torch.bfloat16, 256, "sm90", "simt"),
    (torch.bfloat16, 264, "simt", "simt"),
    (torch.float16, 512, "simt", "simt"),
    (torch.float32, 300, "simt", "simt"),
    (torch.float32, 64, "simt", "simt"),
])
def test_variant_rules(dtype, d, forward, backward):
    """Rules about dtype and head dim alone: a 16-bit head dim above the
    sm90 forward's 256 goes to SIMT, as one above the sm90 backward's
    128 already did."""
    assert flash_mod._forward_variant(dtype, d) == forward
    assert flash_mod._backward_variant(dtype, d) == backward


def test_simt_sources_tile_wide_head_dims():
    """Both SIMT sources keep padded instantiations for narrow head dims and
    add one chunk instantiation whose grid has a z axis of one block per
    chunk of 128 columns: the forward pads up to 256 (its output
    accumulators take D / 2 registers per thread) and chunks above it, the
    backward pads up to 32, 64 or 128 (its dk and dv accumulators take D)
    and chunks above that."""
    assert flash_mod.SIMT_HEAD_DIM_CHUNK == 128
    fwd = kernels.source_path("flash_attention_fwd").read_text()
    bwd = kernels.source_path("flash_attention_bwd").read_text()
    assert "constexpr int kChunk = 128;" in fwd
    assert "constexpr int kWhole = 256;" in fwd
    assert "constexpr int kChunk = 128;" in bwd
    assert "launch<T, kChunk, true>" in fwd
    assert "launch_dq<T, kChunk, true>" in bwd
    assert "launch_dkv<T, kChunk, true>" in bwd
    for text in (fwd, bwd):
        assert "kWide ? (int)blockIdx.z : 0" in text
        assert text.count("kWide ? (") >= 3
    for dp in (32, 64, 128, "kWhole"):
        assert f"launch<T, {dp}>" in fwd
    for dp in (32, 64, "kChunk"):
        assert f"launch_dkv<T, {dp}>(a) : launch_dq<T, {dp}>(a)" in bwd


B, S, H = 1, 48, 4


@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                               (False, None, 4),
                                               (True, 20, 1)])
def test_plain_versions_at_d300_match_pallas_kernels(causal, window, hkv):
    rng = np.random.default_rng(hkv * 7 + (window or 0))
    q, r = (rng.standard_normal((B, S, H, WIDE)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((B, S, hkv, WIDE)).astype(np.float32)
            for _ in range(2))
    g = H // hkv
    jq, jk, jv = (jnp.asarray(a) for a in
                  (q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)))
    jout, jlse = _flash_forward(jq, jk, jv, 1.0 / np.sqrt(WIDE), causal, 16,
                                16, True, save_residuals=True, window=window)
    loss = lambda a, b_, c: jnp.sum(
        jax_flash(a, b_, c, causal, None, 16, 16, True, window) * r)
    jdq, jdk, jdv = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    group = lambda t: np.asarray(t).reshape(B, S, hkv, g, WIDE).sum(3)

    tq, tk, tv, tr = (torch.from_numpy(a) for a in (q, k, v, r))
    out, lse = flash_mod.flash_attention_reference(tq, tk, tv, causal, None,
                                                   window, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse)[..., 0].reshape(B, H, S), atol=1e-5)
    dq, delta = flash_mod.flash_attention_bwd_dq_reference(
        tq, tk, tv, out, lse, tr, causal, None, window)
    dk, dv = flash_mod.flash_attention_bwd_dkv_reference(
        tq, tk, tv, lse, tr, delta, causal, None, window)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=1e-4)
    np.testing.assert_allclose(dk.numpy(), group(jdk), atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), group(jdv), atol=1e-4)
