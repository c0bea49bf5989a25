"""The backward's tensor-core variant (``csrc/flash_attention_bwd_sm90.cu``)
as far as a machine without a card can check it.

- The variant rule, ``_backward_variant(dtype, head_dim)``: bf16 and f16
  with a head dim that is a multiple of 8 and at most 128 take ``"sm90"``
  (the main paths' D 32 and D 64 among them), f32 and every other head
  dim the SIMT kernels.
- The wrappers on fake CUDA tensors: the dq and dk/dv launches go to the
  entry points of their variant, each counted once in ``dq_launches`` /
  ``dkv_launches`` and in ``*_launches_by_variant``; what no kernel takes,
  data off a 16-byte boundary, and a failed tensor-map encode or launch
  raise and count nothing.
- The build: the source is in ``KERNELS``, has both C entries, includes
  the shared ``sm90_common.cuh`` (whose edits rebuild every library) and
  compiles for ``sm_90a``.
- The kernels' arithmetic, modelled in plain torch (16-bit operands with
  f32 products, the scale applied after the product, exp2 with log2(e)
  folded in, 64-row tiles in the kernels' order, p and ds split into hi
  and lo for the three 16-bit products they enter), held against the JAX
  Pallas kernels in interpret mode within ``chip_smoke.py``'s per-element
  ``TRAIN_TOL_*`` rule (one output ulp + 1e-4 of the tensor's largest
  value); p or ds rounded once to 16 bits misses it for each of the three
  products, which is why the kernels split all three.
"""

import contextlib
import functools
import importlib
import os
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distkeras_tpu.ops.flash_attention import _flash_backward, _flash_forward
from distkeras_tpu_torch import kernels

flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

# chip_smoke.py's per-element tolerance of the training kernels against
# their plain versions: |got - want| <= ulp * |want| + 1e-4 * max|want|
TRAIN_TOL_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
TRAIN_TOL_F32 = 1e-4
LOG2E = 1.4426950408889634
BLOCK = 64  # rows of every tile of the kernels
SOURCE = "flash_attention_bwd_sm90"


@pytest.mark.parametrize("dtype,d", (
    [(dt, d) for dt in (torch.bfloat16, torch.float16)
     for d in (8, 16, 32, 64, 96, 128)]))
def test_16bit_head_dims_up_to_128_take_sm90(dtype, d):
    assert flash_mod._backward_variant(dtype, d) == "sm90"


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 136),
                                     (torch.bfloat16, 200),
                                     (torch.float16, 256),
                                     (torch.bfloat16, 33),
                                     (torch.float16, 100),
                                     (torch.float32, 32),
                                     (torch.float32, 64),
                                     (torch.float32, 128)])
def test_f32_wide_and_odd_head_dims_take_simt(dtype, d):
    assert flash_mod._backward_variant(dtype, d) == "simt"


def test_main_paths_take_sm90_forward_and_backward():
    """The SingleTrainer LM (D 32) and the Ulysses parallel LM (D 64) in
    bf16: every flash kernel of their steps is a tensor-core kernel."""
    for d in (32, 64):
        assert flash_mod._forward_variant(torch.bfloat16, d) == "sm90"
        assert flash_mod._backward_variant(torch.bfloat16, d) == "sm90"


def fake_cuda(*shapes, dtype=torch.bfloat16):
    return tuple(torch.empty(*s, dtype=dtype, device="cuda") for s in shapes)


def zero_backward_counts(monkeypatch):
    fn = flash_mod.flash_attention_backward
    for attr in ("dq_launches", "dkv_launches"):
        monkeypatch.setattr(fn, attr, 0)
    for attr in ("dq_launches_by_variant", "dkv_launches_by_variant"):
        monkeypatch.setattr(fn, attr,
                            dict.fromkeys(flash_mod.BACKWARD_VARIANTS, 0))


@pytest.fixture()
def launcher(monkeypatch):
    """Record the C launches instead of making them, from zeroed counts."""
    calls = []

    def launch(name, ptrs, q, hkv, scale, causal, window):
        calls.append(dict(name=name, n_ptrs=len(ptrs), shape=tuple(q.shape),
                          dtype=q.dtype, hkv=hkv, scale=scale, causal=causal,
                          window=window))
    monkeypatch.setattr(flash_mod, "_launch", launch)
    zero_backward_counts(monkeypatch)
    with warnings.catch_warnings():  # a fake tensor's data_ptr warns
        warnings.simplefilter("ignore", UserWarning)
        yield calls


def run_backward(b, s, h, hkv, d, dtype, causal=True, scale=None,
                 window=None):
    q, k, v, out, dout = fake_cuda((b, s, h, d), (b, s, hkv, d),
                                   (b, s, hkv, d), (b, s, h, d), (b, s, h, d),
                                   dtype=dtype)
    lse = fake_cuda((b, h, s), dtype=torch.float32)[0]
    return q, k, v, flash_mod.flash_attention_backward(
        q, k, v, out, lse, dout, causal, scale, window)


def counts():
    fn = flash_mod.flash_attention_backward
    return (fn.dq_launches, fn.dkv_launches, fn.dq_launches_by_variant,
            fn.dkv_launches_by_variant)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,hkv", [(32, 2), (64, 8), (128, 1)])
def test_16bit_backward_launches_the_sm90_entries_once(launcher, dtype, d,
                                                       hkv):
    with FakeTensorMode():
        q, k, v, (dq, dk, dv) = run_backward(2, 128, 8, hkv, d, dtype,
                                             window=32)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert [c["name"] for c in launcher] == [
        "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dkv_sm90"]
    for c in launcher:
        assert c == dict(name=c["name"], n_ptrs=8, shape=(2, 128, 8, d),
                         dtype=dtype, hkv=hkv, scale=1 / d ** 0.5,
                         causal=True, window=32)
    assert counts() == (1, 1, {"sm90": 1, "simt": 0},
                        {"sm90": 1, "simt": 0})


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 200),
                                     (torch.float16, 36)])
def test_f32_and_other_head_dims_launch_the_simt_entries(launcher, dtype, d):
    with FakeTensorMode():
        run_backward(1, 64, 4, 2, d, dtype, causal=False, scale=0.5)
    assert [c["name"] for c in launcher] == ["flash_attention_bwd_dq",
                                             "flash_attention_bwd_dkv"]
    assert {c["scale"] for c in launcher} == {0.5}
    assert counts() == (1, 1, {"sm90": 0, "simt": 1},
                        {"sm90": 0, "simt": 1})


@pytest.mark.parametrize("d,dtype,error,match", [
    # a head dim past the SIMT kernels' 65535 chunks of 256 columns
    (65535 * 256 + 8, torch.bfloat16, ValueError, "grid limit"),
    (32, torch.float64, TypeError, "one dtype among"),
])
def test_what_no_kernel_takes_raises_without_counting(launcher, d, dtype,
                                                      error, match):
    with FakeTensorMode():
        with pytest.raises(error, match=match):
            run_backward(1, 64, 4, 4, d, dtype)
    assert launcher == []
    assert counts() == (0, 0, {"sm90": 0, "simt": 0}, {"sm90": 0, "simt": 0})


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_sm90_refuses_data_off_a_16_byte_boundary(launcher, monkeypatch,
                                                  kernel):
    """A contiguous view at an odd offset: the TMA maps cannot take it, so
    the wrapper raises (no rerouting to the SIMT kernels)."""
    with FakeTensorMode():
        q, k, v, out, dout = fake_cuda((1, 64, 4, 32), (1, 64, 2, 32),
                                       (1, 64, 2, 32), (1, 64, 4, 32),
                                       (1, 64, 4, 32))
        lse, delta = fake_cuda((1, 4, 64), (1, 4, 64), dtype=torch.float32)
        monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 2)
        with pytest.raises(ValueError, match="16-byte boundary"):
            if kernel == "dq":
                flash_mod.flash_attention_bwd_dq(q, k, v, out, lse, dout,
                                                 True)
            else:
                flash_mod.flash_attention_bwd_dkv(q, k, v, lse, dout, delta,
                                                  True)
    assert launcher == []
    assert counts() == (0, 0, {"sm90": 0, "simt": 0}, {"sm90": 0, "simt": 0})


@pytest.mark.parametrize("offset,ok", [(0, True), (8, True), (1, False),
                                       (4, False)])
def test_check_tma_reads_the_data_pointer(offset, ok):
    base = torch.zeros(1024, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    view = base[offset:offset + 512].view(1, 16, 4, 8)
    assert view.is_contiguous()
    if ok:
        flash_mod._check_tma(view, base[:512].view(1, 16, 4, 8))
    else:
        with pytest.raises(ValueError, match="16-byte boundary"):
            flash_mod._check_tma(base[:512].view(1, 16, 4, 8), view)


@pytest.mark.parametrize("rc,match", [(-1, "TMA tensor maps"),
                                      (-701, "TMA tensor maps"),
                                      (1, "launch failed: CUDA error 1")])
def test_failed_encode_or_launch_raises_without_counting(monkeypatch, rc,
                                                         match):
    """The sm90 entry's error code raises: a refused tensor map (negative)
    or launch (a cudaError_t); nothing falls back or counts."""
    seen = []

    def entry(*args):
        seen.append(args)
        return rc
    monkeypatch.setattr(flash_mod, "_entry", lambda name: (seen.append(name),
                                                           entry)[1])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("Stream", (), {"cuda_stream": 0}))
    zero_backward_counts(monkeypatch)
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore", UserWarning)
        with pytest.raises(RuntimeError, match=match):
            run_backward(1, 64, 4, 2, 64, torch.float16, window=16)
    assert seen[0] == "flash_attention_bwd_dq_sm90"
    # pointers, then B, S, H, Hkv, D, dtype code, scale, causal, window, stream
    assert seen[1][8:] == (1, 64, 4, 2, 64, 2, 0.125, 1, 16, 0)
    assert counts() == (0, 0, {"sm90": 0, "simt": 0}, {"sm90": 0, "simt": 0})


def test_sm90_backward_source_is_built_for_sm90a():
    assert SOURCE in kernels.KERNELS
    for entries in flash_mod.BACKWARD_VARIANTS.values():
        for entry in entries.values():
            assert flash_mod._ENTRIES[entry][0] in kernels.KERNELS
    src = kernels.source_path(SOURCE)
    assert src.exists() and src.parent == kernels.CSRC_DIR
    text = src.read_text()
    for entry in flash_mod.BACKWARD_VARIANTS["sm90"].values():
        assert f'extern "C" int {entry}(' in text
        assert flash_mod._ENTRIES[entry] == (SOURCE, 8)
    assert '#include "sm90_common.cuh"' in text
    for replaced in (":: _dq_kernel (:182", "_dkv_kernel (:221"):
        assert replaced in text
    header = (kernels.CSRC_DIR / "sm90_common.cuh").read_text()
    for piece in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                  "mbarrier.try_wait.parity", "cuTensorMapEncodeTiled"):
        assert piece in header
    assert "__grid_constant__" in text
    for banned in ("cublas", "cudnn", "scaled_dot_product", "torch/",
                   "cute/", "cutlass/"):
        assert banned not in (text + header).lower()
    cmd = kernels.nvcc_command(SOURCE, Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
    assert cmd[-1] == str(src)


def test_a_header_edit_makes_every_library_stale(monkeypatch, tmp_path):
    """The sources include ``csrc/*.cuh``: a header newer than a library
    rebuilds it, as a newer source does."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    src, header = csrc / f"{SOURCE}.cu", csrc / "sm90_common.cuh"
    lib = kernels.library_path(SOURCE)
    assert kernels._stale(SOURCE)  # no library yet
    for path, mtime in ((src, 100), (header, 100), (lib, 200)):
        path.write_text("")
        os.utime(path, (mtime, mtime))
    assert not kernels._stale(SOURCE)
    os.utime(header, (300, 300))
    assert kernels._stale(SOURCE)
    os.utime(lib, (400, 400))
    os.utime(src, (500, 500))
    assert kernels._stale(SOURCE)


# ---------------------------------------------------------------------------
# the kernels' arithmetic against the Pallas kernels
# ---------------------------------------------------------------------------

PRODUCTS = ("dv", "dq", "dk")  # p^T.dO, ds.k, ds^T.q


def parts(x, dtype, split):
    """x as the 16-bit operands of the kernels' products: hi = rn(x) and
    lo = rn(x - hi) when split, else rn(x) alone."""
    hi = x.to(dtype).float()
    return [hi, (x - hi).to(dtype).float()] if split else [hi]


def hidden(qpos, kpos, s, causal, window):
    hide = (kpos >= s) | (qpos >= s)
    if causal:
        hide = hide | (kpos > qpos)
        if window is not None:
            hide = hide | (kpos <= qpos - window)
    return hide


def kernel_model(q, k, v, out, lse, dout, causal, window, split=PRODUCTS):
    """The sm90 kernels' arithmetic in plain torch, from (B, S, H, D)
    16-bit q, out, dout, (B, S, Hkv, D) k, v and the f32 (B, H, S) lse: f32
    products of the 16-bit operands; s scaled by scale * log2(e) after the
    product; p = exp2(s - lse * log2(e)), masked; Δ = rowsum(dO o O) from
    O as stored; ds = p o (dO.vᵀ - Δ) * scale; the products named in
    ``split`` take p or ds as hi + lo, the others rn(p) or rn(ds).  dq
    sums its 64-key tiles in order; dk and dv sum, per kv head, over its G
    query heads and their 64-row q tiles in order; each is rounded once to
    the input dtype."""
    dt = q.dtype
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = d ** -0.5
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    q32, k32, v32, do32 = (t.float().transpose(1, 2)
                           for t in (q, k, v, dout))  # (B, heads, S, D)
    k32r, v32r = (t.repeat_interleave(g, 1) for t in (k32, v32))
    lse2 = lse.float() * LOG2E
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    pos = torch.arange(s)

    dq = torch.zeros(b, h, s, d)
    for k0 in range(0, s, BLOCK):
        keys = slice(k0, k0 + BLOCK)
        sc = torch.einsum("bhqd,bhkd->bhqk", q32, k32r[:, :, keys]) * c
        p = torch.exp2(sc - lse2[..., None]).masked_fill(
            hidden(pos[:, None], pos[None, keys], s, causal, window), 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32r[:, :, keys])
        ds = p * (dp - delta[..., None]) * scale
        for part in parts(ds, dt, "dq" in split):
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", part, k32r[:, :, keys])

    dk, dv = torch.zeros(b, hkv, s, d), torch.zeros(b, hkv, s, d)
    for gi in range(g):
        heads = torch.arange(hkv) * g + gi
        for q0 in range(0, s, BLOCK):
            rows = slice(q0, q0 + BLOCK)
            qt, dot = q32[:, heads, rows], do32[:, heads, rows]
            st = torch.einsum("bhkd,bhqd->bhkq", k32, qt) * c
            pt = torch.exp2(st - lse2[:, heads, None, rows]).masked_fill(
                hidden(pos[None, rows], pos[:, None], s, causal, window), 0.0)
            dpt = torch.einsum("bhkd,bhqd->bhkq", v32, dot)
            dst = pt * (dpt - delta[:, heads, None, rows]) * scale
            for part in parts(pt, dt, "dv" in split):
                dv = dv + torch.einsum("bhkq,bhqd->bhkd", part, dot)
            for part in parts(dst, dt, "dk" in split):
                dk = dk + torch.einsum("bhkq,bhqd->bhkd", part, qt)
    back = lambda t: t.transpose(1, 2).to(dt)
    return {"dq": back(dq), "dk": back(dk), "dv": back(dv)}


CASES = {  # causal, window, kv heads (of 4 query heads)
    "causal_gqa": (True, None, 2),
    "window_gqa": (True, 96, 2),
    "noncausal_mqa": (False, None, 1),
}
S, H = 256, 4


@functools.lru_cache(maxsize=None)
def pallas_case(case, d, dtype):
    """Inputs from a numpy seed, the JAX forward's (out, lse) in the dtype,
    and the Pallas backward's (dq, dk, dv) in the port's contract: the JAX
    kernels cast every 16-bit operand to f32 and take equal head counts, so
    they run on f32 copies of the same 16-bit values with k and v
    repeated, and dk, dv are summed over each kv head's query heads in f32
    before the one rounding to the dtype."""
    causal, window, hkv = CASES[case]
    rng = np.random.default_rng(d * 10 + hkv + (window or 0))
    q, do = (rng.standard_normal((1, S, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, S, hkv, d)).astype(np.float32)
            for _ in range(2))
    g = H // hkv
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in
                       (q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2),
                        do))
    scale = d ** -0.5
    out, lse = _flash_forward(jq, jk, jv, scale, causal, BLOCK, BLOCK, True,
                              save_residuals=True, window=window)
    f32 = lambda t: jnp.asarray(t, jnp.float32)
    jdq, jdk, jdv = _flash_backward(f32(jq), f32(jk), f32(jv), f32(out), lse,
                                    f32(jdo), scale, causal, BLOCK, BLOCK,
                                    True, window=window)
    group = lambda t: np.asarray(t).reshape(1, S, hkv, g, d).sum(3)
    to = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype)
    inputs = tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    lse_bhs = torch.from_numpy(
        np.array(np.asarray(lse)[..., 0]).reshape(1, H, S))
    want = {"dq": to(jdq), "dk": to(group(jdk)), "dv": to(group(jdv))}
    return inputs, to(out), lse_bhs, want


def share_of_tol(got, want, dtype):
    g, w = got.float(), want.float()
    tol = TRAIN_TOL_ULP[dtype] * w.abs() + TRAIN_TOL_F32 * w.abs().max()
    return ((g - w).abs() / tol).max().item()


def model_shares(case, d, dtype, split=PRODUCTS):
    (q, k, v, do), out, lse, want = pallas_case(case, d, dtype)
    causal, window, _ = CASES[case]
    got = kernel_model(q, k, v, out, lse, do, causal, window, split)
    assert all(t.dtype == dtype for t in got.values())
    return {n: share_of_tol(got[n], want[n], dtype) for n in PRODUCTS}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_pallas_within_train_tol(case, d, dtype):
    shares = model_shares(case, d, dtype)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("product", PRODUCTS)
def test_one_16bit_rounding_misses_where_the_kernels_split(product, dtype):
    """p (for dv) or ds (for dq, dk) rounded once to 16 bits, the other two
    products split as in the kernels: the output of that product misses
    the tolerance on at least one of the cases, so each split is needed."""
    others = tuple(p for p in PRODUCTS if p != product)
    worst = max(model_shares(case, d, dtype, others)[product]
                for case in CASES for d in (32, 64))
    assert worst > 1.0
