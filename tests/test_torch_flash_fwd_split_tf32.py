"""The SIMT forward's split-TF32 arithmetic (``csrc/flash_attention_fwd.cu``)
as far as a machine without a card can check it.

The kernel runs both products of the flash forward, s = (q . scale) . kᵀ
and o += p . v, on the TF32 tensor cores (``mma.sync.m16n8k8``, f32
accumulators).  An f32 operand x is split into hi = cvt.rna.tf32(x) and
lo = x - hi, which the MMA reads truncated to TF32; a . b is
lo_a . hi_b + hi_a . lo_b + hi_a . hi_b.  f32 q is scaled in f32 before the
split.  bf16 and f16 values are exact in TF32, so q . kᵀ of 16-bit inputs
takes one pass (then scaled in f32) and p (f32, never rounded) times a
16-bit v two.

Here that arithmetic is modelled in plain torch block by block as the
kernel runs it, with the backward model's MMA step (each step's truncating
accumulation, ``test_torch_flash_bwd_split_tf32.mma``): s summed in one
accumulator over the 8-column steps of the whole head dim in order (above
D 256 the kernel streams 128-column chunks in order, the same steps); each
key tile (32 keys at the 128- and 256-column widths, else 64) split
between the two warps of a pair, each running its own online softmax in
f32 (the quad's row max, exp2 with log2(e) folded in, each lane's l over
its own columns) and summing its p . v tile in a fresh accumulator that
is added to the rescaled output with an f32 fma; the pair's (m, l, acc)
joined once at the end in a fixed order; the lanes' l summed; o = acc / l
and lse = safe_m + log(l).  The model is held against the JAX Pallas kernel in
interpret mode and against the port's plain version run in f64, within
``chip_smoke.py``'s per-element ``KERNEL_TOL`` (f32: 2e-5 absolute;
16-bit: one output ulp + 1e-5) and lse within phase kernel_train's band,
and its error against the kernel's own on the card at the same inputs
(``tools/simt_forward_share.py``).  The error of one unsplit TF32 pass is
reported beside it, not asserted.  A source check pins the kernel's TF32
MMAs, the absence of atomics, and its C entry.
"""

import functools
import importlib
import math
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.flash_attention import _flash_forward
from distkeras_tpu_torch import kernels
from test_torch_flash_bwd_split_tf32 import LOG2E, mma_split

flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import simt_forward_share as card  # noqa: E402  (no JAX, torch lazily)

torch.set_num_threads(1)

KERNEL_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5),
              torch.float16: (2.0 ** -10, 1e-5)}
LSE_TOL_F32 = card.TRAIN_TOL_F32
SOURCE = "flash_attention_fwd"
WHOLE, CHUNK = 256, 128  # the widest head dim taken whole; the chunks above
F32 = torch.float32


def tile_keys(d):
    """Keys of the kernel's streamed tile at head dim ``d``: 64 at the 32-
    and 64-column widths and in the 128-column chunks above D 256, 32 at
    the 128- and 256-column widths."""
    return 32 if 64 < d <= WHOLE else 64


def hidden(qpos, kpos, s, causal, window):
    hide = (kpos >= s) | (qpos >= s)
    if causal:
        hide = hide | (kpos > qpos)
        if window is not None:
            hide = hide | (kpos <= qpos - window)
    return hide


def f32(x):
    return torch.tensor(x, dtype=F32)


def exp2_of(x):
    """exp2f(x * log2(e)) in f32, x already f32: the kernel's exponentials
    (one f32 multiply, then exp2)."""
    return torch.exp2(x * f32(LOG2E))


def fmaf(a, b, c):
    """a * b + c rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def kernel_model(q, k, v, causal, window, one_pass=False):
    """The SIMT forward's arithmetic in plain torch, from (B, S, H, D) q and
    (B, S, Hkv, D) k, v: (out in q's dtype, f32 (B, H, S) lse), block by
    block as the kernel runs it (the module docstring).  ``one_pass``: both
    products in one TF32 pass, each operand rounded once."""
    dt = q.dtype
    split = dt == F32
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = f32(1.0 / math.sqrt(d))  # the wrapper's float, as a C float
    bk = tile_keys(d)
    half = bk // 2
    sp = -(-s // 64) * 64  # rows and keys padded to whole tiles, as zeros
    pad = lambda t: torch.nn.functional.pad(
        t.float().transpose(1, 2), (0, 0, 0, sp - s))  # (B, heads, sp, D)
    q32 = pad(q)
    k32, v32 = (pad(t).repeat_interleave(g, 1) for t in (k, v))
    a = q32 * scale if split else q32
    sc = torch.zeros(())
    for c0 in range(0, d, 8):
        cols = slice(c0, c0 + 8)
        sc = mma_split(sc, a[..., cols], k32[..., cols], split, split,
                       "bhqd,bhkd->bhqk", one_pass)
    if not split:
        sc = sc * scale
    pos = torch.arange(sp)
    sc = sc.masked_fill(hidden(pos[:, None], pos[None, :], s, causal,
                               window), float("-inf"))

    warps = []
    for hf in range(2):  # the pair's two warps, each its half of every tile
        m = torch.full((b, h, sp, 1), float("-inf"))
        lanes = torch.zeros(b, h, sp, 4)  # l of each lane t's own columns
        acc = torch.zeros(b, h, sp, d)
        for k0 in range(hf * half, sp, bk):
            keys = slice(k0, k0 + half)
            st = sc[..., keys]
            new_m = torch.maximum(m, st.amax(-1, keepdim=True))
            safe = torch.where(new_m == float("-inf"), torch.zeros(()), new_m)
            corr = exp2_of(m - safe)
            p = exp2_of(st - safe)
            # lane t: columns 2t, 2t + 1 of each 8-key step, in order
            cols = p.reshape(b, h, sp, half // 8, 4, 2)
            total = torch.zeros(b, h, sp, 4)
            for n in range(half // 8):
                for e in range(2):
                    total = total + cols[..., n, :, e]
            lanes = fmaf(lanes, corr, total)
            part = torch.zeros(())
            for n0 in range(0, half, 8):
                part = mma_split(part, p[..., n0:n0 + 8],
                                 v32[..., k0 + n0:k0 + n0 + 8, :], True,
                                 split, "bhqk,bhkd->bhqd", one_pass)
            acc = fmaf(acc, corr, part)
            m = new_m
        warps.append((m, lanes, acc))
    (m0, l0, acc0), (m1, l1, acc1) = warps
    mm = torch.maximum(m0, m1)
    safe = torch.where(mm == float("-inf"), torch.zeros(()), mm)
    c0, c1 = exp2_of(m0 - safe), exp2_of(m1 - safe)
    lanes = fmaf(l0, c0, l1 * c1)
    l = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    denom = torch.where(l == 0, torch.ones(()), l)[..., None]
    out = fmaf(acc0, c0, acc1 * c1) / denom
    lse = (safe + torch.log(denom))[..., 0]
    return out.transpose(1, 2)[:, :s].to(dt), lse[..., :s]


# causal, window, kv heads (of H query heads); S = 80 = 64 + 16: the
# kernel's last q and key tiles are ragged (rows and keys >= S masked); the
# Pallas kernel takes it in 16-row blocks
CASES, S, H = card.CASES, card.S, card.H
PALLAS_BLOCK = 16
HEAD_DIMS = (16, 36, 64, 200, 320)


@functools.lru_cache(maxsize=None)
def case_data(case, d, dtype):
    """The card's inputs; the Pallas forward's (out, lse) on them and the
    port's plain version's in f64, in the port's contract.  The JAX kernel
    takes equal head counts, so it gets k and v repeated; 16-bit inputs go
    to it as f32 copies of the 16-bit values, and its output is rounded
    once to the dtype."""
    causal, window, hkv = CASES[case]
    q, k, v = card.inputs(case, d, str(dtype).split(".")[-1])
    g = H // hkv
    jq, jk, jv = (jnp.asarray(a) for a in
                  (q.float().numpy(), np.repeat(k.float().numpy(), g, axis=2),
                   np.repeat(v.float().numpy(), g, axis=2)))
    jout, jlse = _flash_forward(jq, jk, jv, d ** -0.5, causal, PALLAS_BLOCK,
                                PALLAS_BLOCK, True, save_residuals=True,
                                window=window)
    pallas = (torch.from_numpy(np.array(jout)).to(dtype),
              torch.from_numpy(np.array(np.asarray(jlse)[..., 0])
                               ).reshape(1, H, S))
    return (q, k, v), pallas, card.plain(q, k, v, case)


def shares(got, want, dtype):
    """(out's largest error share of KERNEL_TOL, lse's of LSE_TOL_F32 of
    its largest value)."""
    rel, atol = KERNEL_TOL[dtype]
    g, w = got[0].double(), want[0].double()
    out = ((g - w).abs() / (rel * w.abs() + atol)).max().item()
    gl, wl = got[1].double(), want[1].double()
    lse = ((gl - wl).abs().max() / (LSE_TOL_F32 * wl.abs().max())).item()
    return out, lse


def model_shares(case, d, dtype, one_pass=False):
    """The model's largest error shares (out, lse) against the Pallas kernel
    and against the f64 plain version."""
    (q, k, v), pallas, plain = case_data(case, d, dtype)
    got = kernel_model(q, k, v, *CASES[case][:2], one_pass=one_pass)
    assert got[0].dtype == dtype and got[0].shape == pallas[0].shape
    assert got[1].shape == pallas[1].shape
    return shares(got, pallas, dtype), shares(got, plain, dtype)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_split_model_matches_pallas_and_f64_within_kernel_tol(case, d):
    """f32 inputs, both products in three TF32 passes: the output within
    2e-5 of both references and the lse within the training band, at head
    dims the kernel pads (16, 36, 200), takes whole (64) and takes in
    128-column chunks (320)."""
    vs_pallas, vs_f64 = model_shares(case, d, torch.float32)
    assert max(vs_pallas) <= 1.0, vs_pallas
    assert max(vs_f64) <= 1.0, vs_f64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_16bit_model_with_fewer_passes_matches_pallas_and_f64(dtype, d):
    """16-bit inputs: q . k in one pass, scaled after; p . v in two; within
    one output ulp + 1e-5 of both references.  The kernel serves 16-bit
    inputs at D 36 and 320; the others show the same arithmetic."""
    vs_pallas, vs_f64 = model_shares("causal_gqa", d, dtype)
    assert max(vs_pallas) <= 1.0, vs_pallas
    assert max(vs_f64) <= 1.0, vs_f64


@pytest.mark.parametrize("d", [64, 320])
def test_one_tf32_pass_error_is_reported(d, record_property):
    """The error share of one unsplit TF32 pass per product, beside the
    split model's on the same inputs (reported, not asserted: the split is
    what the kernel does; this shows what it buys)."""
    split = model_shares("causal_gqa", d, torch.float32)[1][0]
    one = model_shares("causal_gqa", d, torch.float32, one_pass=True)[1][0]
    record_property("split_tf32_share_of_tol", split)
    record_property("one_pass_tf32_share_of_tol", one)
    print(f"D {d}: split-TF32 share {split:.3g}, one TF32 pass {one:.3g}")
    assert split <= 1.0


# the kernel's largest error share of KERNEL_TOL in out at
# tools/simt_forward_share.py's inputs, as that script printed it on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit
CARD_SHARES = {
    ("causal_gqa", 16, "float32"): 0.026822090148925778,
    ("causal_gqa", 36, "float32"): 0.053644180297851556,
    ("causal_gqa", 64, "float32"): 0.05960464477539062,
    ("causal_gqa", 200, "float32"): 0.2026557922363281,
    ("causal_gqa", 320, "float32"): 0.29206275939941406,
    ("full_mha", 16, "float32"): 0.017881393432617188,
    ("full_mha", 36, "float32"): 0.026822090148925778,
    ("full_mha", 64, "float32"): 0.04470348358154296,
    ("full_mha", 200, "float32"): 0.19073486328124997,
    ("full_mha", 320, "float32"): 0.3695487976074218,
    ("window_gqa", 16, "float32"): 0.035762786865234375,
    ("window_gqa", 36, "float32"): 0.06258487701416016,
    ("window_gqa", 64, "float32"): 0.07152557373046875,
    ("window_gqa", 200, "float32"): 0.22947788238525388,
    ("window_gqa", 320, "float32"): 0.3397464752197265,
    ("causal_gqa", 36, "bfloat16"): 0.5184577437496679,
    ("causal_gqa", 36, "float16"): 0.6536680685804025,
    ("causal_gqa", 320, "bfloat16"): 0.8931641680399065,
    ("causal_gqa", 320, "float16"): 0.9318044363791593,
}


def card_model_share(case, d, dname):
    """The model's largest out share at the card's inputs, against the
    plain version in f64, as tools/simt_forward_share.py measures the
    kernel's."""
    q, k, v = card.inputs(case, d, dname)
    want, _ = card.plain(q, k, v, case)
    got, _ = kernel_model(q, k, v, *CASES[case][:2])
    return card.out_share(got, want, dname)


@pytest.mark.parametrize("case, d, dname", sorted(CARD_SHARES))
def test_model_error_matches_the_card(case, d, dname):
    """At the inputs on which the kernel was run on the card, the model's
    largest error share is within a fifth of the card's: the margin that
    the other tests show is the kernel's margin."""
    share = card_model_share(case, d, dname)
    assert 0.8 <= share / CARD_SHARES[(case, d, dname)] <= 1.25, share


def test_round_to_nearest_model_misses_the_card(monkeypatch):
    """The card-matching test can tell the MMA's accumulation apart: with
    each MMA step rounded to nearest instead of truncated, the model's
    largest error at D 320 falls far below the card's."""
    rounded = lambda acc, a, b, eq: (
        acc.double() + torch.einsum(eq, a.double(), b.double())).float()
    monkeypatch.setitem(mma_split.__globals__, "mma", rounded)
    key = ("causal_gqa", 320, "float32")
    share = card_model_share(*key)
    assert share / CARD_SHARES[key] < 0.5, share


def test_simt_forward_source_uses_tf32_mmas_and_no_atomics():
    text = (kernels.source_path(SOURCE).read_text()
            + (kernels.CSRC_DIR / "simt_mma.cuh").read_text())
    assert '#include "simt_mma.cuh"' in text
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert "cvt.rna.tf32.f32" in text
    assert "cp.async" in text
    # p enters p . v from the accumulator registers
    assert "acc_as_a(p[n])" in text
    # no atomic call or PTX atom/red instruction: sums are in a fixed order
    assert re.search(r"atomic\w*\s*\(|\batom\.|\bred\.", text) is None
    for banned in ("cublas", "cudnn", "scaled_dot_product", "torch/",
                   "cute/", "cutlass/"):
        assert banned not in text.lower()
    assert "flash_attention.py :: _flash_kernel" in text
    entry = flash_mod.FORWARD_VARIANTS["simt"]
    assert flash_mod._ENTRIES[entry] == (SOURCE, 5)
    signature = re.search(r'extern "C" int ' + entry + r"\((.*?)\)", text,
                          re.S).group(1)
    params = [p.strip() for p in signature.split(",")]
    assert params == ["const void* q", "const void* k", "const void* v",
                      "void* o", "void* lse", "int B", "int S", "int H",
                      "int Hkv", "int D", "int dtype", "float scale",
                      "int causal", "int window", "void* stream"]
    assert f"constexpr int kWhole = {WHOLE};" in text
    assert f"constexpr int kChunk = {CHUNK};" in text
