"""The SIMT backward's split-TF32 arithmetic (``csrc/flash_attention_bwd.cu``)
as far as a machine without a card can check it.

The kernels run every product of the flash backward on the TF32 tensor
cores (``mma.sync.m16n8k8``, f32 accumulators).  An f32 operand x is split
into hi = cvt.rna.tf32(x) (round to nearest, ties away, on the f32 bit
pattern) and lo = x - hi, which the MMA reads truncated to TF32; a . b is
lo_a . hi_b + hi_a . lo_b + hi_a . hi_b.  bf16 and f16 values are exact in
TF32, so q . k and dO . v of 16-bit inputs take one pass and the products
of p or ds with a 16-bit operand two.

Here that arithmetic is modelled in plain torch block by block as the
kernels run it: each MMA step's truncating accumulation (``mma``), s and dp
summed over the head dim in the order of the block's 128-column chunk, each
streamed tile split between the two warps of a pair, Δ summed as the dq
kernel sums it, p through exp2 with log2(e) folded in.  The model is held
against the JAX Pallas kernels in interpret mode and against the port's
plain version run in f64, within ``chip_smoke.py``'s per-element rule
(``TRAIN_TOL_ULP`` of the value + ``TRAIN_TOL_F32`` of the tensor's largest
value), and its error against the kernels' own on the card at the same
inputs (``tools/simt_backward_share.py``).  The error of one unsplit TF32
pass is reported beside it, not asserted.  A source check pins the kernels'
TF32 MMAs, the absence of atomics, and both C entries with their 8
pointers.
"""

import functools
import importlib
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.flash_attention import _flash_backward, _flash_forward
from distkeras_tpu_torch import kernels

flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import simt_backward_share as card  # noqa: E402  (no JAX, torch lazily)

torch.set_num_threads(1)

# chip_smoke.py's per-element tolerance of the training kernels against
# their plain versions: |got - want| <= ulp * |want| + 1e-4 * max|want|
TRAIN_TOL_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
                 torch.float16: 2.0 ** -10}
TRAIN_TOL_F32 = 1e-4
LOG2E = 1.4426950408889634
CHUNK = 128  # the kernels' widest tile; wider head dims go in chunks
SOURCE = "flash_attention_bwd"
TF32_DROPPED = -0x2000  # clears the 13 mantissa bits that TF32 drops
# the bits an MMA step keeps of each addend below the largest one's leading
# bit: f32's 24 and 2 more, with which the model's largest errors agree
# with the card's (test_model_error_matches_the_card)
ALIGN_BITS = 24 + 2


def tf32_rna(x):
    """cvt.rna.tf32.f32: round the f32 bit pattern to 10 mantissa bits,
    to nearest with ties away from zero (the pattern is sign-magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & TF32_DROPPED).view(torch.float32)


def tf32_trunc(x):
    """How the MMA reads an f32 pattern as TF32: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & TF32_DROPPED).view(
        torch.float32)


def rz_f32(x):
    """f64 to f32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mma(acc, a, b, eq):
    """One m16n8k8 step, acc + a . b over its (up to) 8 k, on TF32 values,
    as the tensor cores sum it: each product exact; the products and acc
    aligned to the largest of them and truncated toward zero ALIGN_BITS
    below its leading bit; summed; the sum truncated to f32 (round toward
    zero).  The MMA does not round to nearest: its ulps are lost in one
    direction, step after step."""
    ka, rest = eq.split(",")
    kb, out = rest.split("->")
    k = next(x for x in ka if x not in out)
    terms = torch.einsum(f"{ka},{kb}->{out}{k}", a.double(), b.double())
    terms = torch.cat([acc.double().expand(terms.shape[:-1])[..., None],
                       terms], -1)
    _, top = torch.frexp(terms.abs().amax(-1, keepdim=True))
    unit = torch.ldexp(torch.ones(top.shape, dtype=torch.float64),
                       top - ALIGN_BITS)
    return rz_f32((torch.trunc(terms / unit) * unit).sum(-1))


def mma_split(acc, a, b, split_a, split_b, eq, one_pass=False):
    """acc + a . b over one k step as mma_split in the kernels: a split
    operand as hi = cvt.rna(x) and lo = x - hi (read truncated to TF32),
    the small terms first, hi . hi last, one truncating MMA each; an
    unsplit operand (a 16-bit value, exact in TF32) as it is.
    ``one_pass``: both operands rounded once to TF32, one MMA."""
    if one_pass:
        return mma(acc, tf32_rna(a), tf32_rna(b), eq)
    ah, bh = (tf32_rna(a) if split_a else a), (tf32_rna(b) if split_b else b)
    if split_a:
        acc = mma(acc, tf32_trunc(a - ah), bh, eq)
    if split_b:
        acc = mma(acc, ah, tf32_trunc(b - bh), eq)
    return mma(acc, ah, bh, eq)


def hidden(qpos, kpos, s, causal, window):
    hide = (kpos >= s) | (qpos >= s)
    if causal:
        hide = hide | (kpos > qpos)
        if window is not None:
            hide = hide | (kpos <= qpos - window)
    return hide


def tile_rows(d):
    """Rows of the kernels' streamed tile: keys (dq) or q rows (dk/dv)."""
    return 32 if d > 64 else 64


def chunks(d, zc):
    """The head-dim column ranges over which a block that owns output chunk
    ``zc`` sums s and dp, in its order (chunk_of): the whole head dim up to
    CHUNK; above it the 128-column chunks, the others in order and ``zc``
    last."""
    if d <= CHUNK:
        return [(0, d)]
    n = -(-d // CHUNK)
    return [(c * CHUNK, min(d, (c + 1) * CHUNK))
            for c in [c for c in range(n) if c != zc] + [zc]]


def head_dim_sum(a, b, d, zc, split, eq, one_pass):
    """s = a . bᵀ (or dp) as the block owning chunk ``zc`` sums it: one
    accumulator over the 8-column MMA steps of every chunk in its order."""
    acc = torch.zeros(())
    for c0, c1 in chunks(d, zc):
        for k0 in range(c0, c1, 8):
            cols = slice(k0, min(k0 + 8, c1))
            acc = mma_split(acc, a[..., cols], b[..., cols], split, split, eq,
                            one_pass)
    return acc


def delta_model(dout, out):
    """Δ = rowsum(dO o O) as the dq kernel sums it, (B, H, S) f32: lane l of
    a warp sums columns l, l + 32, ... with fmaf, then the lanes are added
    in an xor butterfly (offsets 16, 8, 4, 2, 1)."""
    do, o = dout.double(), out.double()
    lanes = torch.zeros(*do.shape[:3], 32)
    for j in range(0, do.shape[-1], 32):
        pad = (0, max(0, j + 32 - do.shape[-1]))
        prod = torch.nn.functional.pad(do[..., j:j + 32] * o[..., j:j + 32],
                                       pad)
        lanes = (lanes.double() + prod).float()
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ off]
    return lanes[..., 0].transpose(1, 2)


def p_ds(s, dp, lse, delta, hide, scale):
    """p = exp2(fmaf(s, scale log2(e), -lse log2(e))) masked and
    ds = p o (dp - Δ) o scale, in f32 in the kernels' order; ``lse`` and
    ``delta`` broadcast against s."""
    c = torch.tensor(scale) * torch.tensor(LOG2E, dtype=torch.float32)
    lse2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    p = torch.exp2((s.double() * c.double() - lse2.double()).float())
    p = p.masked_fill(hide, 0.0)
    return p, p * (dp - delta) * torch.tensor(scale)


def tile_product(acc, x, tile, lo, n_rows, split, eq, one_pass):
    """acc + x . tile over rows [lo, lo + n_rows) of the streamed tile, as a
    warp's tile_product: a fresh accumulator summed over the 8-row MMA
    steps (x always split), then added to acc with an f32 add."""
    part = torch.zeros(())
    for r0 in range(lo, lo + n_rows, 8):
        rows = slice(r0, r0 + 8)
        part = mma_split(part, x[..., rows], tile[..., rows, :], True, split,
                         eq, one_pass)
    return acc + part


def kernel_model(q, k, v, out, lse, dout, causal, window, one_pass=False):
    """The SIMT backward's arithmetic in plain torch, from (B, S, H, D) q,
    out, dout, (B, S, Hkv, D) k, v and the f32 (B, H, S) lse, block by
    block as the kernels run it: s = q . kᵀ and dp = dO . vᵀ summed in
    truncating MMA steps over the head dim in the order of the block's
    chunk (split for f32 inputs); p and ds as p_ds; Δ as delta_model; each
    streamed tile (keys for dq, q rows for dk/dv) split between the two
    warps of a pair, each summing its half in a fresh accumulator added to
    its own running sum, tile after tile (dk/dv: over the G query heads,
    then their q tiles); the pair's two sums added once; each output
    rounded once to the input dtype."""
    dt = q.dtype
    split = dt == torch.float32
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = float(torch.tensor(d ** -0.5, dtype=torch.float32))
    bt = tile_rows(d)
    sp = -(-s // bt) * bt  # rows and keys padded to whole tiles, as zeros
    pad = lambda t: torch.nn.functional.pad(
        t.float().transpose(1, 2), (0, 0, 0, sp - s))  # (B, heads, sp, D)
    q32, k32, v32, do32 = (pad(t) for t in (q, k, v, dout))
    k32r, v32r = (t.repeat_interleave(g, 1) for t in (k32, v32))
    lse_p = torch.nn.functional.pad(lse.float(), (0, sp - s))
    delta = torch.nn.functional.pad(delta_model(dout, out), (0, sp - s))
    pos = torch.arange(sp)
    hide = hidden(pos[:, None], pos[None, :], s, causal, window)  # (q, k)
    n_dc = -(-d // CHUNK) if d > CHUNK else 1
    half = bt // 2
    sums = functools.partial(head_dim_sum, d=d, split=split,
                             one_pass=one_pass)
    grads = {n: torch.zeros(b, sp, x, d) for n, x in
             (("dq", h), ("dk", hkv), ("dv", hkv))}
    for zc in range(n_dc):
        c0, c1 = (zc * CHUNK, min(d, (zc + 1) * CHUNK)) if n_dc > 1 \
            else (0, d)
        # dq: one block per 64 q rows; the pair's warps take the two
        # halves of every key tile
        sc = sums(q32, k32r, zc=zc, eq="bhqd,bhkd->bhqk")
        dpc = sums(do32, v32r, zc=zc, eq="bhqd,bhkd->bhqk")
        _, ds = p_ds(sc, dpc, lse_p[..., None], delta[..., None], hide,
                     scale)
        acc = [torch.zeros(b, h, sp, c1 - c0) for _ in range(2)]
        for k0 in range(0, sp, bt):
            for hf in range(2):
                acc[hf] = tile_product(acc[hf], ds, k32r[..., c0:c1],
                                       k0 + hf * half, half, split,
                                       "bhqk,bhkd->bhqd", one_pass)
        grads["dq"][..., c0:c1] = (acc[0] + acc[1]).transpose(1, 2)
        # dk/dv: one block per 64 keys, over each kv head's G query heads
        # and their q tiles; the pair's warps take the two halves of
        # every q tile
        dk_acc = [torch.zeros(b, hkv, sp, c1 - c0) for _ in range(2)]
        dv_acc = [torch.zeros(b, hkv, sp, c1 - c0) for _ in range(2)]
        for gi in range(g):
            heads = torch.arange(hkv) * g + gi
            qh, doh = q32[:, heads], do32[:, heads]
            st = sums(k32, qh, zc=zc, eq="bhkd,bhqd->bhkq")
            dpt = sums(v32, doh, zc=zc, eq="bhkd,bhqd->bhkq")
            pt, dst = p_ds(st, dpt, lse_p[:, heads, None, :],
                           delta[:, heads, None, :], hide.T, scale)
            for q0 in range(0, sp, bt):
                for hf in range(2):
                    lo = q0 + hf * half
                    dv_acc[hf] = tile_product(dv_acc[hf], pt,
                                              doh[..., c0:c1], lo, half,
                                              split, "bhkq,bhqd->bhkd",
                                              one_pass)
                    dk_acc[hf] = tile_product(dk_acc[hf], dst,
                                              qh[..., c0:c1], lo, half,
                                              split, "bhkq,bhqd->bhkd",
                                              one_pass)
        grads["dk"][..., c0:c1] = (dk_acc[0] + dk_acc[1]).transpose(1, 2)
        grads["dv"][..., c0:c1] = (dv_acc[0] + dv_acc[1]).transpose(1, 2)
    return {n: x[:, :s].to(dt) for n, x in grads.items()}


# causal, window, kv heads (of H query heads); S = 80 = 64 + 16: the
# kernels' last tile is ragged (rows and keys >= S masked); the Pallas
# kernels take it in 16-row blocks
CASES, S, H = card.CASES, card.S, card.H
PALLAS_BLOCK = 16
OUTPUTS = ("dq", "dk", "dv")


@functools.lru_cache(maxsize=None)
def case_data(case, d, dtype):
    """Inputs from a numpy seed; the Pallas forward's (out, lse) on them;
    the Pallas backward's (dq, dk, dv) and the port's plain version's in
    f64, both from that (out, lse), in the port's contract.  The JAX
    kernels take equal head counts, so they get k and v repeated and their
    dk, dv are summed over each kv head's query heads in f32; 16-bit inputs
    go to both as f32 copies of the 16-bit values, and every output is
    rounded once to the dtype."""
    causal, window, hkv = CASES[case]
    rng = np.random.default_rng(d * 10 + hkv + (window or 0))
    q, do = (rng.standard_normal((1, S, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, S, hkv, d)).astype(np.float32)
            for _ in range(2))
    inputs = tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    q, k, v, do = (t.float().numpy() for t in inputs)
    g = H // hkv
    jq, jk, jv, jdo = (jnp.asarray(a) for a in
                       (q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2),
                        do))
    scale = d ** -0.5
    jout, jlse = _flash_forward(jq, jk, jv, scale, causal, PALLAS_BLOCK,
                                PALLAS_BLOCK, True, save_residuals=True,
                                window=window)
    out = torch.from_numpy(np.array(jout)).to(dtype)
    jdq, jdk, jdv = _flash_backward(jq, jk, jv, jnp.asarray(out.float()),
                                    jlse, jdo, scale, causal, PALLAS_BLOCK,
                                    PALLAS_BLOCK, True, window=window)
    group = lambda t: np.asarray(t).reshape(1, S, hkv, g, d).sum(3)
    to = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype)
    lse = torch.from_numpy(
        np.array(np.asarray(jlse)[..., 0]).reshape(1, H, S))
    pallas = {"dq": to(jdq), "dk": to(group(jdk)), "dv": to(group(jdv))}
    f64 = [t.double() for t in (*inputs, out)]
    tq, tk, tv, tdo, tout = f64
    rdq, rdelta = flash_mod.flash_attention_bwd_dq_reference(
        tq, tk, tv, tout, lse.double(), tdo, causal, None, window)
    rdk, rdv = flash_mod.flash_attention_bwd_dkv_reference(
        tq, tk, tv, lse.double(), tdo, rdelta, causal, None, window)
    plain = {"dq": rdq.to(dtype), "dk": rdk.to(dtype), "dv": rdv.to(dtype)}
    return inputs, out, lse, pallas, plain


def share_of_tol(got, want, dtype):
    g, w = got.double(), want.double()
    tol = TRAIN_TOL_ULP[dtype] * w.abs() + TRAIN_TOL_F32 * w.abs().max()
    return ((g - w).abs() / tol).max().item()


def model_shares(case, d, dtype, one_pass=False):
    """The model's largest error share of the tolerance per output, against
    the Pallas kernels and against the f64 plain version."""
    (q, k, v, do), out, lse, pallas, plain = case_data(case, d, dtype)
    causal, window, _ = CASES[case]
    got = kernel_model(q, k, v, out, lse, do, causal, window, one_pass)
    assert all(got[n].dtype == dtype and got[n].shape == pallas[n].shape
               for n in OUTPUTS)
    return ({n: share_of_tol(got[n], pallas[n], dtype) for n in OUTPUTS},
            {n: share_of_tol(got[n], plain[n], dtype) for n in OUTPUTS})


@pytest.mark.parametrize("d", [16, 64, 200, 320])
@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_split_model_matches_pallas_and_f64_within_train_tol(case, d):
    """f32 inputs, every product in three TF32 passes: within the f32 band
    of both references at head dims the kernels pad (16), take whole (64)
    and take in 128-column chunks (200, 320)."""
    vs_pallas, vs_f64 = model_shares(case, d, torch.float32)
    assert max(vs_pallas.values()) <= 1.0, vs_pallas
    assert max(vs_f64.values()) <= 1.0, vs_f64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [36, 200])
def test_16bit_model_with_fewer_passes_matches_pallas_and_f64(dtype, d):
    """16-bit inputs that the SIMT kernels serve (a head dim that is not a
    multiple of 8, or above 128): q . k and dO . v in one pass, the
    products with p or ds in two, within one output ulp + the f32 band."""
    vs_pallas, vs_f64 = model_shares("causal_gqa", d, dtype)
    assert max(vs_pallas.values()) <= 1.0, vs_pallas
    assert max(vs_f64.values()) <= 1.0, vs_f64


@pytest.mark.parametrize("d", [64, 320])
def test_one_tf32_pass_error_is_reported(d, record_property):
    """The error share of one unsplit TF32 pass per product, beside the
    split model's on the same inputs (reported, not asserted: the split is
    what the kernels do; this shows what it buys)."""
    split = max(model_shares("causal_gqa", d, torch.float32)[1].values())
    one = max(model_shares("causal_gqa", d, torch.float32,
                           one_pass=True)[1].values())
    record_property("split_tf32_share_of_tol", split)
    record_property("one_pass_tf32_share_of_tol", one)
    print(f"D {d}: split-TF32 share {split:.3g}, one TF32 pass {one:.3g}")
    assert split <= 1.0


# the kernels' largest error share of the tolerance (of dq, dk, dv) at
# tools/simt_backward_share.py's inputs, as that script printed it on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit
CARD_SHARES = {
    ("causal_gqa", 16, "float32"): 0.009412450053047713,
    ("causal_gqa", 64, "float32"): 0.01862036461083602,
    ("causal_gqa", 320, "float32"): 0.06321253974034323,
    ("full_mha", 16, "float32"): 0.00950833257442753,
    ("full_mha", 64, "float32"): 0.028429801969148426,
    ("full_mha", 320, "float32"): 0.10378311404826193,
    ("window_gqa", 16, "float32"): 0.004227611205198947,
    ("window_gqa", 64, "float32"): 0.017695351728382862,
    ("window_gqa", 320, "float32"): 0.10666238251690266,
    ("causal_gqa", 36, "bfloat16"): 0.4170011363280965,
    ("causal_gqa", 36, "float16"): 0.6037280205267527,
    ("causal_gqa", 200, "bfloat16"): 0.8969313735382822,
    ("causal_gqa", 200, "float16"): 0.5999283835492139,
}


@pytest.mark.parametrize("case, d, dname", sorted(CARD_SHARES))
def test_model_error_matches_the_card(case, d, dname):
    """At the inputs on which the kernels were run on the card, the
    model's largest error share is within a fifth of the card's: the
    margin that the other tests show is the kernels' margin."""
    q, k, v, do, out, lse = card.inputs(case, d, dname)
    want = card.plain(q, k, v, do, out, lse, case)
    causal, window, _ = CASES[case]
    got = kernel_model(q, k, v, out, lse, do, causal, window)
    share = max(card.share_of_tol(got[n], want[n], dname) for n in OUTPUTS)
    assert 0.8 <= share / CARD_SHARES[(case, d, dname)] <= 1.25, share


def test_round_to_nearest_model_misses_the_card(monkeypatch):
    """The card-matching test can tell the MMA's accumulation apart: with
    each MMA step rounded to nearest instead of truncated, the model's
    largest error at D 320 falls far below the card's."""
    rounded = lambda acc, a, b, eq: (
        acc.double() + torch.einsum(eq, a.double(), b.double())).float()
    monkeypatch.setattr(sys.modules[__name__], "mma", rounded)
    case, d, dname = "causal_gqa", 320, "float32"
    q, k, v, do, out, lse = card.inputs(case, d, dname)
    want = card.plain(q, k, v, do, out, lse, case)
    got = kernel_model(q, k, v, out, lse, do, *CASES[case][:2])
    share = max(card.share_of_tol(got[n], want[n], dname) for n in OUTPUTS)
    assert share / CARD_SHARES[(case, d, dname)] < 0.5, share


def test_tf32_rounding_matches_cvt_rna():
    """hi keeps 10 mantissa bits rounded to nearest, ties away from zero;
    lo = x - hi is exact and hi + trunc(lo) is within 2^-21 of x."""
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4], dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0,
                                    1.0 + ulp]
    assert tf32_rna(one).item() == 1.0
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32))
    hi = tf32_rna(r)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - hi).abs() <= r.abs() * 2.0 ** -11).all()
    rebuilt = hi + tf32_trunc(r - hi)
    assert ((rebuilt - r).abs() <= r.abs() * 2.0 ** -21).all()


def test_simt_backward_source_uses_tf32_mmas_and_no_atomics():
    # the source with the header of TF32 helpers it shares with the forward
    text = (kernels.source_path(SOURCE).read_text()
            + (kernels.CSRC_DIR / "simt_mma.cuh").read_text())
    assert '#include "simt_mma.cuh"' in text
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert "cvt.rna.tf32.f32" in text
    assert "cp.async" in text
    # no atomic call or PTX atom/red instruction: sums are in a fixed order
    assert re.search(r"atomic\w*\s*\(|\batom\.|\bred\.", text) is None
    for banned in ("cublas", "cudnn", "scaled_dot_product", "torch/",
                   "cute/", "cutlass/"):
        assert banned not in text.lower()
    for replaced in ("_dq_kernel (:182", "_dkv_kernel (:221"):
        assert replaced in text
    for entry in flash_mod.BACKWARD_VARIANTS["simt"].values():
        assert flash_mod._ENTRIES[entry] == (SOURCE, 8)
        signature = re.search(r'extern "C" int ' + entry + r"\((.*?)\)",
                              text, re.S).group(1)
        params = [p.strip() for p in signature.split(",")]
        pointers = [p for p in params if "*" in p and p != "void* stream"]
        assert len(pointers) == 8, pointers
        assert params[8:] == ["int B", "int S", "int H", "int Hkv", "int D",
                              "int dtype", "float scale", "int causal",
                              "int window", "void* stream"]
    assert f"constexpr int kChunk = {CHUNK};" in text
