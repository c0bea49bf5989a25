"""The port's paged-KV substrate against the JAX package's.

``ops.attention.paged_gather``/``paged_attention``, ``core.decode``'s
``PagedView``, ``init_paged_arena``, the block helpers
(``gather_blocks``, ``scatter_blocks``, ``gather_slot_state``) and the
paged branch of the decode walker: a flat block arena read and written
through per-row block tables is a storage relayout, so paged prefill and
decode logits equal the dense cache's bit for bit at f32, and the JAX
package's paged ``_forward`` within f32 rounding.  The models are the JAX
serving tests' tiny LM (vocab 17, seq 32, d_model 16, 2 heads, 2 layers,
f32), one numpy weight set in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.core import decode as jdec
from distkeras_tpu.core import quant as jquant
from distkeras_tpu.ops.attention import paged_gather as jax_paged_gather
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.core import quant as pquant
from distkeras_tpu_torch.ops.attention import (dot_product_attention,
                                               paged_attention, paged_gather)
from test_torch_serving_fastpath import PROMPT, VOCAB, both

torch.set_num_threads(1)

B, MAX_LEN, BS = 2, 16, 4
NBLOCKS = B * (MAX_LEN // BS)


@pytest.fixture(scope="module")
def pair():
    return both(seed=6)


@pytest.fixture(scope="module")
def windowed():
    return both(seed=1, attention_window=6)


def _tables(b=B, max_len=MAX_LEN, bs=BS):
    """Row r owns blocks [r·n, (r+1)·n), n = max_len / bs; the last
    column is null."""
    n = max_len // bs
    bt = np.full((b, n + 1), b * n, np.int64)
    for r in range(b):
        bt[r, :n] = np.arange(n) + r * n
    return bt


def _prompts():
    return np.stack([PROMPT, PROMPT[::-1].copy()])


def _jax_view(bt, floor=None, ceil=None, qcap=None, view=MAX_LEN, **kw):
    def arr(x):
        return None if x is None else jnp.asarray(np.asarray(x, np.int32))
    return jdec.PagedView(arr(bt), BS, view, floor=arr(floor),
                          ceil=arr(ceil), qcap=arr(qcap), **kw)


def _view(bt, floor=None, ceil=None, qcap=None, view=MAX_LEN, **kw):
    def t(x):
        return None if x is None else torch.as_tensor(np.asarray(x,
                                                                 np.int64))
    return pdec.PagedView(t(bt), BS, view, floor=t(floor), ceil=t(ceil),
                          qcap=t(qcap), **kw)


# ---------------------------------------------------------------------------
# ops/attention.py
# ---------------------------------------------------------------------------

def test_paged_gather_layout_matches_jax():
    """Entry (r, p) of the view is arena slot ``table[r, p // bs] · bs +
    p % bs``; null entries read the null block, and logical blocks past
    the table read its trailing null column."""
    bs, nblocks = 2, 3
    arena = np.arange((nblocks + 1) * bs, dtype=np.float32)
    bt = np.asarray([[2, 0, 3], [1, 3, 3]], np.int64)
    view = paged_gather(torch.from_numpy(arena), torch.from_numpy(bt), bs,
                        6).numpy()
    np.testing.assert_array_equal(view[0], [4, 5, 0, 1, 6, 7])
    np.testing.assert_array_equal(view[1], [2, 3, 6, 7, 6, 7])
    want = jax_paged_gather(jnp.asarray(arena), jnp.asarray(bt, np.int32),
                            bs, 6)
    np.testing.assert_array_equal(view, np.asarray(want))


def test_paged_gather_of_trailing_axes_matches_jax():
    rng = np.random.default_rng(0)
    arena = rng.standard_normal(((NBLOCKS + 1) * BS, 2, 3)).astype(
        np.float32)
    bt = _tables()
    bt[1, 1] = NBLOCKS                   # a null entry mid-row
    got = paged_gather(torch.from_numpy(arena), torch.from_numpy(bt), BS,
                       MAX_LEN + 5).numpy()
    want = jax_paged_gather(jnp.asarray(arena), jnp.asarray(bt, np.int32),
                            BS, MAX_LEN + 5)
    assert got.shape == (B, MAX_LEN + 5, 2, 3)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_paged_attention_equals_dense_attention():
    """Attention over the block-table view equals attention over a dense
    cache holding the same entries, with every per-row hook."""
    rng = np.random.default_rng(1)
    h, hkv, d = 4, 2, 8
    arena_k = torch.from_numpy(rng.standard_normal(
        ((NBLOCKS + 1) * BS, hkv, d)).astype(np.float32))
    arena_v = torch.from_numpy(rng.standard_normal(
        ((NBLOCKS + 1) * BS, hkv, d)).astype(np.float32))
    bt = torch.from_numpy(_tables())
    q = torch.from_numpy(rng.standard_normal((B, 3, h, d)).astype(
        np.float32))
    k = paged_gather(arena_k, bt, BS, MAX_LEN)
    v = paged_gather(arena_v, bt, BS, MAX_LEN)
    pos = torch.tensor([5, 9])
    for kw in (dict(q_offset=pos, kv_length=pos + 3),
               dict(q_positions=torch.tensor([[5, 6, 6], [9, 10, 11]]),
                    kv_length=pos + 3, window=4)):
        got = paged_attention(q, arena_k, arena_v, bt, BS, MAX_LEN, **kw)
        want = dot_product_attention(q, k, v, causal=True, **kw)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# core/decode.py: the arena and the block helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_init_paged_arena_shapes_and_bytes_match_jax(pair, kv_dtype):
    jf, pf = pair
    arena = pdec.init_paged_arena(pf.model, NBLOCKS, BS, kv_dtype=kv_dtype)
    jarena = jdec.init_paged_arena(jf.model, NBLOCKS, BS, kv_dtype=kv_dtype)
    for c, jc in zip(arena, jarena):
        assert (c is None) == (jc is None)
        if c is None:
            continue
        assert sorted(c) == sorted(jc)
        for name in c:
            assert tuple(c[name].shape) == jc[name].shape
            assert c[name].shape[0] == (NBLOCKS + 1) * BS
            assert str(c[name].dtype).split(".")[-1] == str(jc[name].dtype)
    nbytes = pquant.kv_cache_bytes(arena)
    assert nbytes == pquant.kv_block_bytes(arena, BS) * (NBLOCKS + 1)
    assert nbytes == jquant.kv_cache_bytes(jarena)
    assert pquant.kv_block_bytes(arena, BS) == jquant.kv_block_bytes(
        jarena, BS)
    if kv_dtype == "int8":
        f32 = pquant.kv_cache_bytes(pdec.init_paged_arena(pf.model,
                                                          NBLOCKS, BS))
        assert nbytes < f32


def test_init_paged_arena_validation(pair):
    _, pf = pair
    for kw, match in ((dict(num_blocks=0, block_size=4), "num_blocks"),
                      (dict(num_blocks=4, block_size=0), "block_size"),
                      (dict(num_blocks=4, block_size=4, kv_dtype="int4"),
                       "kv_dtype")):
        with pytest.raises(ValueError, match=match):
            pdec.init_paged_arena(pf.model, **kw)


def test_gather_scatter_blocks_round_trip_and_slot_state(pair):
    """gather_blocks reads arena slots as JAX's does; scatter_blocks
    writes a payload into other slots in place, and the two round-trip;
    gather_slot_state returns the slot's frontier beside the blocks."""
    jf, pf = pair
    rng = np.random.default_rng(2)
    arena = pdec.init_paged_arena(pf.model, NBLOCKS, BS)
    jarena = []
    for c in arena:
        if c is not None:
            for t in c.values():
                t.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(t.shape)).astype(np.float32)))
        jarena.append(None if c is None else
                      {k: jnp.asarray(v.numpy()) for k, v in c.items()})
    src = (np.array([3, 1])[:, None] * BS + np.arange(BS)).reshape(-1)
    dst = (np.array([6, 0])[:, None] * BS + np.arange(BS)).reshape(-1)
    payload = pdec.gather_blocks(arena, torch.from_numpy(src))
    want = jdec.gather_blocks(jarena, jnp.asarray(src, np.int32))
    for c, jc in zip(payload, want):
        if c is not None:
            for name in c:
                np.testing.assert_array_equal(c[name].numpy(),
                                              np.asarray(jc[name]))
    out = pdec.scatter_blocks(arena, torch.from_numpy(dst), payload)
    assert out is arena
    back = pdec.gather_blocks(arena, torch.from_numpy(dst))
    for c, jc in zip(back, want):
        if c is not None:
            for name in c:
                np.testing.assert_array_equal(c[name].numpy(),
                                              np.asarray(jc[name]))
    tok = torch.tensor([5, 7], dtype=torch.int32)
    pos = torch.tensor([9, 3])
    keys = torch.tensor([[1, 2], [3, 4]])
    blocks, t, p, k = pdec.gather_slot_state(arena, torch.from_numpy(src),
                                             tok, pos, keys, 1)
    assert (int(t), int(p), k.tolist()) == (7, 3, [3, 4])
    assert len(blocks) == len(arena)


# ---------------------------------------------------------------------------
# the paged branch of the decode walker
# ---------------------------------------------------------------------------

def test_paged_prefill_and_decode_bit_identical_to_dense_and_jax(pair):
    """The same prefill and decode chain through a dense (B, S) cache and
    through the block arena gives bit-identical logits at every step, and
    the JAX package's paged walker's logits within f32 rounding."""
    jf, pf = pair
    model = pf.model
    prompt = _prompts()
    bt = _tables()
    zero = np.zeros((B,), np.int64)
    dense = pdec.init_cache(model, B, MAX_LEN)
    arena = pdec.init_paged_arena(model, NBLOCKS, BS)
    jarena = jdec.init_paged_arena(jf.model, NBLOCKS, BS)
    ld, dense = pdec._forward(model, dense, torch.from_numpy(prompt), 0)
    kw = dict(floor=zero, ceil=np.full((B,), 4), qcap=np.full((B,), 3))
    lp, arena = pdec._forward(model, arena, torch.from_numpy(prompt),
                              torch.from_numpy(zero), paged=_view(bt, **kw))
    lj, jarena = jdec._forward(jf.model, jf.params, jarena,
                               jnp.asarray(prompt),
                               jnp.asarray(zero, np.int32),
                               paged=_jax_view(bt, **kw))
    torch.testing.assert_close(lp, ld, rtol=0, atol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=2e-5,
                               rtol=2e-5)
    tok = torch.argmax(ld[:, -1], dim=-1).to(torch.int32)
    pos = torch.full((B,), 4, dtype=torch.int64)
    for _ in range(6):
        ld, dense = pdec.decode_step(model, dense, tok, pos)
        lp, arena = pdec.decode_step(model, arena, tok, pos,
                                     paged=_view(bt))
        lj, jarena = jdec.decode_step(
            jf.model, jf.params, jarena, jnp.asarray(tok.numpy()),
            jnp.asarray(pos.numpy(), np.int32), paged=_jax_view(bt))
        torch.testing.assert_close(lp, ld, rtol=0, atol=0)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=2e-5,
                                   rtol=2e-5)
        tok = torch.argmax(ld, dim=-1).to(torch.int32)
        pos = pos + 1


def test_paged_suffix_prefill_over_a_shared_prefix(pair):
    """A prefix-hit admission's program: the suffix's queries start at the
    matched length, attend the prefix blocks another row wrote through
    the gather, and give the logits of the whole prompt's dense
    prefill."""
    _, pf = pair
    model = pf.model
    prompt = (np.arange(11) * 3 % VOCAB).astype(np.int32)[None]
    dense = pdec.init_cache(model, 1, MAX_LEN)
    ld, _ = pdec._forward(model, dense, torch.from_numpy(prompt), 0)
    arena = pdec.init_paged_arena(model, NBLOCKS, BS)
    writer = np.array([[0, 1, 2, 3, NBLOCKS]])
    pdec._forward(model, arena, torch.from_numpy(prompt[:, :8]),
                  torch.zeros(1, dtype=torch.int64),
                  paged=_view(writer, floor=[0], ceil=[8], qcap=[7]))
    # the sharer: blocks 0-1 shared, 5-6 its own; suffix padded to 4
    sharer = np.array([[0, 1, 5, 6, NBLOCKS]])
    suffix = np.zeros((1, 4), np.int32)
    suffix[0, :3] = prompt[0, 8:]
    before = [c["k"][:2 * BS].clone() for c in arena if c is not None]
    lp, arena = pdec._forward(model, arena, torch.from_numpy(suffix),
                              torch.full((1,), 8, dtype=torch.int64),
                              paged=_view(sharer, floor=[8], ceil=[11],
                                          qcap=[10]))
    torch.testing.assert_close(lp[:, :3], ld[:, 8:], rtol=0, atol=0)
    after = [c["k"][:2 * BS] for c in arena if c is not None]
    for a, b in zip(before, after):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_paged_write_floor_protects_shared_blocks(pair):
    """Writes below a row's ``floor`` land in the null block: a sharer can
    run the forward over a prompt whose prefix blocks belong to another
    request without touching them, while positions at or above the floor
    write their own block."""
    _, pf = pair
    arena = pdec.init_paged_arena(pf.model, 4, BS)
    bt = np.array([[0, 1, 4]])
    li = [i for i, c in enumerate(arena) if c is not None][0]
    before = arena[li]["k"][:BS].clone()
    _, arena = pdec._forward(pf.model, arena, torch.from_numpy(PROMPT[None]),
                             torch.full((1,), 4, dtype=torch.int64),
                             paged=_view(bt, floor=[4], ceil=[8], view=8))
    torch.testing.assert_close(arena[li]["k"][:BS], before, rtol=0, atol=0)
    assert arena[li]["k"][BS:2 * BS].abs().sum() > 0


def test_paged_ring_decode_bit_identical_to_dense_ring(windowed):
    """A paged ring (``ring=True``, view = the window) decodes with the
    dense rolling cache's logits, bit for bit, past several wraps."""
    _, pf = windowed
    model = pf.model
    w, bs = 6, 2
    n = -(-w // bs)
    bt = np.full((B, n + 1), B * n, np.int64)
    for r in range(B):
        bt[r, :n] = np.arange(n) + r * n
    dense = pdec.init_cache(model, B, MAX_LEN, rolling=True)
    arena = pdec.init_paged_arena(model, B * n, bs)
    view = pdec.PagedView(torch.from_numpy(bt), bs, w, ring=True)
    tok = torch.tensor([3, 5], dtype=torch.int32)
    pos = torch.tensor([0, 0])
    for _ in range(14):
        ld, dense = pdec.decode_step(model, dense, tok, pos, rolling=True)
        lp, arena = pdec.decode_step(model, arena, tok, pos, paged=view)
        torch.testing.assert_close(lp, ld, rtol=0, atol=0)
        tok = torch.argmax(ld, dim=-1).to(torch.int32)
        pos = pos + 1


def test_paged_int8_arena_matches_the_dense_int8_cache(pair):
    """The int8 arena pages codes and scales like the entries: paged
    decode over it gives the dense int8 cache's logits, and the JAX int8
    arena's within f32 rounding."""
    jf, pf = pair
    model = pf.model
    bt = _tables()
    dense = pdec.init_cache(model, B, MAX_LEN, kv_dtype="int8")
    arena = pdec.init_paged_arena(model, NBLOCKS, BS, kv_dtype="int8")
    jarena = jdec.init_paged_arena(jf.model, NBLOCKS, BS, kv_dtype="int8")
    tok = torch.tensor([3, 9], dtype=torch.int32)
    for p in range(6):
        pos = torch.full((B,), p, dtype=torch.int64)
        ld, dense = pdec.decode_step(model, dense, tok, pos)
        lp, arena = pdec.decode_step(model, arena, tok, pos,
                                     paged=_view(bt))
        lj, jarena = jdec.decode_step(
            jf.model, jf.params, jarena, jnp.asarray(tok.numpy()),
            jnp.asarray(pos.numpy(), np.int32), paged=_jax_view(bt))
        torch.testing.assert_close(lp, ld, rtol=0, atol=0)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=2e-5,
                                   rtol=2e-5)
        tok = torch.argmax(ld, dim=-1).to(torch.int32)


def test_paged_walker_refusals(pair, windowed):
    _, pf = pair
    arena = pdec.init_paged_arena(pf.model, NBLOCKS, BS)
    with pytest.raises(ValueError, match="per-row"):
        pdec._forward(pf.model, arena, torch.from_numpy(_prompts()), 0,
                      paged=_view(_tables()))
    _, pw = windowed
    arena = pdec.init_paged_arena(pw.model, NBLOCKS, BS)
    with pytest.raises(ValueError, match="window"):
        pdec._forward(pw.model, arena, torch.from_numpy(_prompts()),
                      torch.zeros(B, dtype=torch.int64),
                      paged=_view(_tables(), view=6, ring=True))
