"""Autoregressive decoding with a KV cache for Sequential causal LMs, port
of ``distkeras_tpu/core/decode.py``: the dense (B, S) cache and the
serving engine's paged arena (a flat pool of fixed-size blocks addressed
through per-row block tables, :class:`PagedView`).

One walker understands the sequence-model layer kinds (``Embedding``,
``PositionalEmbedding``, ``TransformerBlock``, ``LayerNormalization``,
``Dense``) and reuses their own parts (``_project``, the layers' forwards)
plus ``ops.attention.dot_product_attention`` through its ``q_offset``/
``kv_length``/``kv_positions`` hooks, so decode numerics are the full
forward's: there is no second attention.  No kernel of the port runs here,
as no Pallas kernel runs in the JAX walker.

``generate`` prefills the whole prompt in one batched forward, then runs
single-token steps.  The JAX package scans those steps inside one XLA
program; here they are an eager loop that never waits for the card: no
step reads a value back to the host, and ``eos``/``pad`` are applied with
``torch.where`` on the device, so the output keeps its static
(B, P + num_steps) shape.  Every path writes the caches in place (the JAX
scan's and the serving engine's buffers are donated the same way) and
returns them; the per-row (B,) paths drop writes past the cache's end as
the JAX scatter does, and take no value back to the host, so that the
serving engine can capture its decode step as a CUDA graph.  The paged
arena is written the same way: every index is routed inside the arena
(positions a row must not write go to its null block), so no write is
dropped and no index leaves the tensor.

Random draws follow one counter-based rule (:func:`random_bits`): the
bits of a draw are Threefry-2x32 (the block cipher of ``jax.random``) of
the request's key, two 32-bit words, over the counter (position, row ·
n + index), computed on the device by integer tensor ops.  A position's
draw is a function of (key, position, row) alone, as ``fold_in(rng,
pos)`` makes it in the JAX package; the card and the CPU draw the same
bits, a lone request through the serving engine draws what ``generate``
draws for row 0, and a batch of rows with keys of their own needs no
generator per row.  Sampling is Gumbel-max, as ``jax.random.categorical``;
the bits are not JAX's (its key derivation differs), so sampled paths
agree with the JAX package in their properties, not token for token.
Greedy paths, the filters and the beams agree exactly.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..device import torch_dtype
from .layers import (Dense, Embedding, LayerNormalization,
                     MultiHeadAttention, PositionalEmbedding,
                     TransformerBlock, _apply_activation, _project)
from .quant import dequantize_kv, quantize_kv

_STATELESS = (LayerNormalization, Dense)


def _check_supported(model) -> None:
    for layer in model.layers:
        if not isinstance(layer, (Embedding, PositionalEmbedding,
                                  TransformerBlock) + _STATELESS):
            raise ValueError(
                f"decode: unsupported layer kind {layer.kind!r} — KV-cache "
                "decoding walks Embedding/PositionalEmbedding/"
                "TransformerBlock/LayerNormalization/Dense sequences "
                "(the transformer_lm family)")
        if isinstance(layer, TransformerBlock) and not layer.causal:
            raise ValueError(
                "decode: TransformerBlock(causal=False) — autoregressive "
                "decoding is only meaningful for causal models, and the "
                "cached step would silently diverge from the full forward")


def _context_limit(model) -> Optional[int]:
    for layer in model.layers:
        if isinstance(layer, PositionalEmbedding):
            return layer.max_len
    return None


def _vocab_size(model) -> Optional[int]:
    for layer in model.layers:
        if isinstance(layer, Embedding):
            return layer.input_dim
    return None


def _validate_rolling(model) -> None:
    """Every block must carry a window for a ring cache to be sound:
    without one, old positions stay visible and must stay cached."""
    for layer in model.layers:
        if isinstance(layer, TransformerBlock) and \
                layer._mha().attention_window is None:
            raise ValueError(
                "rolling=True needs attention_window on every "
                "TransformerBlock: without a window, old positions stay "
                "visible and must stay cached")


def init_cache(model, batch: int, max_len: int,
               rolling: bool = False, kv_dtype: Optional[str] = None,
               ring_slack: int = 0) -> List[Any]:
    """One cache slot per layer, on the model's device: ``{"k", "v"}`` of
    shape (batch, max_len, num_kv_heads, key_dim) in the compute dtype for
    TransformerBlocks, None elsewhere.

    ``rolling=True`` (sliding-window models only): each block's cache is
    a ring of its ``attention_window`` slots (slot ``p % W`` holds
    position ``p``), so memory stays O(W) however long the continuation;
    ``ring_slack`` widens each ring by that many slots, which keeps
    multi-token per-row steps exact.  ``kv_dtype="int8"``: entries are
    int8 codes plus a per-(row, slot, head) f32 scale (``{"k", "v", "ks",
    "vs"}``), quantized at write time, dequantized in the attention read;
    they are written through the per-row decode paths only."""
    _check_supported(model)
    if rolling:
        _validate_rolling(model)
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got "
                         f"{kv_dtype!r}")
    limit = _context_limit(model)
    if limit is not None and max_len > limit:
        raise ValueError(
            f"cache max_len {max_len} exceeds the model's positional-"
            f"embedding range {limit} — positions past it have no trained "
            "embedding (the full forward rejects such sequences too)")
    dtype = torch_dtype(model.compute_dtype)
    dev = model.device
    caches: List[Any] = []
    for layer in model.layers:
        if isinstance(layer, TransformerBlock):
            mha = layer._mha()
            slots = max_len
            if rolling:
                slots = min(mha.attention_window + int(ring_slack), max_len)
            shape = (batch, slots, mha._kv_heads(), mha.key_dim)
            if kv_dtype == "int8":
                caches.append({
                    "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "ks": torch.zeros(shape[:3], device=dev),
                    "vs": torch.zeros(shape[:3], device=dev)})
            else:
                caches.append({
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            caches.append(None)
    return caches


class PagedView:
    """A paged-KV access threaded through the decode walker
    (``_forward(paged=...)``): ``tables`` (B, T) int64 per-row block
    tables on the device, ``page`` tokens per block and ``view`` the
    logical sequence length (Python ints).  ``floor``/``ceil`` (B,) bound
    each row's write range: logical positions below ``floor`` (a shared,
    refcounted prefix another request owns) or at/above ``ceil``
    (right-pad junk past the real prompt) are routed into the arena's
    null block instead.  ``qcap`` (B,) clamps pad query positions onto
    the last real position (``dot_product_attention(q_positions=)``).
    ``ring`` lays logical positions out modulo ``view`` (the paged form
    of the rolling ring: slot ``p % view`` holds position ``p``, through
    the block table)."""

    __slots__ = ("tables", "page", "view", "floor", "ceil", "qcap", "ring")

    def __init__(self, tables, page: int, view: int, floor=None, ceil=None,
                 qcap=None, ring: bool = False):
        self.tables = tables
        self.page = int(page)
        self.view = int(view)
        self.floor = floor
        self.ceil = ceil
        self.qcap = qcap
        self.ring = bool(ring)


def init_paged_arena(model, num_blocks: int, block_size: int,
                     kv_dtype: Optional[str] = None) -> List[Any]:
    """The paged slot pool's store, on the model's device: per
    TransformerBlock a flat arena of ``num_blocks + 1`` blocks laid out
    along axis 0, ``{"k", "v"}`` of shape ((num_blocks + 1) * block_size,
    num_kv_heads, key_dim) in the compute dtype (int8 codes plus
    ``{"ks", "vs"}`` per-entry f32 scales for ``kv_dtype="int8"``).
    Physical block b owns slots [b * block_size, (b + 1) * block_size);
    position p of a request whose table maps logical block
    ``p // block_size`` to b lives at slot ``b * block_size + p %
    block_size``.  The trailing block (id ``num_blocks``) is the null
    block: free slots' decode writes, right-pad prefill writes and warmup
    all go there, so no program touches a real request's blocks but its
    own.  Capacity is ``num_blocks × block_size`` tokens, allocated per
    request on demand, instead of ``batch × max_len`` up front."""
    _check_supported(model)
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got "
                         f"{kv_dtype!r}")
    if int(num_blocks) < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    if int(block_size) < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    arena_len = (int(num_blocks) + 1) * int(block_size)
    dtype = torch_dtype(model.compute_dtype)
    dev = model.device
    caches: List[Any] = []
    for layer in model.layers:
        if isinstance(layer, TransformerBlock):
            mha = layer._mha()
            shape = (arena_len, mha._kv_heads(), mha.key_dim)
            if kv_dtype == "int8":
                caches.append({
                    "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "ks": torch.zeros(shape[:2], device=dev),
                    "vs": torch.zeros(shape[:2], device=dev)})
            else:
                caches.append({
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            caches.append(None)
    return caches


def gather_blocks(caches, rows: torch.Tensor) -> List[Any]:
    """The arena slots named by ``rows`` (a flat (n,) int64 tensor of
    physical slot indices: block table rows expanded by the block size)
    out of a flat paged arena: per TransformerBlock a dict of (n, Hkv,
    Dh) payloads (int8 arenas also their (n, Hkv) scales).  Read-only,
    so gathering a shared prefix block is safe; callers pad ``rows`` with
    null-block slots to a fixed length."""
    return [None if c is None else
            {k: v.index_select(0, rows) for k, v in c.items()}
            for c in caches]


def scatter_blocks(caches, rows: torch.Tensor, payload) -> List[Any]:
    """Write ``payload`` (the :func:`gather_blocks` layout) into the
    arena slots ``rows``, in place, and return the caches.  Padding rows
    name the null block, where a write is harmless."""
    for c, p in zip(caches, payload):
        if c is not None:
            for k, v in c.items():
                v[rows] = p[k].to(v.dtype)
    return caches


def gather_slot_state(caches, rows: torch.Tensor, tok, pos, keys,
                      slot: int):
    """The arena slots named by ``rows`` (:func:`gather_blocks`) together
    with slot ``slot``'s device-resident decode frontier: its current
    unwritten token, its position and its key row, all read from the
    device tensors in one go."""
    return gather_blocks(caches, rows), tok[slot], pos[slot], keys[slot]


def _kv_quantized(cache) -> bool:
    """True for an int8 KV cache dict (codes + per-entry scales)."""
    return isinstance(cache, dict) and "ks" in cache


def _kv_write(cache, slots: torch.Tensor, k_t, v_t):
    """Write the (B, L, Hkv, Dh) k/v entries at the per-row slots (B, L)
    into ``cache``, in place, and return it; int8 caches quantize on
    write.  A slot outside the cache drops its write, as the JAX scatter
    does: the slot is clamped and gets its own value back.  One
    ``index_put_`` per token column, each with one index per row, so a
    later column overwrites an earlier one at the same slot in order, and
    nothing is read back to the host (a CUDA graph captures it)."""
    entries = {"k": k_t, "v": v_t}
    if _kv_quantized(cache):
        kq, ks = quantize_kv(k_t)
        vq, vs = quantize_kv(v_t)
        entries = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    n = cache["k"].shape[1]
    rows = torch.arange(slots.shape[0], device=slots.device)
    for i in range(slots.shape[1]):
        col = slots[:, i]
        keep = (col >= 0) & (col < n)
        safe = col.clamp(0, n - 1)
        for name, cur in cache.items():
            new = entries[name][:, i].to(cur.dtype)
            hit = keep.reshape((-1,) + (1,) * (cur.ndim - 2))
            cur[rows, safe] = torch.where(hit, new, cur[rows, safe])
    return cache


def _kv_read(cache, dtype):
    """The attention-side view of a cache: dense (codes × scales for int8
    caches)."""
    if _kv_quantized(cache):
        return (dequantize_kv(cache["k"], cache["ks"], dtype),
                dequantize_kv(cache["v"], cache["vs"], dtype))
    return cache["k"], cache["v"]


def _per_row(pos) -> bool:
    """True when ``pos`` is a (B,) per-row position vector rather than
    the scalar all-rows-share-one-position form."""
    return getattr(pos, "ndim", 0) == 1


def _scalar_write(cache, start: int, k_t, v_t):
    """Write k/v at slots [start, start + L) of every row, in place; the
    start clamps so that the write fits, as ``dynamic_update_slice``."""
    if _kv_quantized(cache):
        raise TypeError("int8 KV caches are written through the per-row "
                        "(B,) position paths; the scalar-position walker "
                        "keeps a full-precision cache")
    length = k_t.shape[1]
    start = min(max(int(start), 0), cache["k"].shape[1] - length)
    cache["k"][:, start:start + length] = k_t
    cache["v"][:, start:start + length] = v_t
    return cache


def _paged_write(cache, phys: torch.Tensor, k_t, v_t):
    """Write the (B, L, Hkv, Dh) k/v entries at the arena slots ``phys``
    (B, L), in place, in one ``index_put_`` per leaf (int8 arenas
    quantize on write).  Every index lies inside the arena; slots that
    several entries share are null-block slots, whose contents nothing
    reads unmasked."""
    entries = {"k": k_t, "v": v_t}
    if _kv_quantized(cache):
        kq, ks = quantize_kv(k_t)
        vq, vs = quantize_kv(v_t)
        entries = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    flat = phys.reshape(-1)
    for name, cur in cache.items():
        new = entries[name]
        cur[flat] = new.reshape((-1,) + new.shape[2:]).to(cur.dtype)
    return cache


def _paged_read(cache, paged: PagedView, cdtype):
    """The rows' logical (B, view, Hkv, Dh) K/V out of the arena through
    their block tables (codes × scales for int8 arenas)."""
    from ..ops.attention import paged_gather

    def view(name):
        return paged_gather(cache[name], paged.tables, paged.page,
                            paged.view)
    if _kv_quantized(cache):
        return (dequantize_kv(view("k"), view("ks"), cdtype),
                dequantize_kv(view("v"), view("vs"), cdtype))
    return view("k"), view("v")


def _paged_attend(mha: MultiHeadAttention, paged: PagedView, cache, q, k_t,
                  v_t, pos, idx, q_pos, cdtype):
    """The paged branch of :func:`_mha_forward`: scatter the L new
    entries of each row (positions ``idx``, (B, L)) at their block-table
    slots (positions below ``floor`` or at/above ``ceil`` into the null
    block), gather each row's logical view and attend with the dense
    path's per-row masks, the queries at ``q_pos``."""
    from ..ops.attention import dot_product_attention
    length = k_t.shape[1]
    bs, view = paged.page, paged.view
    window = mha.attention_window
    if paged.ring:
        if length > 1 and view < window + length - 1:
            raise ValueError(
                f"multi-token per-row steps on a paged ring need a view of "
                f">= window + L - 1 = {window + length - 1} slots, got "
                f"{view} — the oldest query's window would be overwritten "
                f"by the newest write")
        lidx = torch.remainder(idx, view)
    else:
        lidx = idx
    blk = torch.clamp(lidx // bs, max=paged.tables.shape[1] - 1)
    phys = torch.gather(paged.tables, 1, blk) * bs + lidx % bs
    null_phys = cache["k"].shape[0] - 1  # inside the null block
    if paged.floor is not None:
        phys = phys.masked_fill(idx < paged.floor.reshape(-1, 1), null_phys)
    if paged.ceil is not None:
        phys = phys.masked_fill(idx >= paged.ceil.reshape(-1, 1), null_phys)
    cache = _paged_write(cache, phys, k_t, v_t)
    k, v = _paged_read(cache, paged, cdtype)
    if paged.ring:
        # view slot j holds the newest position <= each row's write
        # frontier congruent to j mod view (negative = never written), as
        # in the dense ring
        front = pos[:, None] + (length - 1)
        j = torch.arange(view, device=pos.device)
        kv_positions = front - torch.remainder(front - j[None, :], view)
        out = dot_product_attention(q, k, v, causal=True, q_positions=q_pos,
                                    window=window, kv_positions=kv_positions)
    else:
        out = dot_product_attention(q, k, v, causal=True, q_positions=q_pos,
                                    kv_length=pos + length, window=window)
    return out, cache


def _mha_forward(mha: MultiHeadAttention, h, cache, pos, cdtype,
                 rolling: bool = False, paged: Optional[PagedView] = None):
    """Cached attention over (B, L, D) queries starting at position
    ``pos`` (an int, or a (B,) tensor: each row at its own position);
    writes k/v for those L positions into the cache and attends through
    ``ops.attention.dot_product_attention`` (the full forward's
    numerics).  Rolling caches need a ring of >= window + L - 1 slots for
    per-row L > 1 (``init_cache(ring_slack=...)``); the scalar rolling
    step is single-token.  ``paged`` (a :class:`PagedView`, per-row
    ``pos`` only): the cache is a flat block arena
    (:func:`init_paged_arena`) written and read through block tables, a
    storage relayout with the dense path's numerics.  Returns (out,
    cache)."""
    from ..ops.attention import dot_product_attention
    b, length = h.shape[0], h.shape[1]
    dh = mha.key_dim
    per_row = _per_row(pos)
    dev = h.device
    steps = torch.arange(length, device=dev)
    q_pos = None
    if paged is not None:
        if not per_row:
            raise ValueError("paged KV access needs per-row (B,) positions")
        idx = pos[:, None] + steps[None, :]                      # (B, L)
        q_pos = (idx if paged.qcap is None
                 else torch.minimum(idx, paged.qcap.reshape(-1, 1)))

    def proj(name, heads):
        bias = getattr(mha, "b" + name[1]) if mha.use_bias else None
        y = _project(h, getattr(mha, name), bias, cdtype)
        return y.to(cdtype).reshape(b, length, heads, dh)

    q = proj("wq", mha.num_heads)
    k_t = proj("wk", mha._kv_heads())
    v_t = proj("wv", mha._kv_heads())
    if mha.rope:
        # rotate by the queries' absolute positions; cached k keep the
        # rotation of their own positions (scores depend on distance)
        from ..ops.rope import apply_rope
        if q_pos is not None:
            positions = q_pos
        else:
            positions = (pos[:, None] + steps[None, :] if per_row
                         else pos + steps)
        q = apply_rope(q, positions, mha.rope_theta, mha.rope_scale)
        k_t = apply_rope(k_t, positions, mha.rope_theta, mha.rope_scale)
    window = mha.attention_window
    if paged is not None:
        out, cache = _paged_attend(mha, paged, cache, q, k_t, v_t, pos, idx,
                                   q_pos, cdtype)
    elif per_row:
        idx = pos[:, None] + steps[None, :]                      # (B, L)
        if rolling:
            w = cache["k"].shape[1]
            if length > 1 and w < window + length - 1:
                raise ValueError(
                    f"multi-token per-row steps on a rolling cache need a "
                    f"ring of >= window + L - 1 = {window + length - 1} "
                    f"slots, got {w} (init_cache(ring_slack=...)) — the "
                    f"oldest query's window would be overwritten by the "
                    f"newest write")
            cache = _kv_write(cache, torch.remainder(idx, w), k_t, v_t)
            # slot j holds the newest position <= each row's write
            # frontier congruent to j mod w (negative = never written)
            front = pos[:, None] + (length - 1)
            j = torch.arange(w, device=dev)
            kv_positions = front - torch.remainder(front - j[None, :], w)
            k, v = _kv_read(cache, cdtype)
            out = dot_product_attention(q, k, v, causal=True, q_offset=pos,
                                        window=window,
                                        kv_positions=kv_positions)
        else:
            cache = _kv_write(cache, idx, k_t, v_t)
            k, v = _kv_read(cache, cdtype)
            out = dot_product_attention(q, k, v, causal=True, q_offset=pos,
                                        kv_length=pos + length,
                                        window=window)
    elif rolling:
        # ring of the block's window: slot p % W holds position p.  Single
        # token writes only: generate() prefills a full cache, then
        # converts it (_to_ring)
        if length != 1:
            raise ValueError("rolling cache steps are single-token "
                             "(prefill uses a full cache, then converts)")
        w = cache["k"].shape[1]
        cache = _scalar_write(cache, pos % w, k_t, v_t)
        # slot j holds position pos - ((pos - j) mod W); slots not yet
        # written come out negative and mask themselves
        j = torch.arange(w, device=dev)
        kv_positions = pos - torch.remainder(pos - j, w)
        out = dot_product_attention(q, cache["k"], cache["v"], causal=True,
                                    q_offset=pos, window=window,
                                    kv_positions=kv_positions)
    else:
        cache = _scalar_write(cache, pos, k_t, v_t)
        out = dot_product_attention(q, cache["k"], cache["v"], causal=True,
                                    q_offset=pos, kv_length=pos + length,
                                    window=window)
    out = out.reshape(b, length, mha.num_heads * dh)
    y = _project(out, mha.wo, mha.bo if mha.use_bias else None, cdtype)
    return y, cache


def _block_forward(block: TransformerBlock, x, cache, pos, cdtype,
                   rolling: bool = False, paged: Optional[PagedView] = None):
    """``TransformerBlock.forward`` (train=False) with cached attention."""
    h = block.ln1(x, cdtype)
    h, cache = _mha_forward(block.attn, h, cache, pos, cdtype, rolling,
                            paged)
    x = x + h.to(x.dtype)
    h = block.ln2(x, cdtype)
    h = _project(h, block.mlp_w1, block.mlp_b1, cdtype)
    h = _apply_activation(block.activation, h).to(cdtype)
    h = _project(h, block.mlp_w2, block.mlp_b2, cdtype)
    return x + h.to(x.dtype), cache


@torch.no_grad()
def _forward(model, caches, toks, pos, rolling: bool = False,
             paged: Optional[PagedView] = None):
    """Walk the layer stack over (B, L) tokens starting at position
    ``pos``; returns ((B, L, V) f32 logits, caches).  L == 1 is a decode
    step, L == P the batched prompt prefill.  ``pos`` may be a (B,)
    per-row vector (each row at its own position).  ``paged``: the caches
    are a flat block arena read and written through per-row block tables
    (:class:`PagedView`)."""
    cdtype = torch_dtype(model.compute_dtype)
    length = toks.shape[1]
    x = None
    new_caches: List[Any] = []
    for layer, cache in zip(model.layers, caches):
        if isinstance(layer, PositionalEmbedding):
            table = layer.embedding
            if _per_row(pos):
                # row r's token i sits at pos[r] + i; positions past the
                # table clamp (their logits are junk no caller commits),
                # as the JAX gather clamps
                idx = pos[:, None] + torch.arange(length, device=x.device)
                pe = table[idx.clamp(0, table.shape[0] - 1)]   # (B, L, D)
                x = x + pe.to(x.dtype)
            else:
                start = min(max(int(pos), 0), table.shape[0] - length)
                x = x + table[start:start + length].to(x.dtype)[None]
        elif isinstance(layer, TransformerBlock):
            x, cache = _block_forward(layer, x, cache, pos, cdtype, rolling,
                                      paged)
        elif isinstance(layer, Embedding):
            x = layer(toks, cdtype)
        else:  # LayerNormalization / Dense: position-independent
            x = layer(x, cdtype)
        new_caches.append(cache)
    return x.to(torch.float32), new_caches


@torch.no_grad()
def decode_step(model, caches, tok, pos, rolling: bool = False,
                paged: Optional[PagedView] = None):
    """Advance one position.  tok: (B,) int current tokens; pos: an int
    position (0-based), or a (B,) int tensor advancing every row at its
    own position.  ``paged``: the caches are a flat block arena addressed
    through per-row block tables (the serving engine's paged pool): the
    same numerics, block-granular storage.  Returns (logits (B, V) f32,
    caches)."""
    logits, caches = _forward(model, caches, tok[:, None], pos, rolling,
                              paged)
    return logits[:, 0], caches


def jit_decode_step(model, rolling: bool = False):
    """The single-token entry point for serving loops that own their own
    sampling and stopping.  The JAX package returns a jitted program; in
    torch this returns the eager :func:`decode_step` bound to ``model``
    and ``rolling`` (``generate`` steps through the same function, so the
    numerics are identical)::

        caches = init_cache(model, batch, max_len)
        step = jit_decode_step(model)
        for pos in range(p_len, max_len):
            logits, caches = step(caches, tok, pos)
            tok = my_sampler(logits)
    """
    _check_supported(model)
    if rolling:
        _validate_rolling(model)

    def step(caches, tok, pos):
        return decode_step(model, caches, _tokens(tok, model.device), pos,
                           rolling)

    return step


def _tokens(x, device) -> torch.Tensor:
    """Token ids (a tensor, numpy array or list) as an int32 tensor on
    ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=torch.int32)


def _validate_sampling(temperature: float, rng,
                       top_k: Optional[int], top_p: Optional[float]):
    """The one sampling-surface rule set, shared by ``generate`` and
    ``speculative_generate``."""
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature > 0 sampling needs rng")
    if top_k is not None or top_p is not None:
        if temperature <= 0.0:
            raise ValueError(
                "top_k/top_p shape the SAMPLING distribution — pass "
                "temperature > 0 (greedy argmax ignores them)")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _validate_stopping(eos_id: Optional[int], pad_id: Optional[int],
                       vocab: Optional[int]):
    """The one eos_id/pad_id rule set, shared by ``generate`` and
    ``beam_search``: out-of-range ids are refused."""
    if pad_id is not None and eos_id is None:
        raise ValueError("pad_id only means something with eos_id")
    if eos_id is not None and vocab is not None \
            and not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id {eos_id} outside the model's vocabulary "
                         f"[0, {vocab}) — stopping could never trigger")
    if pad_id is not None and vocab is not None \
            and not 0 <= pad_id < vocab:
        raise ValueError(f"pad_id {pad_id} outside the model's vocabulary "
                         f"[0, {vocab})")


def _sort_desc(x: torch.Tensor):
    """Descending sort along the last axis that keeps equal values in
    index order, as ``jax.lax.top_k`` ranks ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _filter_logits(logits, top_k: Optional[int], top_p: Optional[float]):
    """Restrict (…, V) logits to the top-k tokens and/or the smallest
    nucleus whose probability mass reaches top_p (the top token always
    survives); filtered entries go to -inf.  k first, then p."""
    if top_k is not None:
        k = min(int(top_k), logits.shape[-1])  # k past vocab = keep all
        kth = _sort_desc(logits).values[..., k - 1:k]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_desc = _sort_desc(logits).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose preceding cumulative mass is < top_p (the top
        # token's is 0, so at least one survives); the cut logit is the
        # smallest kept one
        kept = torch.sum((cum - probs) < top_p, dim=-1, keepdim=True)
        cut = torch.gather(sorted_desc, -1, kept - 1)
        logits = logits.masked_fill(logits < cut, float("-inf"))
    return logits


_MASK32 = 0xFFFFFFFF
#: Threefry-2x32's rotation constants, four rounds each, alternating
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC 2011; the block cipher
    of ``jax.random``): the key words (k0, k1) encrypt the counter words
    (x0, x1).  Every argument is an int64 tensor (or int) of 32-bit words,
    broadcast together; returns the two output words.  Integer tensor ops
    only, so the card and the CPU compute the same bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) & _MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def rng_key(rng) -> Tuple[int, int]:
    """A request's key as two 32-bit words: an int seed ``s`` (mod 2^64)
    gives (s >> 32, s & 0xFFFFFFFF), as ``jax.random.PRNGKey`` splits a
    seed; a ``torch.Generator`` gives its seed's; two words (a sequence or
    array, e.g. a serving handle's ``key``) pass as they are."""
    if isinstance(rng, torch.Generator):
        rng = rng.initial_seed()
    if isinstance(rng, (int, np.integer)):
        seed = int(rng) % (1 << 64)
        return seed >> 32, seed & _MASK32
    words = np.asarray(rng).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"rng must be an int seed, a torch.Generator or "
                         f"two 32-bit key words, got {rng!r}")
    return int(words[0]) & _MASK32, int(words[1]) & _MASK32


def _key_rows(rng, b: int, device) -> torch.Tensor:
    """``rng``'s key for each of ``b`` rows: a (b, 2) int64 tensor, filled
    on ``device`` (no copy from the host)."""
    k0, k1 = rng_key(rng)
    return torch.stack([torch.full((b,), k0, dtype=torch.int64,
                                   device=device),
                        torch.full((b,), k1, dtype=torch.int64,
                                   device=device)], dim=1)


def random_bits(keys: torch.Tensor, counter: torch.Tensor,
                rows: torch.Tensor, n: int) -> torch.Tensor:
    """The one draw rule: (B, n) 32-bit words (in int64), word j of row r
    being Threefry-2x32 under row r's key ``keys[r]`` (two words) of the
    counter (``counter[r]``, ``rows[r]`` · n + j).  ``counter`` is the
    position (or a draw count), ``rows`` the row's index in its batch: 0
    for every row of the serving engine, whose rows carry keys of their
    own, and the batch row in ``generate``, whose rows share one key."""
    dev = keys.device
    j = torch.arange(n, dtype=torch.int64, device=dev)
    c0 = counter.to(torch.int64)[:, None] & _MASK32
    c1 = (rows.to(torch.int64)[:, None] * n + j[None, :]) & _MASK32
    keys = keys.to(torch.int64)
    x0, _ = threefry2x32(keys[:, 0:1], keys[:, 1:2], c0, c1)
    return x0


def _uniform(keys, counter, rows, n: int) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1) from :func:`random_bits`: the top 23
    bits, centred in their interval (exact in f32, never 0 or 1)."""
    bits = random_bits(keys, counter, rows, n) >> 9
    return (bits.to(torch.float32) + 0.5) * (2.0 ** -23)


def _categorical(keys, counter, rows, logits) -> torch.Tensor:
    """One draw per row from softmax(logits), by Gumbel-max (as
    ``jax.random.categorical``), with the bits of :func:`random_bits`: no
    value comes back to the host."""
    u = _uniform(keys, counter, rows, logits.shape[-1])
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits(logits, pos, temperature: float = 0.0, rng=None,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """The one per-step sampling rule: (B, V) f32 logits at absolute
    position ``pos`` → (B,) int32 next tokens.  temperature 0 = greedy
    argmax (the first of equal maxima); > 0 = :func:`sample_logits_batched`
    with every row's parameters equal and ``rng``'s key, row r drawing as
    row r of the batch, so that row 0 draws what a lone serving request
    with the same key draws at that position."""
    if temperature > 0.0:
        b, dev = logits.shape[0], logits.device

        def full(value, dtype):
            return torch.full((b,), value, dtype=dtype, device=dev)

        return sample_logits_batched(
            logits, full(int(pos), torch.int64),
            full(float(temperature), torch.float32),
            _key_rows(rng, b, dev), full(int(top_k or 0), torch.int64),
            full(float(top_p or 0.0), torch.float32),
            rows=torch.arange(b, device=dev))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_logits_batched(logits, top_k, top_p):
    """Per-row ``_filter_logits`` with per-row parameters on the device:
    ``top_k`` (B,) int (0 = off), ``top_p`` (B,) f32 (0 = off).  Row r with
    ``top_k[r] == K > 0`` and ``top_p[r] == P > 0`` computes what
    ``_filter_logits(row, K, P)`` computes (k first, then p); no value
    comes back to the host, so one captured step serves a slot batch with
    mixed sampling configurations."""
    dev, v = logits.device, logits.shape[-1]
    top_k = torch.as_tensor(top_k, device=dev).to(torch.int64)
    top_p = torch.as_tensor(top_p, device=dev).to(torch.float32)
    sorted_desc = _sort_desc(logits).values
    kth = torch.gather(sorted_desc, -1, (top_k.clamp(1, v) - 1)[:, None])
    logits = logits.masked_fill((top_k > 0)[:, None] & (logits < kth),
                                float("-inf"))
    # the p filter runs on the k-filtered logits, as _filter_logits
    sorted_desc = _sort_desc(logits).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    kept = torch.sum((cum - probs) < top_p[:, None], dim=-1, keepdim=True)
    cut = torch.gather(sorted_desc, -1, kept.clamp(min=1) - 1)
    return logits.masked_fill((top_p > 0)[:, None] & (logits < cut),
                              float("-inf"))


def sample_logits_batched(logits, positions, temperature, keys, top_k,
                          top_p, rows=None) -> torch.Tensor:
    """Per-row ``sample_logits``: every row carries its own sampling
    configuration, all on the device.  ``positions`` (B,) absolute
    positions; ``temperature`` (B,) f32 (<= 0 = greedy argmax for that
    row); ``keys`` (B, 2) per-row key words; ``top_k``/``top_p`` as in
    :func:`filter_logits_batched`; ``rows`` (B,) the rows' indices in the
    draw rule (default 0: each row is a request with a key of its own).
    Nothing comes back to the host, so the serving engine's decode step
    is captured with it."""
    dev = logits.device
    temp = torch.as_tensor(temperature, device=dev).to(torch.float32)
    positions = torch.as_tensor(positions, device=dev)
    keys = torch.as_tensor(keys, device=dev)
    sampled = temp > 0.0
    safe = torch.where(sampled, temp, torch.ones_like(temp))
    warped = filter_logits_batched(logits / safe[:, None], top_k, top_p)
    if rows is None:
        rows = torch.zeros_like(positions)
    drawn = _categorical(keys, positions, rows, warped)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(sampled, drawn, greedy).to(torch.int32)


def _to_ring(full_cache, p_len: int, window: int):
    """Convert a full prefill cache (positions 0..p_len-1 at slots
    0..p_len-1) into a W-slot ring where slot ``p % W`` holds position
    ``p``, keeping the last ``window`` positions."""
    if p_len >= window:
        # entries for positions p0..p_len-1 (p0 = p_len - W), in order;
        # rolling by p0 % W puts position p at slot p % W
        p0 = p_len - window
        last = full_cache[:, p0:p0 + window]
        return torch.roll(last, p0 % window, dims=1)
    # shorter prompt: positions 0..p_len-1 already sit at their slots;
    # grow/trim to W slots (the unwritten tail masks itself through
    # kv_positions)
    pad = window - full_cache.shape[1]
    if pad > 0:
        zeros = full_cache.new_zeros(full_cache.shape[:1] + (pad,)
                                     + full_cache.shape[2:])
        return torch.cat([full_cache, zeros], dim=1)
    return full_cache[:, :window]


def ring_from_prefill(full_cache, p_lens, window: int):
    """Per-row ``_to_ring``: (B, S, ...) full prefill cache rows → (B, W,
    ...) rings where slot ``p % W`` holds position ``p``, keeping each
    row's last ``window`` prompt positions; ``p_lens`` (B,) are the rows'
    prompt lengths.  Slots a short row never wrote come out zero."""
    w = int(window)
    dev = full_cache.device
    j = torch.arange(w, device=dev)
    p = torch.as_tensor(p_lens, device=dev).reshape(-1, 1).long()
    # ring slot j holds the newest prompt position congruent to j mod W;
    # rows shorter than W leave their tail slots negative (never written)
    q = (p - 1) - torch.remainder(p - 1 - j[None, :], w)          # (B, W)
    src = q.clamp(0, full_cache.shape[1] - 1)
    tail = (1,) * (full_cache.ndim - 2)
    rows = torch.gather(full_cache, 1, src.reshape(src.shape + tail).expand(
        src.shape + full_cache.shape[2:]))
    return torch.where((q >= 0).reshape(q.shape + tail), rows,
                       torch.zeros((), dtype=full_cache.dtype, device=dev))


def _check_total(model, p_len: int, num_steps: int, what: str = ""):
    limit = _context_limit(model)
    total = p_len + int(num_steps)
    if limit is not None and total > limit:
        raise ValueError(
            f"prompt ({p_len}) + num_steps ({num_steps}) = {total} exceeds "
            f"the {what}model's positional-embedding range {limit}")


@torch.no_grad()
def generate(model, prompt, num_steps: int, temperature: float = 0.0,
             rng=None, max_len: Optional[int] = None, rolling: bool = False,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             eos_id: Optional[int] = None,
             pad_id: Optional[int] = None) -> torch.Tensor:
    """Continue ``prompt`` (B, P) int tokens by ``num_steps`` tokens;
    returns (B, P + num_steps) int32 tokens on the model's device.

    temperature 0 = greedy argmax; > 0 = sampling (needs ``rng``: a
    ``torch.Generator``, an int seed or two key words; see
    :func:`rng_key`), with ``top_k``/``top_p``
    restricting each step's distribution (k first, then p).  ``eos_id``:
    once a row emits it, every later slot of that row is ``pad_id``
    (default: ``eos_id`` itself).  Prefill is one batched forward, the
    continuation an eager loop of single-token steps that never waits for
    the card.

    ``rolling=True`` (sliding-window models): after the prefill each
    block's cache collapses to a ring of its ``attention_window`` slots,
    so memory stays O(W): identical tokens to ``rolling=False``.
    """
    _check_supported(model)
    prompt = _tokens(prompt, model.device)
    b, p_len = prompt.shape
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    total = p_len + int(num_steps)
    if max_len is None:
        max_len = total
    if max_len < total:
        raise ValueError(f"max_len {max_len} < prompt+steps {total}")
    _check_total(model, p_len, num_steps)
    _validate_sampling(temperature, rng, top_k, top_p)
    _validate_stopping(eos_id, pad_id, _vocab_size(model))
    if rolling:
        # the prefill still uses a full P-slot cache (one batched
        # forward), which then collapses to rings
        _validate_rolling(model)
    if num_steps == 0:
        return prompt
    caches = init_cache(model, b, p_len if rolling else max_len)

    def sample(logits, pos):
        return sample_logits(logits, pos, temperature, rng, top_k, top_p)

    # prefill: all P prompt positions in one batched forward
    logits, caches = _forward(model, caches, prompt, 0)
    tok = sample(logits[:, -1], p_len - 1)
    if rolling:
        caches = [None if cache is None else
                  {name: _to_ring(t, p_len, layer._mha().attention_window)
                   for name, t in cache.items()}
                  for layer, cache in zip(model.layers, caches)]

    pad = torch.tensor(pad_id if pad_id is not None else (eos_id or 0),
                       dtype=torch.int32, device=prompt.device)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    out = [prompt]
    for i in range(int(num_steps) - 1):
        pos = p_len + i
        logits, caches = decode_step(model, caches, tok, pos, rolling)
        nxt = sample(logits, pos)
        if eos_id is not None:
            # rows whose current token is eos (or that finished earlier)
            # emit padding from the next slot on
            done = done | (tok == eos_id)
            nxt = torch.where(done, pad, nxt)
        out.append(tok[:, None])
        tok = nxt
    out.append(tok[:, None])
    return torch.cat(out, dim=1)


@torch.no_grad()
def speculative_generate(model, draft_model, prompt, num_steps: int,
                         draft_len: int = 4, max_len: Optional[int] = None,
                         temperature: float = 0.0, rng=None,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         eos_id: Optional[int] = None,
                         pad_id: Optional[int] = None,
                         return_stats: bool = False):
    """Decoding accelerated by a cheaper draft model, distribution-exact.

    ``temperature == 0``: every committed token is the target's own
    argmax, from the batched verify forward.  ``temperature > 0`` (needs
    ``rng``): speculative sampling (accept a drafted x ~ q with
    probability min(1, p(x)/q(x)), redraw the first rejection from
    norm(max(p − q, 0))), both distributions warped alike first; the
    committed tokens follow the warped target distribution exactly.

    Each round the draft proposes ``draft_len`` tokens one at a time, the
    target scores them all in one forward (L = draft_len + 1), and the
    batch commits its rows' minimum accepted prefix plus one
    bonus/correction token.  Rejected positions keep stale cache entries
    that ``kv_length`` masks until the next round overwrites them.
    ``eos_id``/``pad_id`` as in ``generate``; once every row has finished,
    no more draft or verify forwards run.  ``return_stats=True`` also
    returns ``{"target_calls", "drafted", "accepted"}`` (``target_calls``:
    the verify forwards; the prompt prefill is one more).  Each round
    reads the accepted length back to the host, as the JAX function does.
    """
    _check_supported(model)
    _check_supported(draft_model)
    dev = model.device
    prompt = _tokens(prompt, dev)
    b, p_len = prompt.shape
    if num_steps < 1:
        raise ValueError(f"speculative_generate needs num_steps >= 1, got "
                         f"{num_steps}")
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    _validate_sampling(temperature, rng, top_k, top_p)
    tv, dv = _vocab_size(model), _vocab_size(draft_model)
    _validate_stopping(eos_id, pad_id, tv)
    if tv is not None and dv is not None and tv != dv:
        raise ValueError(f"target and draft vocabularies differ: {tv} vs "
                         f"{dv} — argmax agreement would be meaningless")
    total = p_len + int(num_steps)
    if max_len is None:
        max_len = total
    if max_len < total:
        raise ValueError(f"max_len {max_len} < prompt+steps {total}")
    for name, m in (("target", model), ("draft", draft_model)):
        _check_total(m, p_len, num_steps, f"{name} ")

    # draft_len slots of slack so every round drafts and verifies at one
    # (B, draft_len + 1) shape; slack slots only hold discarded writes.
    # Learned-positional models cap the slack at their trained range
    def alloc_for(m):
        limit = _context_limit(m)
        want = max_len + int(draft_len)
        return want if limit is None else min(want, limit)

    t_caches = init_cache(model, b, alloc_for(model))
    d_caches = init_cache(draft_model, b, alloc_for(draft_model))
    alloc = min(alloc_for(model), alloc_for(draft_model))
    logits, t_caches = _forward(model, t_caches, prompt, 0)
    _, d_caches = _forward(draft_model, d_caches, prompt, 0)

    sampled = temperature > 0.0

    def warp(l):
        # the same warp for target and draft: the rejection rule is exact
        # for whatever pair of distributions it compares
        return _filter_logits(l / temperature, top_k, top_p) if sampled \
            else l

    # the draw rule's counter is a host-side draw count: each random draw
    # takes the next one, and row r draws as row r of the batch
    draws = [0]
    keys = _key_rows(rng, b, dev) if sampled else None
    rows = torch.arange(b, device=dev)

    def key():
        draws[0] += 1
        return torch.full((b,), draws[0], dtype=torch.int64, device=dev)

    def pick(l):
        return (_categorical(keys, key(), rows, warp(l)) if sampled
                else torch.argmax(l, dim=-1)).to(torch.int32)

    cur = pick(logits[:, -1])
    d_step = jit_decode_step(draft_model)
    pad_value = pad_id if pad_id is not None else (eos_id or 0)
    pad_tok = torch.tensor(pad_value, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    out: List[torch.Tensor] = []

    def commit(tok):
        # eos as in generate, per committed token in commit order
        nonlocal done
        if eos_id is not None:
            tok = torch.where(done, pad_tok, tok)
            done = done | (tok == eos_id)
        out.append(tok)

    commit(cur)
    cur = out[-1]
    pos = p_len - 1  # cur continues from here; its cache slot is pos + 1
    stats = {"target_calls": 0, "drafted": 0, "accepted": 0}
    while len(out) < num_steps:
        if eos_id is not None and bool(torch.all(done)):
            # every row finished: fill the remaining slots with pad
            out.extend([torch.full((b,), pad_value, dtype=torch.int32,
                                   device=dev)] * (num_steps - len(out)))
            break
        # k = draft_len whenever the allocation allows (one verify shape);
        # the commit clamp below keeps outputs exact when more is drafted
        # than remains to emit
        k = max(min(int(draft_len), alloc - (pos + 1) - 1), 0)
        d_toks, q_logits = [], []
        tok = cur
        for i in range(k):
            dl, d_caches = d_step(d_caches, tok, pos + 1 + i)
            q_logits.append(warp(dl))
            tok = pick(dl)
            d_toks.append(tok)
        # one target forward over [cur, d_1 .. d_k]: logits[i] scores the
        # token following fed[i], so a fully accepted round still has a
        # bonus logit at index k
        fed = torch.stack([cur] + d_toks, dim=1)              # (B, k + 1)
        logits, t_caches = _forward(model, t_caches, fed, pos + 1)
        stats["target_calls"] += 1
        stats["drafted"] += k
        if k == 0:
            commit(pick(logits[:, 0]))
            cur = out[-1]
            pos += 1
            continue
        drafted = torch.stack(d_toks, dim=1)                  # (B, k)
        if sampled:
            p = torch.softmax(warp(logits[:, :k]), dim=-1)    # (B, k, V)
            q = torch.softmax(torch.stack(q_logits, dim=1), dim=-1)
            at = drafted.long()[..., None]
            px = torch.gather(p, -1, at)[..., 0]              # (B, k)
            qx = torch.gather(q, -1, at)[..., 0]
            u = _uniform(keys, key(), rows, k)
            accept = u * torch.clamp(qx, min=1e-30) < px      # u < p/q
            n_row = torch.cumprod(accept.to(torch.int32), dim=1).sum(1)
            a = min(int(n_row.min()), num_steps - len(out) - 1)
            for i in range(a):
                commit(drafted[:, i])         # accepted by every row
            if a == k:
                # fully accepted: the bonus token straight from warped p
                tok_a = pick(logits[:, k])
            else:
                res = torch.clamp(p[:, a] - q[:, a], min=0.0)
                rsum = res.sum(-1, keepdim=True)
                # res == 0 iff p <= q everywhere, i.e. p == q: fall back
                res = torch.where(rsum > 0.0,
                                  res / torch.clamp(rsum, min=1e-38),
                                  p[:, a])
                rej = _categorical(keys, key(), rows,
                                   torch.log(torch.clamp(res, min=1e-38)))
                # rows that accepted position a keep their drafted token
                tok_a = torch.where(n_row > a, drafted[:, a],
                                    rej.to(torch.int32))
            commit(tok_a)
        else:
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            match = drafted == greedy[:, :k]                  # (B, k)
            # per-row accepted prefix length; commit the batch minimum
            n_row = torch.cumprod(match.to(torch.int32), dim=1).sum(1)
            a = min(int(n_row.min()), num_steps - len(out) - 1)
            for i in range(a):
                commit(greedy[:, i])          # == accepted draft tokens
            commit(greedy[:, a])              # bonus / correction token
        stats["accepted"] += a
        cur = out[-1]
        pos += a + 1
        if a == k and len(out) < num_steps:
            # d_k was committed but never fed to the draft: one catch-up
            # step writes its draft-cache slot (logits discarded)
            _, d_caches = d_step(d_caches, drafted[:, -1], pos)

    result = torch.cat([prompt, torch.stack(out[:num_steps], dim=1)], dim=1)
    return (result, stats) if return_stats else result


def _regather(caches, index: torch.Tensor):
    return [None if c is None else
            {name: t.index_select(0, index) for name, t in c.items()}
            for c in caches]


@torch.no_grad()
def beam_search(model, prompt, num_steps: int, num_beams: int = 4,
                length_penalty: float = 0.0, eos_id: Optional[int] = None,
                pad_id: Optional[int] = None):
    """Deterministic beam decoding: keep the ``num_beams`` highest
    log-probability continuations of each prompt row.

    prompt (B, P) → ``(tokens (B, num_beams, P + num_steps), scores (B,
    num_beams))``, beams best first.  Scores are summed token
    log-probabilities; ``length_penalty`` alpha > 0 divides them by
    ``generated_length ** alpha`` before the final ranking.  ``eos_id``: a
    beam that emits it is finished (its score freezes, its later slots
    are ``pad_id``, default the eos itself) and keeps competing at its
    frozen score.  The caches ride at batch B·num_beams, re-gathered to
    each step's surviving parents.  Ties rank the lower index first, as
    ``jax.lax.top_k`` and the stable ``jnp.argsort`` do.  Beam 0 with
    ``num_beams=1`` is greedy ``generate``; rolling caches are not
    supported here.
    """
    _check_supported(model)
    dev = model.device
    prompt = _tokens(prompt, dev)
    b, p_len = prompt.shape
    k = int(num_beams)
    if k < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if num_steps < 1:
        raise ValueError(f"beam_search needs num_steps >= 1, got "
                         f"{num_steps}")
    if length_penalty < 0:
        raise ValueError(f"length_penalty must be >= 0, got "
                         f"{length_penalty}")
    _check_total(model, p_len, num_steps)
    _validate_stopping(eos_id, pad_id, _vocab_size(model))
    pad = torch.tensor(pad_id if pad_id is not None else (eos_id or 0),
                       dtype=torch.int32, device=dev)

    # prefill once at batch B, then tile every cache to B·k rows laid out
    # row-major (batch, beam): beam j of row i lives at i·k + j
    caches = init_cache(model, b, p_len + int(num_steps))
    logits, caches = _forward(model, caches, prompt, 0)
    logp0 = torch.log_softmax(logits[:, -1], dim=-1)          # (B, V)
    v = logp0.shape[-1]
    scores, first = (t[..., :k] for t in _sort_desc(logp0))   # (B, k)
    first = first.to(torch.int32)
    caches = _regather(caches, torch.arange(b, device=dev)
                       .repeat_interleave(k))
    done = (first == eos_id) if eos_id is not None \
        else torch.zeros((b, k), dtype=torch.bool, device=dev)

    # a finished beam's candidate row: only the pad column, at +0
    frozen = torch.full((v,), float("-inf"), device=dev)
    frozen[pad.long()] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * k
    tok, toks, parents = first, [], []
    for i in range(int(num_steps) - 1):
        logits, caches = decode_step(model, caches, tok.reshape(b * k),
                                     p_len + i)
        logp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
        logp = torch.where(done[..., None], frozen, logp)
        cand = (scores[..., None] + logp).reshape(b, k * v)
        scores, idx = (t[..., :k] for t in _sort_desc(cand))   # (B, k)
        parent = idx // v
        tok = (idx % v).to(torch.int32)
        caches = _regather(caches, (rows + parent).reshape(-1))
        done = torch.gather(done, 1, parent)
        if eos_id is not None:
            tok = torch.where(done, pad, tok)
            done = done | (tok == eos_id)
        toks.append(tok)
        parents.append(parent)

    # each surviving beam's path, walking the parent pointers backward
    # from the final beam order
    steps = int(num_steps)
    tokens = torch.zeros((b, k, steps), dtype=torch.int32, device=dev)
    beam = torch.arange(k, device=dev).expand(b, k)
    for i in range(steps - 1, 0, -1):
        tokens[:, :, i] = torch.gather(toks[i - 1], 1, beam)
        beam = torch.gather(parents[i - 1], 1, beam)
    tokens[:, :, 0] = torch.gather(first, 1, beam)

    if length_penalty > 0:
        if eos_id is not None:
            hit = tokens == eos_id
            first_eos = torch.argmax(hit.to(torch.int32), dim=-1)
            lengths = torch.where(hit.any(dim=-1), first_eos + 1,
                                  torch.full_like(first_eos, steps))
        else:
            lengths = torch.full((b, k), steps, device=dev)
        ranked = scores / lengths.to(torch.float32) ** length_penalty
    else:
        ranked = scores
    order = torch.sort(-ranked, dim=-1, stable=True).indices
    tokens = torch.gather(tokens, 1, order[..., None].expand(b, k, steps))
    ranked = torch.gather(ranked, 1, order)
    out = torch.cat([prompt[:, None].expand(b, k, p_len), tokens], dim=2)
    return out, ranked
