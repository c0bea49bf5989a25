"""Continuous-batching serving engine, port of the core of
``distkeras_tpu/serving.py`` (``ServingEngine`` over its dense slot pool).

The engine composes the decode layer (``core/decode.py``: the per-row
``decode_step``, the batched samplers, eos stopping) into a live
inference server with iteration-level scheduling:

 - **Slot pool** — one batched KV cache (``init_cache(model, num_slots,
   max_len)``, or a ring of each block's window with ``rolling=True``);
   each batch row is a *slot* holding one in-flight request at its own
   position.  The whole pool advances through one per-row ``decode_step``
   (per-slot positions + active mask).
 - **Paged pool** (``paged=True``) — the slot pool becomes a flat arena
   of ``block_size``-token blocks (``init_paged_arena``) addressed
   through per-slot block tables on the device: blocks are allocated per
   request on demand (capacity is tokens in flight, not ``num_slots ×
   max_len``), and, for non-rolling pools, shared across requests
   through a radix prefix trie (a prompt whose leading blocks match a
   cached chain prefills only its suffix; a partially matched boundary
   block is copied on write).  Refcount-0 chains stay cached until LRU
   eviction needs their blocks.
 - **Admission queue with backpressure** — ``submit`` enqueues up to
   ``queue_capacity`` requests; beyond that it blocks (or raises
   :class:`QueueFull` with ``block=False``).
 - **Prefill/decode interleave** — each iteration admits up to
   ``prefills_per_step`` queued requests into free slots, then runs one
   decode step for every running request.
 - **Bucketed prefill** (``prefill_mode="bucketed"``, the default) —
   admitted prompts are right-padded to a power-of-two length bucket and
   prefilled together, one batched forward per bucket width; the
   per-request prefill of the original engine stays, as the reference,
   behind ``prefill_mode="eager"``.
 - **Chunked prefill** — a prompt longer than ``prefill_chunk`` is
   prefilled one chunk per iteration into a private staging cache,
   interleaved with decode steps, and committed to its slot's pool row
   with its last chunk.
 - **Device-resident decode state** — current tokens, positions, the
   active mask, per-slot sampling parameters and keys live in static
   tensors on the model's device and advance inside the decode step.  A
   decode-only iteration uploads nothing and reads back one token row,
   into pinned host memory behind an event that the next iteration waits
   on (one-step lookahead).  On a CUDA card the decode step is one CUDA
   graph, captured once per engine over those static tensors and the pool
   (the counterpart of the JAX package's jitted step with donated
   buffers) and replayed every iteration; on the CPU the same function
   runs uncaptured.  A card whose capture fails raises: there is no
   quiet switch to the uncaptured step.
 - **Speculative decoding** (``spec_draft=``) — every decode iteration
   is one speculative round (:func:`_spec_round`): ``spec_len`` per-row
   draft steps over the draft's own pool (the same slot indices; paged:
   its own arena over the same block ids), one batched verify forward of
   the target over ``[token, d_1 .. d_k]``, a per-row accept and commit
   (greedy rows take the longest drafted prefix matching the target's
   argmax, so their chain is the argmax chain; sampled rows take the
   Leviathan/Chen rule on identically warped distributions), and a draft
   back-fill step.  Rows commit 1 to ``spec_len + 1`` tokens each; the
   round's one output row carries them and their counts, so an iteration
   still reads back one array.  On a CUDA card the round is the captured
   graph.  A rolling target pool keeps ``spec_len`` slack slots in its
   ring, so that the L = ``spec_len + 1`` verify write never overwrites
   the oldest query's window.
 - **Quantization** — ``quantize="int8"`` (weight-only int8,
   ``core.quant.quantize_params``) or ``"bf16"`` (float weights rounded
   to bf16, computed in the model's compute dtype), applied once at
   construction to the target and the draft; ``kv_dtype="int8"`` stores
   the pools as int8 codes plus per-entry scales (about 1.8x the slots at
   the same bytes).  A dense int8 engine prefills in full precision and
   quantizes on commit, a paged one prefills through the int8 arena (its
   prompt attends over dequantized entries, as token-by-token decoding
   does): the two rules differ, as the JAX package's two engines do.
 - **Retirement + slot reuse** — a request leaves its slot the moment it
   emits ``eos_id`` or its ``num_steps``-th token, and the slot is
   reusable by the next queued request mid-run.
 - **Failure semantics** — per-request deadlines, cancellation, graceful
   ``drain``, and a crashed or wedged loop failing every in-flight handle
   with a typed :class:`EngineDead`.

Determinism contract: a lone request through the engine emits the tokens
that ``generate`` emits under the same seed and parameters — greedy and
sampled alike, since both draw through ``core.decode``'s one counter-based
draw rule (row 0 of ``generate``'s batch draws what a lone request
draws).  Greedy speculation emits ``generate``'s tokens too; sampled
speculation commits the warped target distribution exactly, with draws of
its own.

Draws of the speculative round: ``core.decode.random_bits`` under the
request's key, counter (t, p · V + j) for a draw of purpose p at absolute
position t (V the vocabulary, j < V the draw's word).  Purpose 0 is the
plain sampler (the first token after prefill), 1 the draft's proposal of
the token at t, 2 the accept uniform of the token proposed at t (one
word), 3 the residual or bonus draw of the token at t.  So no two purposes
of one request share bits, and a position's draws depend on (key,
position, purpose) alone: a position drafted again after a rejection
reuses bits that decided nothing committed (the JAX round folds its keys
by (position, purpose) for the same reason; its bits are not these).

Multi-tenant QoS (``tenants=``, ``register_tenant``, ``submit(tenant=,
priority=)``): one admission queue per tenant, popped by stride-based
weighted-fair scheduling (interactive-tier tenants strictly first,
``pass += 1 / weight`` a pick, highest ``priority`` first within a
tenant, FIFO among equals; requests naming no tenant pop in plain FIFO
order), token-bucket quotas refused with :class:`QuotaExceeded` before a
request counts as submitted, tier-default deadlines, and preemption of
batch-tier requests on paged engines (``preempt``, or automatically when
the interactive tier is starved of slots or blocks): the request's live
KV blocks and its decode frontier are read to host memory, its slot and
blocks are freed, and it later resumes into a fresh private chain and
any free slot with the same token stream, since every draw depends on
(key, position) alone.  Both swap programs write the static device state
in place, so the decode step's CUDA graph replays over the resumed row
without a new capture.

Left for later slices (each raises ``NotImplementedError`` naming its
ROADMAP item): roles and the wire front-end (queue A item 4) and hot
weight reload from a parameter server (queue A item 6).
"""

from __future__ import annotations

import collections
import copy
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .core import decode as _dec
from .core.decode import (_check_supported, _context_limit, _forward,
                          _to_ring, _validate_rolling, _validate_sampling,
                          _validate_stopping, _vocab_size, init_cache,
                          rng_key, sample_logits)
from .core.model import FittedModel, Sequential
from .core.quant import (QUANT_KEYS, QuantizedTensor, kv_cache_bytes,
                         quantize_kv, quantize_params)
from .resilience import RetryPolicy as _RetryPolicy

logger = logging.getLogger("distkeras_tpu_torch.serving")

#: re-dial budget for hot-reload pulls, as in the JAX package (the pull
#: runs on the decode thread between steps, so the policy's worst case is
#: the longest serving stall a dead parameter server can cause)
DEFAULT_RELOAD_POLICY = _RetryPolicy(attempts=4, backoff=0.02,
                                     max_backoff=0.1, jitter=0.0,
                                     deadline=0.5)

_LATER = "ROADMAP queue A item 4"


class QueueFull(RuntimeError):
    """Admission backpressure: the engine's bounded queue is at capacity
    (``submit(block=False)`` / a blocking submit that timed out)."""


class QuotaExceeded(QueueFull):
    """Admission refused by the submitting tenant's token-bucket quota
    (``TenantPolicy.rate``).  A :class:`QueueFull`, so every shed path
    treats a quota refusal as sheddable.  Raised at once even from a
    blocking ``submit``: waiting out a refill inside the engine would hold
    admission hostage to one tenant's burst."""


class TenantPolicy:
    """One tenant's QoS contract: ``weight`` is its weighted-fair share of
    admissions, ``rate``/``burst`` a token-bucket quota in requests/s
    (``rate=None`` = unlimited), ``tier`` the SLO band (``"interactive"``
    tenants are admitted ahead of ``"batch"`` tenants and may preempt
    them; ``"batch"`` tenants are preemptible), and ``deadline_s`` an
    optional tier-default per-request deadline applied when ``submit``
    passes none (an explicit ``deadline_s`` still wins).  The bucket is
    mutated under the engine's queue lock: one policy object belongs to
    one engine (``clone()`` for a copy with a full bucket)."""

    __slots__ = ("name", "weight", "rate", "burst", "tier", "deadline_s",
                 "_tokens", "_stamp")

    def __init__(self, name: str, weight: float = 1.0,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None, tier: str = "batch",
                 deadline_s: Optional[float] = None):
        if not name:
            raise ValueError("tenant name must be non-empty")
        if not (weight > 0):
            raise ValueError(f"weight must be > 0, got {weight}")
        if rate is not None and not (rate > 0):
            raise ValueError(f"rate must be None or > 0, got {rate}")
        if tier not in ("interactive", "batch"):
            raise ValueError(f"tier must be 'interactive' or 'batch', "
                             f"got {tier!r}")
        if deadline_s is not None and not (deadline_s > 0):
            raise ValueError(f"deadline_s must be None or > 0, "
                             f"got {deadline_s}")
        self.name = str(name)
        self.weight = float(weight)
        self.rate = None if rate is None else float(rate)
        if burst is None:
            burst = None if rate is None else max(1.0, float(rate))
        elif not (burst >= 1.0):
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.burst = None if burst is None else float(burst)
        self.tier = tier
        self.deadline_s = deadline_s
        self._tokens = 0.0 if self.burst is None else self.burst
        self._stamp: Optional[float] = None

    def _take(self, now: float) -> bool:
        """Spend one bucket token (refilling first); False = over quota.
        The caller holds the engine's queue lock."""
        if self.rate is None:
            return True
        if self._stamp is not None:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp)
                               * self.rate)
        self._stamp = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def clone(self) -> "TenantPolicy":
        """A copy with a full bucket of its own (``respawn_clone``: the
        replacement engine does not inherit the dead engine's debt)."""
        return TenantPolicy(self.name, weight=self.weight, rate=self.rate,
                            burst=self.burst, tier=self.tier,
                            deadline_s=self.deadline_s)


class Draining(RuntimeError):
    """Admission refused because the engine is draining (``engine.drain``):
    in-flight requests finish, new ones go elsewhere."""


class EngineDead(RuntimeError):
    """The serving engine's decode loop crashed, wedged, or was torn down
    with work in flight.  Raised from ``RequestHandle.result()`` for every
    request the dead engine was carrying (no silent hangs), and from
    ``submit`` on a dead engine."""


class RequestHandle:
    """One submitted request's lifecycle + streaming surface.

    Produced tokens arrive incrementally (``next_chunk``) as the engine
    emits them; ``result()`` blocks until retirement and returns the full
    ``generate``-shaped row: prompt + emitted tokens, padded with
    ``pad_id`` (default ``eos_id``, else 0) out to ``num_steps``.

    ``finish`` is the retire reason: ``"eos"`` / ``"length"`` / ``"empty"``
    for normal completion, ``"deadline"`` (the partial row is still
    returned, padded), ``"cancel"``, ``"drain"`` (drain timeout) and
    ``"error"`` (the engine died — ``result()`` raises the stored
    :class:`EngineDead`).  ``key`` is the request's two 32-bit key words
    (``core.decode.rng_key``); ``deadline`` an absolute
    ``time.perf_counter()`` instant or None; ``tenant`` and ``priority``
    the QoS fields ``submit`` was given.
    """

    __slots__ = ("id", "prompt", "num_steps", "temperature", "top_k",
                 "top_p", "eos_id", "pad_id", "key", "tokens", "finish",
                 "slot", "submitted_at", "started_at", "first_token_at",
                 "finished_at", "deadline", "error", "cancelled_at",
                 "tenant", "priority", "_cond", "_chunk_read", "_listener")

    def __init__(self, rid: int, prompt: np.ndarray, num_steps: int,
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float], eos_id: Optional[int],
                 pad_id: Optional[int], key,
                 deadline_s: Optional[float] = None,
                 tenant: str = "default", priority: int = 0):
        self.id = rid
        self.prompt = prompt
        self.num_steps = int(num_steps)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.key = key
        self.tokens: List[int] = []     # emitted (pre-padding) tokens
        self.finish: Optional[str] = None   # see class docstring
        self.slot: Optional[int] = None
        self.submitted_at = time.perf_counter()
        self.started_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.deadline = (None if deadline_s is None
                         else self.submitted_at + float(deadline_s))
        self.error: Optional[BaseException] = None
        self.cancelled_at: Optional[float] = None
        self.tenant = str(tenant)
        self.priority = int(priority)
        self._cond = threading.Condition()
        self._chunk_read = 0            # tokens already handed out as chunks
        #: a no-arg callable invoked (outside ``_cond``) whenever tokens
        #: arrive or the handle retires; set via ``set_listener``
        self._listener: Optional[Callable[[], None]] = None

    @property
    def done(self) -> bool:
        return self.finish is not None

    @property
    def pad(self) -> int:
        return int(self.pad_id if self.pad_id is not None
                   else (self.eos_id or 0))

    # -- engine side ---------------------------------------------------------
    def _push(self, token: int) -> None:
        with self._cond:
            if self.finish is not None:  # a wedged loop emitting past its
                return                   # declared death: drop, don't grow
            if self.first_token_at is None:
                self.first_token_at = time.perf_counter()
            self.tokens.append(int(token))
            self._cond.notify_all()
            fire = self._listener
        if fire is not None:  # invoked OUTSIDE _cond: a listener must not
            fire()            # nest locks

    def _finish(self, reason: str) -> bool:
        """Returns whether THIS call made the handle terminal — the engine
        counts a request once, so a completion racing a concurrent failure
        must not increment both counters."""
        with self._cond:
            if self.finish is not None:  # first terminal state wins
                return False
            self.finish = reason
            self.finished_at = time.perf_counter()
            self._cond.notify_all()
            fire = self._listener
        if fire is not None:
            fire()
        return True

    def _fail(self, exc: BaseException, reason: str = "error") -> bool:
        """Terminal failure: ``result()`` raises ``exc`` instead of
        returning a row.  Idempotent like ``_finish``; same return
        contract."""
        with self._cond:
            if self.finish is not None:
                return False
            self.error = exc
            self.finish = reason
            self.finished_at = time.perf_counter()
            self._cond.notify_all()
            fire = self._listener
        if fire is not None:
            fire()
        return True

    def set_listener(self, fn: Optional[Callable[[], None]]) -> None:
        """Install (or clear, with None) the progress listener — fired
        after every token push and on retirement, outside the handle's
        lock."""
        with self._cond:
            self._listener = fn
        if fn is not None and (self.done or len(self.tokens)):
            fn()  # catch up on progress that predates the listener

    def _expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    # -- consumer side -------------------------------------------------------
    def next_chunk(self, timeout: Optional[float] = None
                   ) -> Tuple[np.ndarray, bool]:
        """Block until new tokens exist (or the request finished); return
        ``(new_tokens, done)``.  After ``done`` the chunk may be empty —
        the stream's final frame."""
        with self._cond:
            self._cond.wait_for(
                lambda: self.done or len(self.tokens) > self._chunk_read,
                timeout=timeout)
            chunk = np.asarray(self.tokens[self._chunk_read:], np.int32)
            self._chunk_read = len(self.tokens)
            return chunk, self.done

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self.done, timeout=timeout)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The full ``generate``-shaped row (prompt + tokens, padded to
        ``num_steps``) — blocks until the request retires.  A request the
        engine failed raises its stored :class:`EngineDead`."""
        if not self.wait(timeout):
            raise TimeoutError(f"request {self.id} not done")
        if self.error is not None:
            raise self.error
        gen = list(self.tokens) + [self.pad] * (self.num_steps
                                                - len(self.tokens))
        return np.concatenate([self.prompt, np.asarray(gen, np.int32)])

    @property
    def latency_s(self) -> Optional[float]:
        return (None if self.finished_at is None
                else self.finished_at - self.submitted_at)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token — submit instant → first emitted token
        (queueing and prefill included).  None until the first token."""
        return (None if self.first_token_at is None
                else self.first_token_at - self.submitted_at)


def _quantize_weights(model: Sequential, mode: str) -> Sequential:
    """The engine's one weight-quantization path, applied once at
    construction: ``"int8"`` — ``quantize_params`` weight-only int8 (the
    matmul kernels become :class:`QuantizedTensor` codes + scales that
    dequantize inside the unmodified forward); ``"bf16"`` — every float
    parameter and buffer rounded to bfloat16 (QuantizedTensor and integer
    leaves untouched), so that a float32 compute dtype computes at f32 on
    bf16-rounded weights.  Both copy the model and leave ``model`` as it
    is.  Idempotent: a model already in the mode's form comes back as it
    is, without a second copy."""
    if mode == "int8":
        todo = any(name in QUANT_KEYS and p.ndim >= 2
                   for m in model.modules()
                   for name, p in m._parameters.items() if p is not None)
        return quantize_params(model) if todo else model

    def leaves(m):
        return [t for t in (*m._parameters.values(), *m._buffers.values())
                if t is not None and t.is_floating_point()
                and t.dtype != torch.bfloat16]

    if not any(leaves(m) for m in model.modules()
               if not isinstance(m, QuantizedTensor)):
        return model
    out = copy.deepcopy(model)
    with torch.no_grad():
        for m in out.modules():
            if isinstance(m, QuantizedTensor):
                continue
            for name, p in m._parameters.items():
                if p is not None and p.is_floating_point():
                    m._parameters[name] = nn.Parameter(
                        p.detach().to(torch.bfloat16),
                        requires_grad=p.requires_grad)
            for name, b in m._buffers.items():
                if b is not None and b.is_floating_point():
                    m._buffers[name] = b.to(torch.bfloat16)
    return out


def _kv_entries(big, kv) -> Dict[str, torch.Tensor]:
    """Prefilled full-precision ``{"k", "v"}`` entries as the pool stores
    them: as they are, or quantized on commit for int8 pools (the
    per-entry scales a decode-time write produces)."""
    if "ks" not in big:
        return kv
    kq, ks = quantize_kv(kv["k"])
    vq, vs = quantize_kv(kv["v"])
    return {"k": kq, "v": vq, "ks": ks, "vs": vs}


def _commit_rows(big, row, slots: torch.Tensor, width: int, rolling: bool,
                 p_lens: torch.Tensor) -> None:
    """Write freshly prefilled full-precision cache rows into the slot
    pool, in place: row i of ``row`` into pool row ``slots[i]`` (the first
    ``len(slots)`` rows; the batch's unused rows are never written),
    ring-converted per row for rolling pools, quantized on commit for
    int8 pools."""
    if big is None:
        return
    n = slots.shape[0]
    kv = {name: row[name][:n] for name in ("k", "v")}
    if rolling:
        kv = {name: _dec.ring_from_prefill(t, p_lens, big["k"].shape[1])
              for name, t in kv.items()}
    for name, src in _kv_entries(big, kv).items():
        if rolling:
            big[name][slots] = src
        else:
            big[name][slots, :width] = src


def _commit_full_row(big, row, slot: int, rolling: bool,
                     p_row: torch.Tensor) -> None:
    """The chunked-prefill final commit: one staged full-length row
    replaces pool row ``slot`` in place (ring-collapsed for rolling
    pools, quantized on commit for int8 pools)."""
    if big is None:
        return
    kv = {name: row[name] for name in ("k", "v")}
    if rolling:
        kv = {name: _dec.ring_from_prefill(t, p_row, big["k"].shape[1])
              for name, t in kv.items()}
    for name, src in _kv_entries(big, kv).items():
        big[name][slot] = src[0]


def _commit_ring_blocks(arena, rows, p_lens: torch.Tensor,
                        row_bt: torch.Tensor, page: int, view: int) -> None:
    """The rolling paged commit: each row of a dense prefill cache
    ``rows`` (first ``len(row_bt)`` rows) collapses to a ``view``-slot
    ring (``ring_from_prefill``) written, in place, into the arena slots
    its block-table row names (null rows write the null block)."""
    n = row_bt.shape[0]
    j = torch.arange(view, device=row_bt.device)
    blk = torch.clamp(j // page, max=row_bt.shape[1] - 1)
    phys = row_bt[:, blk] * page + (j % page)[None, :]
    for big, row in zip(arena, rows):
        if big is None:
            continue
        ring = [_dec.ring_from_prefill(row[name][:n], p_lens[:n], view)
                for name in ("k", "v")]
        _dec._paged_write(big, phys, *ring)


def _commit_view_blocks(arena, rows, p_lens: torch.Tensor,
                        row_bt: torch.Tensor, page: int, view: int) -> None:
    """The draft's commit of a rolling paged engine's chunked prefill:
    each staged full-view row of ``rows`` (first ``len(row_bt)`` rows)
    written, in place, into the arena slots its table row names,
    positions at or past the row's prompt length into the null block."""
    n = row_bt.shape[0]
    j = torch.arange(view, device=row_bt.device)
    blk = torch.clamp(j // page, max=row_bt.shape[1] - 1)
    phys = row_bt[:, blk] * page + (j % page)[None, :]
    past = j[None, :] >= p_lens[:n].reshape(-1, 1)
    for big, row in zip(arena, rows):
        if big is None:
            continue
        _dec._paged_write(big, phys.masked_fill(past, big["k"].shape[0] - 1),
                          row["k"][:n, :view], row["v"][:n, :view])


#: the speculative round's draw purposes (module docstring): each takes
#: the counter words [p · V, (p + 1) · V) at a position
_DRAW_DRAFT, _DRAW_ACCEPT, _DRAW_FINAL = 1, 2, 3


def _draw_rows(like: torch.Tensor, purpose: int, words: int,
               vocab: int) -> torch.Tensor:
    """``random_bits``' ``rows`` argument that puts a draw of ``words``
    words (``vocab`` or 1) at the start of ``purpose``'s counter words."""
    return torch.full_like(like, purpose * vocab // words)


@torch.no_grad()
def _spec_round(model, draft, caches, d_caches, tok, pos, act, temp, topk,
                topp, keys, k: int, rolling: bool = False,
                paged: Optional["_dec.PagedView"] = None,
                d_paged: Optional["_dec.PagedView"] = None):
    """One speculative round of every slot, the counterpart of the JAX
    engine's ``_build_spec_fn``: ``k`` per-row draft steps (``draft`` over
    ``d_caches``, never rolling; ``d_paged`` its view of the draft arena),
    one batched verify forward of ``model`` over ``[tok, d_1 .. d_k]`` at
    the rows' positions (``rolling``: a dense ring with ``k`` slack slots;
    ``paged``: the target arena's view), the per-row accept and commit,
    and the draft's back-fill step at ``pos + k``.  The arguments are the
    plain step's device state; the caches are written in place.

    Returns ``(out, new_tok, new_pos)``: ``out`` (B, k + 2) int32 holds
    row r's committed tokens in its first ``n_r`` columns and ``n_r`` (1
    to k + 1 for an active row, 0 for an inactive one) in its last.  Only
    gathers, scatters and ``where`` on static shapes, and no value read
    back to the host: a CUDA graph captures the round.  Positions a row
    wrote past its new frontier (rejected drafts) hold junk that its
    ``kv_length`` masks until the next round overwrites them."""
    b = tok.shape[0]
    sampled = temp > 0.0
    safe_t = torch.where(sampled, temp, torch.ones_like(temp))

    def warp(logits):
        return _dec.filter_logits_batched(logits / safe_t[:, None], topk,
                                          topp)

    # -- draft phase: k per-row single-token steps over the draft's pool
    d_toks, q_logits = [], []
    t = tok
    for i in range(k):
        dl, _ = _dec.decode_step(draft, d_caches, t, pos + i, False, d_paged)
        wl = warp(dl)
        vocab = dl.shape[-1]
        prop = _dec._categorical(keys, pos + (i + 1),
                                 _draw_rows(pos, _DRAW_DRAFT, vocab, vocab),
                                 wl)
        t = torch.where(sampled, prop,
                        torch.argmax(dl, dim=-1)).to(torch.int32)
        d_toks.append(t)
        q_logits.append(wl)
    drafted = torch.stack(d_toks, dim=1)                         # (B, k)

    # -- verify: one forward over [tok, d_1 .. d_k]; logits[:, i] scores
    #    the token after fed position i, so a fully accepted row still has
    #    its bonus distribution at index k
    fed = torch.cat([tok[:, None], drafted], dim=1)
    logits, _ = _dec._forward(model, caches, fed, pos,
                              rolling and paged is None, paged)
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)       # (B, k + 1)

    # -- greedy accept: the longest drafted prefix matching the argmax
    a_g = torch.cumprod((drafted == greedy[:, :k]).to(torch.int32),
                        dim=1).sum(1)

    # -- sampled accept: x ~ q accepted with probability min(1, p/q); the
    #    first rejection redraws from norm(max(p - q, 0)), a full accept
    #    draws the bonus from the warped p
    rep_k = topk[:, None].expand(b, k).reshape(-1)
    rep_p = topp[:, None].expand(b, k).reshape(-1)
    pk = _dec.filter_logits_batched(
        (logits[:, :k] / safe_t[:, None, None]).reshape(b * k, vocab),
        rep_k, rep_p).reshape(b, k, vocab)
    p_probs = torch.softmax(pk, dim=-1)
    q_probs = torch.softmax(torch.stack(q_logits, dim=1), dim=-1)
    at = drafted.long()[..., None]
    px = torch.gather(p_probs, -1, at)[..., 0]
    qx = torch.gather(q_probs, -1, at)[..., 0]
    steps = torch.arange(1, k + 1, device=pos.device)
    u = _dec._uniform(keys[:, None].expand(b, k, 2).reshape(b * k, 2),
                      (pos[:, None] + steps[None, :]).reshape(-1),
                      _draw_rows(pos.new_empty(b * k), _DRAW_ACCEPT, 1,
                                 vocab), 1).reshape(b, k)
    accept = u * torch.clamp(qx, min=1e-30) < px
    a_s = torch.cumprod(accept.to(torch.int32), dim=1).sum(1)
    ai = a_s.clamp(0, k - 1)[:, None, None].expand(b, 1, vocab)
    p_a = torch.gather(p_probs, 1, ai)[:, 0]
    q_a = torch.gather(q_probs, 1, ai)[:, 0]
    res = torch.clamp(p_a - q_a, min=0.0)
    rsum = res.sum(-1, keepdim=True)
    # res == 0 iff p <= q everywhere, i.e. p == q: fall back to p
    res = torch.where(rsum > 0.0, res / torch.clamp(rsum, min=1e-38), p_a)
    bonus = torch.softmax(warp(logits[:, k]), dim=-1)
    dist = torch.where((a_s == k)[:, None], bonus, res)
    corr = _dec._categorical(keys, pos + a_s + 1,
                             _draw_rows(pos, _DRAW_FINAL, vocab, vocab),
                             torch.log(torch.clamp(dist, min=1e-38)))
    committed_s = torch.cat([drafted, torch.zeros_like(drafted[:, :1])],
                            dim=1).scatter(1, a_s[:, None],
                                           corr.to(torch.int32)[:, None])

    # -- per-row commit and the state advance
    a = torch.where(sampled, a_s, a_g)
    committed = torch.where(sampled[:, None], committed_s, greedy)
    n = torch.where(act, a + 1, torch.zeros_like(a))
    last = torch.gather(committed, 1, a[:, None])[:, 0]
    new_tok = torch.where(act, last, tok)
    new_pos = torch.where(act, pos + n, pos)

    # -- back-fill: d_k at pos + k, the full-accept rows' cache hole (the
    #    committed bonus's predecessor, never fed to the draft); for every
    #    other row pos + k lies at or past its new frontier, junk masked
    #    until overwritten
    _dec.decode_step(draft, d_caches, d_toks[-1], pos + k, False, d_paged)
    out = torch.cat([committed, n[:, None].to(torch.int32)], dim=1)
    return out, new_tok, new_pos


def _pow2_buckets(cap: int) -> List[int]:
    """The prefill length-bucket ladder: powers of two from 8 up, capped
    (and terminated) at ``cap`` — a small set of prefill widths."""
    cap = int(cap)
    out: List[int] = []
    n = 8
    while n < cap:
        out.append(n)
        n *= 2
    out.append(cap)
    return out


class _PrefillJob:
    """Scheduler-side state of one chunked prefill in flight: the slot is
    claimed (``engine._handles``) but not yet decoding; ``written`` prompt
    tokens are staged so far.  ``staging`` is a full-length one-row cache
    the chunks accumulate into — private to the job, so the decode
    batch's junk writes into free pool rows cannot race it — which the
    final chunk commits to the slot's pool row at once.  Speculative
    engines stage the draft's chunks alike (``d_staging``, ``dbt``)."""

    __slots__ = ("handle", "staging", "written", "bt", "d_staging", "dbt")

    def __init__(self, handle: RequestHandle, staging=None, bt=None,
                 d_staging=None, dbt=None):
        self.handle = handle
        self.staging = staging
        self.written = 0
        #: paged engines: the job's (1, T) device block-table row
        self.bt = bt
        self.d_staging = d_staging
        #: paged speculative engines: the draft's (1, T_d) table row
        self.dbt = dbt


class _SuspendedReq:
    """One preempted request swapped out to host memory: its live KV rows
    (``layers``: per TransformerBlock a dict of host tensors of
    ``n_blocks`` × ``block_size`` rows, the ``gather_blocks`` layout, or
    None) and its decode frontier read from the device (``pos`` entries
    written, ``tok`` the current unwritten token).  The handle stays
    live with the tokens it has emitted; it holds no slot and no arena
    block."""

    __slots__ = ("handle", "layers", "n_blocks", "pos", "tok",
                 "suspended_at")

    def __init__(self, handle: RequestHandle, layers, n_blocks: int,
                 pos: int, tok: int):
        self.handle = handle
        self.layers = layers
        self.n_blocks = int(n_blocks)
        self.pos = int(pos)
        self.tok = int(tok)
        self.suspended_at = time.perf_counter()


# ---------------------------------------------------------------------------
# paged KV pool: host-side block allocator + radix prefix index
# ---------------------------------------------------------------------------

class _RadixNode:
    """One full block of prompt tokens in the prefix trie: ``key`` is its
    ``block_size``-token chunk (the edge label from ``parent``), ``block``
    the physical arena block holding those tokens' K/V (all layers).
    ``ref`` counts live requests sharing the block; at ref 0 the node
    stays cached (its K/V stay valid in the arena) until the allocator
    evicts it: LRU over ``last_used``, leaves first, so a chain is
    reclaimed suffix-inward.  ``epoch`` stamps the scheduler pass that
    inserted it: a node is matchable only from later passes, so that a
    matcher in the same pass never reads blocks whose prefill program has
    not been dispatched yet."""

    __slots__ = ("parent", "key", "block", "ref", "last_used", "children",
                 "epoch")

    def __init__(self, parent, key: Tuple[int, ...], block: int,
                 epoch: int = -1):
        self.parent = parent
        self.key = key
        self.block = block
        self.ref = 0
        self.last_used = 0
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.epoch = epoch


class _BlockPlan:
    """One admitted request's blocks: ``blocks`` the full logical chain
    (matched + fresh, in logical-block order), ``nodes`` the trie nodes
    it holds a reference on, ``private`` the block ids it owns outright
    (the copy-on-write copy, the partial prompt boundary, the decode
    region), ``matched`` the prefix tokens served from the trie, and
    ``cow`` the ``(src, dst)`` blocks of the copy-on-write boundary copy
    (or None)."""

    __slots__ = ("nodes", "private", "blocks", "matched", "cow")

    def __init__(self, nodes, private, blocks, matched, cow):
        self.nodes = nodes
        self.private = private
        self.blocks = blocks
        self.matched = matched
        self.cow = cow


class _PagedKVPool:
    """Host-side allocator and radix prefix index over a flat block arena
    (``core.decode.init_paged_arena``), used from the scheduler thread
    only.

    Allocation is block-granular and on demand: a request takes
    ``ceil((p_len + num_steps) / block_size)`` blocks instead of a
    ``max_len`` row, so capacity is bounded by tokens in flight rather
    than ``num_slots × max_len``.  With ``share=True`` (non-rolling pools)
    admissions first walk the trie: full blocks whose token chunk matches
    the prompt are shared (refcounted, never written again: every
    sharer's write floor lies above them), a partially matched boundary
    block is copied (copy-on-write: the admission owns the copy and goes
    on writing into it), and only the unmatched suffix is prefilled.
    Matching is capped at ``p_len - 1``, so at least one prompt token is
    prefilled: the logits that sample the first token must be computed.
    Retirement drops refs; refcount-0 chains stay cached until LRU
    eviction (leaves first) reclaims their blocks for new admissions.
    The counters go straight into the engine's ``stats`` dict."""

    def __init__(self, num_blocks: int, block_size: int, share: bool,
                 stats: Dict[str, Any]):
        self.num_blocks = int(num_blocks)
        self.bs = int(block_size)
        self.share = bool(share)
        self.stats = stats
        self.free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.root = _RadixNode(None, (), -1)
        self.private_out = 0
        self._clock = 0
        self.epoch = 0
        #: running count of ``cached_blocks()``, so that the load snapshot
        #: reads an int instead of walking the trie
        self.trie_nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def next_epoch(self) -> None:
        """One scheduler pass is one epoch: nodes inserted in this pass
        are not matchable until the next."""
        self.epoch += 1

    def _nodes(self) -> List[_RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def cached_blocks(self) -> int:
        """Trie-held blocks (shared and refcount-0 cached)."""
        return len(self._nodes())

    def in_use(self) -> int:
        """Blocks held by live requests: private ones plus trie nodes with
        a non-zero refcount.  0 when the engine is idle: every retirement
        path must restore it."""
        return self.private_out + sum(1 for n in self._nodes() if n.ref > 0)

    def check_conservation(self) -> bool:
        """free + cached + private == num_blocks, always."""
        return (len(self.free) + self.cached_blocks() + self.private_out
                == self.num_blocks)

    def _match(self, toks: List[int], cap: int):
        """Walk the trie: full-block matches (the chain), then the best
        partial child match at the divergence point (the copy-on-write
        boundary).  ``cap`` bounds the matchable tokens; nodes inserted in
        this epoch are invisible."""
        nodes: List[_RadixNode] = []
        parent = self.root
        d = 0
        while d + self.bs <= cap:
            child = parent.children.get(tuple(toks[d:d + self.bs]))
            if child is None or child.epoch >= self.epoch:
                break
            nodes.append(child)
            parent = child
            d += self.bs
        pnode, plen = None, 0
        lim = min(cap - d, self.bs)
        if lim > 0:
            for key, child in parent.children.items():
                if child.epoch >= self.epoch:
                    continue
                j = 0
                while j < lim and key[j] == toks[d + j]:
                    j += 1
                if j > plen:
                    pnode, plen = child, j
        return nodes, pnode, plen

    def _evictable(self, pinned) -> List[_RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.ref == 0 and n not in pinned:
                out.append(n)
        return out

    def _reserve(self, need: int, pinned=()) -> bool:
        """Make ``need`` blocks free, evicting LRU refcount-0 leaves
        (suffix-inward); False when live requests hold too much (the
        admission stays queued until retirements free blocks)."""
        pinned = set(pinned)
        while len(self.free) < need:
            cands = self._evictable(pinned)
            if not cands:
                return False
            victim = min(cands, key=lambda n: n.last_used)
            del victim.parent.children[victim.key]
            self.free.append(victim.block)
            self.trie_nodes -= 1
            self.stats["blocks_evicted"] += 1
        return True

    def admit(self, tokens, n_blocks: int) -> Optional[_BlockPlan]:
        """Reserve a request's block chain.  ``tokens`` (the prompt) is
        None for share-off (rolling) pools: a plain allocation.  The
        request's own full prompt blocks enter the trie later, in
        :meth:`publish`.  Returns None when blocks are unavailable (the
        admission backs off)."""
        if not self.share or tokens is None:
            if not self._reserve(n_blocks):
                return None
            fresh = [self.free.pop() for _ in range(n_blocks)]
            self.stats["blocks_allocated"] += n_blocks
            self.private_out += n_blocks
            return _BlockPlan([], fresh, list(fresh), 0, None)
        toks = [int(t) for t in tokens]
        cap = len(toks) - 1
        nodes, pnode, plen = self._match(toks, cap)
        matched = len(nodes) * self.bs + plen
        need = n_blocks - len(nodes)
        pinned = list(nodes) + ([pnode] if pnode is not None else [])
        if not self._reserve(need, pinned):
            return None
        fresh = [self.free.pop() for _ in range(need)]
        self.stats["blocks_allocated"] += need
        self.private_out += need
        chain = [n.block for n in nodes] + fresh
        now = self._tick()
        for n in nodes:
            n.ref += 1
            n.last_used = now
        self.stats["blocks_reused"] += len(nodes)
        if matched:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += matched
        cow = None
        if pnode is not None:
            cow = (pnode.block, chain[len(nodes)])
            pnode.last_used = now
            self.stats["cow_copies"] += 1
        return _BlockPlan(list(nodes), fresh, chain, matched, cow)

    def publish(self, plan: _BlockPlan, tokens) -> None:
        """Insert the request's own full prompt blocks into the trie (ref
        1, held until release) so that later admissions can share them.
        Called once the program writing their contents is dispatched: at
        once for bucket prefills, at the final chunk for chunked ones.
        Stops at the first key collision: the existing nodes stay, and
        this plan's duplicates stay private."""
        if not self.share or tokens is None:
            return
        toks = [int(t) for t in tokens]
        parent = plan.nodes[-1] if plan.nodes else self.root
        now = self._tick()
        i = len(plan.nodes)
        while (i + 1) * self.bs <= len(toks) and i < len(plan.blocks):
            key = tuple(toks[i * self.bs:(i + 1) * self.bs])
            if key in parent.children:
                break
            node = _RadixNode(parent, key, plan.blocks[i], self.epoch)
            node.ref = 1
            node.last_used = now
            parent.children[key] = node
            plan.nodes.append(node)
            plan.private.remove(plan.blocks[i])
            self.private_out -= 1
            self.trie_nodes += 1
            parent = node
            i += 1

    def release(self, plan: _BlockPlan) -> None:
        """Retirement: drop the plan's refs (refcount-0 chains stay cached
        for later prefix hits) and free its private blocks."""
        now = self._tick()
        for n in plan.nodes:
            n.ref -= 1
            n.last_used = now
        self.free.extend(plan.private)
        self.private_out -= len(plan.private)
        plan.nodes, plan.private = [], []


def _module_of(model) -> Sequential:
    """The ``Sequential`` behind an engine's model argument: a
    ``FittedModel``, a ``Sequential``, or a tuple whose first item is one
    (the JAX engine's ``(model, params)`` form)."""
    if isinstance(model, FittedModel):
        return model.model
    if isinstance(model, tuple):
        return _module_of(model[0])
    return model


def _uses_graph(device: torch.device) -> bool:
    """Whether the decode step on ``device`` is a CUDA graph: on a CUDA
    card always, elsewhere never."""
    return device.type == "cuda"


def _capture_graph(step: Callable[[], None], device: torch.device):
    """Capture ``step`` (no arguments, static tensors only) as a CUDA
    graph on ``device``; returns the graph, whose ``replay()`` runs it.
    One warm-up run on the capture's side stream comes first, as PyTorch
    asks (it initialises the library handles the capture must not
    create)."""
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        step()
    return graph


class ServingEngine:
    """Iteration-level continuous-batching engine over a slot-pooled KV
    cache.

    ``model``: a ``FittedModel`` (or ``Sequential``) of the decode-supported
    family (``transformer_lm``); the engine runs on the model's device.
    ``num_slots`` is the decode batch — the number of simultaneously
    running requests; ``max_len`` bounds prompt+continuation per request
    (defaults to the model's positional range).  ``rolling=True``
    (sliding-window models only) makes each slot an O(W) ring instead of
    ``max_len`` slots.

    ``paged=True`` (bucketed mode only) stores the pool as a flat arena
    of ``kv_blocks`` blocks of ``block_size`` tokens (default: the dense
    pool's capacity, ``num_slots`` × the blocks of one ``max_len`` row, or
    of one window ring for rolling pools) with a radix prefix trie over
    full prompt blocks (non-rolling pools).

    ``prefill_mode``: ``"bucketed"`` (default) runs the fast path —
    batched bucket prefill, chunked long-prompt prefill, device-resident
    decode state with one-step lookahead, and on a CUDA card the decode
    step as a CUDA graph; ``"eager"`` is the per-request engine, kept as
    the reference and never captured.  ``prefill_chunk`` bounds how many
    prompt tokens one iteration may prefill for a single request
    (bucketed mode).

    ``spec_draft`` (a ``FittedModel`` or ``Sequential`` of the target's
    vocabulary, on its device; bucketed mode only) makes every decode
    iteration a speculative round of ``spec_len`` draft tokens.
    ``quantize`` (None, ``"int8"``, ``"bf16"``) quantizes the target's
    and the draft's weights once, into copies; ``kv_dtype="int8"``
    (bucketed mode only) stores both pools as int8 codes plus per-entry
    scales.

    ``tenants`` (a list of :class:`TenantPolicy`; more with
    ``register_tenant``) turns on weighted-fair admission across tenants,
    quotas and tier deadlines; paged non-rolling engines without a draft
    also preempt batch-tier requests (``preempt``, and automatically when
    an interactive request starves).  ``role`` takes its default
    ``"unified"`` only: the prefill and decode roles of disaggregated
    serving raise ``NotImplementedError``.

    Threading: ``submit`` is thread-safe (any number of producers); the
    scheduler itself — ``step`` / ``run_until_idle`` / the ``start``
    background thread — must be driven from one thread at a time.
    """

    def __init__(self, model: Union[FittedModel, Sequential],
                 num_slots: int = 4, max_len: Optional[int] = None,
                 queue_capacity: int = 64, prefills_per_step: int = 1,
                 rolling: bool = False,
                 default_deadline_s: Optional[float] = None,
                 prefill_mode: str = "bucketed", prefill_chunk: int = 128,
                 spec_draft=None, spec_len: int = 4,
                 quantize: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 paged: bool = False, block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 role: str = "unified", tenants=None):
        if role != "unified":
            raise NotImplementedError(
                f"ServingEngine(role={role!r}): the roles of the JAX "
                f"engine are not ported yet ({_LATER})")
        if prefill_mode == "eager" and (spec_draft is not None
                                        or kv_dtype is not None or paged):
            raise ValueError(
                "spec_draft / kv_dtype / paged are fast-path features "
                "(prefill_mode='bucketed'); the eager engine stays the "
                "unmodified bit-exactness reference")
        if quantize not in (None, "int8", "bf16"):
            raise ValueError(f"quantize must be None, 'int8' or 'bf16', "
                             f"got {quantize!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got "
                             f"{kv_dtype!r}")
        if int(spec_len) < 1:
            raise ValueError(f"spec_len must be >= 1, got {spec_len}")
        self.spec_len = int(spec_len)
        self.quantize = quantize
        self.kv_dtype = kv_dtype
        target = _module_of(model)
        _check_supported(target)
        if rolling:
            _validate_rolling(target)
        draft = None if spec_draft is None else _module_of(spec_draft)
        if draft is not None:
            _check_supported(draft)
            tv, dv = _vocab_size(target), _vocab_size(draft)
            if tv is not None and dv is not None and tv != dv:
                raise ValueError(
                    f"target and draft vocabularies differ: {tv} vs {dv} — "
                    f"draft proposals would be meaningless")
            if draft.device != target.device:
                raise ValueError(f"the draft lies on {draft.device}, the "
                                 f"target on {target.device}")
        # quantize ONCE at construction, into copies (the caller's models
        # stay as they are); a self-draft shares the target's copy
        self.model = target
        if quantize is not None:
            self.model = _quantize_weights(target, quantize)
            if draft is not None:
                draft = (self.model if draft is target
                         else _quantize_weights(draft, quantize))
        self._draft_model: Optional[Sequential] = draft
        self.device = self.model.device
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        limit = _context_limit(self.model)
        if max_len is None:
            if limit is None:
                raise ValueError("max_len is required for models without a "
                                 "positional-embedding range")
            max_len = limit
        if limit is not None and max_len > limit:
            raise ValueError(f"max_len {max_len} exceeds the model's "
                             f"positional-embedding range {limit}")
        self.max_len = int(max_len)
        self.rolling = bool(rolling)
        self.queue_capacity = int(queue_capacity)
        self.prefills_per_step = max(int(prefills_per_step), 1)
        if prefill_mode not in ("bucketed", "eager"):
            raise ValueError(f"prefill_mode must be 'bucketed' or 'eager', "
                             f"got {prefill_mode!r}")
        self.prefill_mode = prefill_mode
        if int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.prefill_chunk = int(prefill_chunk)
        if default_deadline_s is not None and default_deadline_s <= 0:
            raise ValueError(f"default_deadline_s must be > 0, got "
                             f"{default_deadline_s}")
        self.default_deadline_s = default_deadline_s
        self._vocab = _vocab_size(self.model)

        # -- slot pool: ONE batched cache, one host-side row of state per
        #    slot (the scheduler's bookkeeping view).  Paged: a flat arena
        #    of block_size-token blocks plus the host allocator and prefix
        #    trie; the default kv_blocks holds the dense pool's capacity
        #    exactly, so paged=True alone changes layout, not limits.  A
        #    rolling pool under speculation keeps spec_len slack slots in
        #    its ring (the L = spec_len + 1 verify write must not overwrite
        #    the oldest query's window).  The draft gets its own pool over
        #    the same slot indices (paged: its own arena over the same
        #    block ids), full length and never rolling
        ring_slack = self.spec_len if (rolling and draft is not None) else 0
        self.paged = bool(paged)
        if int(block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self._pool: Optional[_PagedKVPool] = None
        self._plans: Dict[int, _BlockPlan] = {}
        self.d_caches = None
        if self.paged:
            bs = self.block_size
            if self.rolling:
                windows = {layer._mha().attention_window
                           for layer in self.model.layers
                           if hasattr(layer, "_mha")}
                if len(windows) != 1:
                    raise ValueError(
                        "paged rolling pools need one uniform "
                        "attention_window across every TransformerBlock "
                        "(the block table is per request, shared by all "
                        f"layers); got windows {sorted(windows)}")
                self._t_view = min(windows.pop() + ring_slack, self.max_len)
            else:
                self._t_view = self.max_len
            self._blocks_per_slot = -(-self._t_view // bs)
            if draft is not None:
                # the draft pages max_len positions over the same chain
                self._blocks_per_slot = max(self._blocks_per_slot,
                                            -(-self.max_len // bs))
            if kv_blocks is None:
                kv_blocks = self.num_slots * self._blocks_per_slot
            self.kv_blocks = int(kv_blocks)
            if self.kv_blocks < self._blocks_per_slot:
                raise ValueError(
                    f"kv_blocks {self.kv_blocks} cannot hold even one "
                    f"max-length request ({self._blocks_per_slot} blocks "
                    f"of {bs} tokens)")
            self.caches = _dec.init_paged_arena(self.model, self.kv_blocks,
                                                bs, kv_dtype=kv_dtype)
            if draft is not None:
                self.d_caches = _dec.init_paged_arena(
                    draft, self.kv_blocks, bs, kv_dtype=kv_dtype)
        else:
            self.kv_blocks = None
            self.caches = init_cache(self.model, self.num_slots,
                                     self.max_len, rolling=self.rolling,
                                     kv_dtype=kv_dtype, ring_slack=ring_slack)
            if draft is not None:
                self.d_caches = init_cache(draft, self.num_slots,
                                           self.max_len, kv_dtype=kv_dtype)
        self._handles: List[Optional[RequestHandle]] = [None] * self.num_slots
        self._free: List[int] = list(range(self.num_slots - 1, -1, -1))
        self._positions = np.zeros((self.num_slots,), np.int64)
        self._cur_tok = np.zeros((self.num_slots,), np.int32)
        self._active = np.zeros((self.num_slots,), bool)
        self._temp = np.zeros((self.num_slots,), np.float32)
        self._topk = np.zeros((self.num_slots,), np.int64)    # 0 = off
        self._topp = np.zeros((self.num_slots,), np.float32)  # 0 = off
        self._keys = np.zeros((self.num_slots, 2), np.int64)

        # -- admission queues (the ONLY cross-thread state besides
        #    handles): one FIFO list per tenant, popped by stride-based
        #    weighted-fair scheduling, interactive-tier tenants first.  A
        #    request naming no tenant lands in the "default" queue, and one
        #    tenant's requests of one priority pop FIFO.  _qdepth is the global
        #    depth (the backpressure bound is engine-wide); _q_int counts
        #    queued interactive-tier requests (the preemption signal)
        self._queues: Dict[str, List[RequestHandle]] = {}
        self._qdepth = 0
        self._q_int = 0
        self._wf_pass: Dict[str, float] = {}
        self._tenants: Dict[str, TenantPolicy] = {}
        for pol in (tenants or []):
            if not isinstance(pol, TenantPolicy):
                raise ValueError(f"tenants must be TenantPolicy instances, "
                                 f"got {type(pol).__name__}")
            self._tenants[pol.name] = pol
        self._qlock = threading.Lock()
        self._not_full = threading.Condition(self._qlock)
        self._have_work = threading.Condition(self._qlock)
        self._next_id = 0

        # -- preemption: suspended requests hold no slot and no block, only
        #    a host copy of their live KV rows and frontier (scheduler
        #    thread, read under _qlock by _declare_dead); _preempt_ids
        #    carries preempt() marks to the scheduler; _int_blocked is set
        #    when an interactive admission found no blocks, so that the
        #    starvation pass fires on pool pressure as well as on slots
        self._suspended: Dict[int, _SuspendedReq] = collections.OrderedDict()
        self._preempt_ids: set = set()
        self._int_blocked = False
        self._can_preempt = (self.paged and not self.rolling
                             and draft is None
                             and self.prefill_mode == "bucketed")

        # -- the fast path: prefill widths, the lookahead pipeline, and the
        #    device-resident decode state (static tensors: the CUDA graph
        #    reads and writes these very storages on every replay)
        self._chunk_width = min(self.prefill_chunk, self.max_len)
        self._buckets = _pow2_buckets(self._chunk_width)
        self._pending: "collections.deque" = collections.deque()
        self._prefilling: Dict[int, _PrefillJob] = {}
        self._lookahead = 1 if self.prefill_mode == "bucketed" else 0
        self._graph = None
        self._graphed = (self.prefill_mode == "bucketed"
                         and _uses_graph(self.device))
        self._dev_dbt: Optional[torch.Tensor] = None
        if self.prefill_mode == "bucketed":
            def zeros(*shape, dtype=torch.float32):
                return torch.zeros(shape, dtype=dtype, device=self.device)
            b = self.num_slots
            self._dev_tok = zeros(b, dtype=torch.int32)
            self._dev_pos = zeros(b, dtype=torch.int64)
            self._dev_act = zeros(b, dtype=torch.bool)
            self._dev_temp = zeros(b)
            self._dev_topk = zeros(b, dtype=torch.int64)
            self._dev_topp = zeros(b)
            self._dev_keys = zeros(b, 2, dtype=torch.int64)
            if draft is not None:
                # the speculative round's output row: committed tokens and
                # their count per slot, the one array a round reads back
                self._dev_spec = zeros(b, self.spec_len + 2,
                                       dtype=torch.int32)
            if self.paged:
                # the device block tables: one row per slot, null-filled
                # (null = kv_blocks, the arena's junk block), the last
                # column always null; the prefill programs install a
                # slot's row and retirement re-nulls it, in place.  The
                # draft's table rows name the same blocks over max_len
                self._t_tbl = -(-self._t_view // self.block_size) + 1
                self._dev_bt = torch.full((b, self._t_tbl), self.kv_blocks,
                                          dtype=torch.int64,
                                          device=self.device)
                if draft is not None:
                    self._d_tbl = -(-self.max_len // self.block_size) + 1
                    self._dev_dbt = torch.full(
                        (b, self._d_tbl), self.kv_blocks,
                        dtype=torch.int64, device=self.device)

        # -- scheduler thread + stats + failure state
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        self._dead: Optional[BaseException] = None  # the EngineDead cause
        #: decode-loop heartbeat (monotonic): stamped once per scheduler
        #: iteration, idle iterations included
        self.last_beat = time.monotonic()
        self.stats: Dict[str, Any] = {
            "requests_submitted": 0, "requests_completed": 0,
            "requests_rejected": 0, "tokens_generated": 0,
            "prefills": 0, "decode_steps": 0, "active_slot_steps": 0,
            "queue_peak": 0, "slot_requests": [0] * self.num_slots,
            # failure semantics: retirements by reason, handles failed with
            # EngineDead, one reclaim sample per mid-run cancel/deadline
            "requests_cancelled": 0, "requests_expired": 0,
            "requests_failed": 0, "slot_reclaim_ms": [],
            # the fast path: chunk and batch prefills, prompt tokens, and
            # the decode loop's transfer discipline (a decode-only
            # iteration uploads nothing and reads back one token row)
            "prefill_chunks": 0, "prefill_batches": 0,
            "prefill_batched_requests": 0, "prefill_batch_size_mean": None,
            "prefill_tokens": 0,
            "h2d_transfers": 0, "d2h_transfers": 0,
            # speculation, in speculative_generate's vocabulary: draft
            # proposals, accepted prefix tokens, the batched verify
            # forwards (target_calls mirrors verify_calls); all 0 without
            # a draft
            "drafted": 0, "accepted": 0,
            "verify_calls": 0, "target_calls": 0,
            # the paged pool: fresh block allocations, trie-shared blocks,
            # admissions (and their tokens) served from the prefix trie,
            # boundary copy-on-writes, LRU reclaims of cached chains (all
            # 0 on dense engines); kv_pool_bytes is the target pool's
            # device bytes (the arena with its null block when paged;
            # codes + scales for int8 pools)
            "blocks_allocated": 0, "blocks_reused": 0, "blocks_evicted": 0,
            "prefix_hits": 0, "prefix_hit_tokens": 0, "cow_copies": 0,
            "kv_pool_bytes": kv_cache_bytes(self.caches),
            # the decode step's CUDA graph: captures (one per engine on a
            # card, none elsewhere) and replays (one per decode step)
            "graph_captures": 0, "graph_replays": 0,
            # multi-tenant QoS: swap-outs and resumes, the blocks and bytes
            # of their KV payloads (their reads and uploads also land in
            # d2h/h2d_transfers), one ms sample per swap-out and resume,
            # quota refusals (not requests_rejected), and per tenant its
            # submitted/completed/shed/quota_refused/preemptions/resumes
            "preemptions": 0, "resumes": 0,
            "kv_blocks_swapped_out": 0, "kv_block_bytes_swapped_out": 0,
            "kv_blocks_resumed": 0, "kv_block_bytes_resumed": 0,
            "preempt_swap_ms": [], "preempt_resume_ms": [],
            "quota_refused": 0, "tenants": {},
        }
        if self.paged:
            self._pool = _PagedKVPool(self.kv_blocks, self.block_size,
                                      share=not self.rolling,
                                      stats=self.stats)

        # -- lock-free load snapshot (the routing surface), republished by
        #    reference from submit/step/drain/death, outside _qlock
        self._load_snapshot: Dict[str, Any] = {
            "queue_depth": 0, "slots_free": self.num_slots,
            "slots_total": self.num_slots, "active": 0, "trie_blocks": 0,
            "queue_capacity": self.queue_capacity, "max_len": self.max_len,
            "draining": False, "dead": False, "prefix_hit_tokens": 0,
            "prefill_tokens": 0,
            "tokens_generated": 0, "requests_completed": 0,
            "requests_failed": 0, "queued_interactive": 0,
        }

    # ------------------------------------------------------------- the step
    def _step(self, tok, pos, act, temp, topk, topp, keys):
        """One decode step of every slot: the per-row ``decode_step``
        (cache writes in place, into the pool), the batched sampler, and
        the active mask (free slots keep their token; their rows compute
        a junk forward into their own pool rows, which the next prefill
        fully overwrites; paged: into the null block, their table rows
        being null).  Paged engines read the static device block tables
        ``_dev_bt``."""
        paged = None
        if self.paged:
            paged = _dec.PagedView(self._dev_bt, self.block_size,
                                   self._t_view, ring=self.rolling)
        logits, _ = _dec.decode_step(self.model, self.caches, tok, pos,
                                     self.rolling, paged)
        nxt = _dec.sample_logits_batched(logits, pos, temp, keys, topk,
                                         topp)
        return torch.where(act, nxt, tok)

    def _device_step(self) -> None:
        """The bucketed decode step over the static device state: tokens
        and positions advance in place, so the CUDA graph of this function
        has no inputs or outputs of its own."""
        out = self._step(self._dev_tok, self._dev_pos, self._dev_act,
                         self._dev_temp, self._dev_topk, self._dev_topp,
                         self._dev_keys)
        self._dev_pos.copy_(torch.where(self._dev_act, self._dev_pos + 1,
                                        self._dev_pos))
        self._dev_tok.copy_(out)

    def _device_round(self) -> None:
        """The speculative engines' decode iteration: one
        :func:`_spec_round` over the static device state, both pools and
        (paged) both device block tables; the committed tokens land in
        ``_dev_spec``, tokens and positions advance in place, so the CUDA
        graph of this function has no inputs or outputs of its own."""
        paged = d_paged = None
        if self.paged:
            paged = _dec.PagedView(self._dev_bt, self.block_size,
                                   self._t_view, ring=self.rolling)
            d_paged = _dec.PagedView(self._dev_dbt, self.block_size,
                                     self.max_len)
        out, tok, pos = _spec_round(
            self.model, self._draft_model, self.caches, self.d_caches,
            self._dev_tok, self._dev_pos, self._dev_act, self._dev_temp,
            self._dev_topk, self._dev_topp, self._dev_keys, self.spec_len,
            self.rolling, paged, d_paged)
        self._dev_spec.copy_(out)
        self._dev_tok.copy_(tok)
        self._dev_pos.copy_(pos)

    def _device_iteration(self) -> None:
        """The bucketed decode iteration, uncaptured: the speculative
        round with a draft, else the plain step."""
        if self._draft_model is not None:
            self._device_round()
        else:
            self._device_step()

    def _capture(self) -> None:
        """Capture :meth:`_device_iteration` (the plain step, or the
        speculative round) as this engine's CUDA graph.  The warm-up run
        before the capture advances the active rows' tokens and positions,
        which are put back (its cache writes are those the first replay
        makes again).  A failed capture raises."""
        saved = (self._dev_tok.clone(), self._dev_pos.clone())
        what = ("speculative round" if self._draft_model is not None
                else "decode step")
        try:
            self._graph = _capture_graph(self._device_iteration, self.device)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of the {what} failed on "
                f"{self.device}: {e!r}") from e
        self._dev_tok.copy_(saved[0])
        self._dev_pos.copy_(saved[1])
        self.stats["graph_captures"] += 1

    # ------------------------------------------------ the prefill programs
    #
    # Each runs eagerly, one per bucket width (never captured): the bucket
    # program prefills up to ``prefills_per_step`` right-padded prompts in
    # one batched forward over a fresh cache of the bucket's width,
    # samples each row's first token, writes the rows into the pool and
    # the slots' device state.  Chunked prefill stages its chunks in a
    # private one-row cache of ``max_len`` (the scalar-position walker);
    # the final chunk samples the first token and commits the whole row.
    # Paged non-rolling engines skip both fresh caches: the bucket program
    # prefills each row's unmatched suffix straight into the arena through
    # its block-table row (queries from the matched length on, attending
    # the shared prefix through the gather, writing above the ``floor`` at
    # the match), and chunks write straight into the request's private
    # blocks (its device table row stays null until the final chunk, so
    # no decode step writes them).  Paged rolling engines prefill densely
    # and commit rings through the table.  The programs also install the
    # slots' device table rows.  Speculative engines fill the draft's pool
    # in the same program from the same prompts: a dense draft pool like
    # the target's, a paged draft arena always straight through its table
    # (it is never rolling).  Every forward goes through ``_dec`` (the
    # decode MODULE); the module-level ``_forward`` import is the eager
    # engine's.

    def _install(self, slots, tok, pos, temp, topk, topp, keys,
                 bt=None, dbt=None) -> None:
        """Write admitted slots' rows of decode state (and, paged, their
        block-table rows ``bt`` and the draft's ``dbt``) into the static
        device tensors, in place (``slots``: an int, a slice, or a device
        tensor of indices)."""
        if bt is not None:
            self._dev_bt[slots] = bt
        if dbt is not None:
            self._dev_dbt[slots] = dbt
        self._dev_tok[slots] = tok.to(torch.int32)
        self._dev_pos[slots] = pos
        self._dev_act[slots] = True
        self._dev_temp[slots] = temp
        self._dev_topk[slots] = topk
        self._dev_topp[slots] = topp
        self._dev_keys[slots] = keys

    def _paged_view(self, bt, floor, p_lens,
                    view: Optional[int] = None) -> "_dec.PagedView":
        """A prefill's view of an arena (the target's, or with ``view``
        ``max_len`` the draft's): rows write from ``floor`` up to their
        prompt's end (``p_lens``), and pad queries clamp onto the last
        real position."""
        return _dec.PagedView(bt, self.block_size,
                              self._t_view if view is None else view,
                              floor=floor, ceil=p_lens, qcap=p_lens - 1)

    def _bucket_prefill(self, width: int, prompts, p_lens, slots, n: int,
                        r_temp, r_topk, r_topp, r_keys, match=None,
                        row_bt=None, row_dbt=None) -> torch.Tensor:
        """One batched prefill of right-padded ``prompts`` (nb, width);
        the first ``n`` rows are admissions into ``slots[:n]``, the rest
        write nothing (paged: their null table rows send every write to
        the null block).  Paged engines pass each row's matched prefix
        length ``match`` (the prompts are the unmatched suffixes) and its
        block-table row ``row_bt`` (speculative ones the draft's
        ``row_dbt`` too).  Returns the (nb,) first tokens."""
        model, draft = self.model, self._draft_model
        direct = self.paged and not self.rolling
        if direct:
            logits, _ = _dec._forward(model, self.caches, prompts, match,
                                      paged=self._paged_view(row_bt, match,
                                                             p_lens))
            idx = (p_lens - match - 1).clamp(0, width - 1)
        else:
            rows = init_cache(model, prompts.shape[0], width)
            # right-padded batch: the causal mask alone keeps pad keys out
            # of every real row, and the pad slots each row writes stay
            # behind its decode frontier until overwritten
            logits, rows = _dec._forward(model, rows, prompts, 0)
            idx = (p_lens - 1).clamp(0, width - 1)
        last = torch.gather(logits, 1, idx.to(torch.int64)[:, None, None]
                            .expand(-1, 1, logits.shape[-1]))[:, 0]
        first = _dec.sample_logits_batched(last, p_lens - 1, r_temp, r_keys,
                                           r_topk, r_topp)
        if self.paged and self.rolling:
            _commit_ring_blocks(self.caches, rows, p_lens, row_bt,
                                self.block_size, self._t_view)
        drows = None
        if draft is not None:
            if self.paged:
                # match is 0 on rolling engines (no sharing on rings)
                _dec._forward(draft, self.d_caches, prompts, match,
                              paged=self._paged_view(row_dbt, match, p_lens,
                                                     self.max_len))
            else:
                drows = init_cache(draft, prompts.shape[0], width)
                _, drows = _dec._forward(draft, drows, prompts, 0)
        if n:
            s = slots[:n]
            if not self.paged:
                for big, row in zip(self.caches, rows):
                    _commit_rows(big, row, s, width, self.rolling,
                                 p_lens[:n])
                if drows is not None:
                    for big, row in zip(self.d_caches, drows):
                        _commit_rows(big, row, s, width, False, p_lens[:n])
            self._install(s, first[:n], p_lens[:n], r_temp[:n], r_topk[:n],
                          r_topp[:n], r_keys[:n],
                          bt=row_bt[:n] if self.paged else None,
                          dbt=(row_dbt[:n] if row_dbt is not None
                               else None))
        return first

    def _paged_chunk(self, toks, offset: int, p_len: int, bt, dbt=None):
        """One chunk of a paged non-rolling chunked prefill, straight into
        the request's blocks through its (1, T) table row ``bt`` (and the
        draft's arena through ``dbt``): queries from ``offset`` on, writes
        from ``offset`` up to ``p_len``.  Returns the chunk's logits."""
        dev = self.device
        off = torch.full((1,), offset, dtype=torch.int64, device=dev)
        plen = torch.full((1,), p_len, dtype=torch.int64, device=dev)
        logits, _ = _dec._forward(self.model, self.caches, toks, off,
                                  paged=self._paged_view(bt, off, plen))
        if self._draft_model is not None:
            _dec._forward(self._draft_model, self.d_caches, toks, off,
                          paged=self._paged_view(dbt, off, plen,
                                                 self.max_len))
        return logits

    def _stage_chunk(self, job: _PrefillJob, toks, offset: int) -> None:
        """A mid chunk of a staged chunked prefill: its cache writes into
        the job's staging caches (the target's, and the draft's)."""
        _, job.staging = _dec._forward(self.model, job.staging, toks, offset)
        if self._draft_model is not None:
            _, job.d_staging = _dec._forward(self._draft_model,
                                             job.d_staging, toks, offset)

    def _final_chunk(self, staging, toks, slot: int, offset: int,
                     last_idx: int, p_len: int, r_temp, r_topk, r_topp,
                     r_key, bt=None, d_staging=None,
                     dbt=None) -> torch.Tensor:
        """The last chunk of a chunked prefill: its forward, the first
        token, and — for a real slot (< ``num_slots``) — the full-row
        commit and the slot's device state.  Paged engines pass the job's
        (1, T) table row ``bt``: non-rolling ones write the chunk straight
        into the arena (``staging`` is None), rolling ones commit the
        staged row's ring through the table (null rows write the null
        block), and the slot's table row is installed.  Speculative
        engines do the same for the draft (``d_staging``, ``dbt``; the
        draft's staged row commits whole, never as a ring).  Returns the
        (1,) first token."""
        draft = self._draft_model
        if self.paged and not self.rolling:
            logits = self._paged_chunk(toks, offset, p_len, bt, dbt)
        else:
            logits, staging = _dec._forward(self.model, staging, toks,
                                            offset)
            if draft is not None:
                _, d_staging = _dec._forward(draft, d_staging, toks, offset)
        pos = torch.full((1,), p_len - 1, dtype=torch.int64,
                         device=self.device)
        first = _dec.sample_logits_batched(logits[0, last_idx][None], pos,
                                           r_temp, r_key, r_topk, r_topp)
        if self.paged and self.rolling:
            _commit_ring_blocks(self.caches, staging, pos + 1, bt,
                                self.block_size, self._t_view)
            if draft is not None:
                _commit_view_blocks(self.d_caches, d_staging, pos + 1, dbt,
                                    self.block_size, self.max_len)
        if slot < self.num_slots:
            if not self.paged:
                for big, row in zip(self.caches, staging):
                    _commit_full_row(big, row, slot, self.rolling, pos + 1)
                if draft is not None:
                    for big, row in zip(self.d_caches, d_staging):
                        _commit_full_row(big, row, slot, False, pos + 1)
            self._install(slot, first[0], p_len, r_temp[0], r_topk[0],
                          r_topp[0], r_key[0],
                          bt=bt[0] if self.paged else None,
                          dbt=dbt[0] if dbt is not None else None)
        return first

    def _copy_block(self, src: int, dst: int) -> None:
        """The copy-on-write copy: physical block ``src`` duplicated onto
        ``dst`` in every layer's arena, the target's and the draft's, in
        place (from host ints: slices, no upload), so that an admission
        that matched a cached block partially writes its own suffix into
        the copy while the original stays shared."""
        bs = self.block_size
        for cache in [*self.caches, *(self.d_caches or [])]:
            if cache is not None:
                for leaf in cache.values():
                    leaf[dst * bs:(dst + 1) * bs] = leaf[src * bs:
                                                         (src + 1) * bs]

    # ----------------------------------------------------- device traffic
    def _put(self, x) -> torch.Tensor:
        """Host→device upload (admission and resume inputs only: a numpy
        array or a host tensor).  Counted so the transfer discipline is
        assertable: a decode-only iteration performs ZERO uploads.  On a
        card it goes through pinned memory without waiting for the
        card."""
        self.stats["h2d_transfers"] += 1
        t = (x if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(x)))
        if self.device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)
        return t.to(self.device)

    def _snapshot(self, t: torch.Tensor):
        """Start the read of device tensor ``t`` to the host: on a card an
        asynchronous copy into pinned memory with an event behind it
        (waited for by :meth:`_fetch`, one iteration later); elsewhere a
        copy."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _fetch(self, snap) -> np.ndarray:
        """Device→host readback — the ONE transfer per drained step (the
        sampled token row, or a prefill batch's first tokens)."""
        self.stats["d2h_transfers"] += 1
        host, event = snap
        if event is not None:
            event.synchronize()
        return host.numpy()

    def _sampling_row(self, h: RequestHandle):
        """One request's sampling parameters as (1,)-shaped device rows
        for the final chunk."""
        return (self._put(np.asarray([h.temperature], np.float32)),
                self._put(np.asarray(
                    [0 if h.top_k is None else int(h.top_k)], np.int64)),
                self._put(np.asarray(
                    [0.0 if h.top_p is None else float(h.top_p)],
                    np.float32)),
                self._put(np.asarray(h.key, np.int64)[None]))

    # ------------------------------------------------------------ admission
    def submit(self, prompt, num_steps: int, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_id: Optional[int] = None, pad_id: Optional[int] = None,
               seed: int = 0, rng=None, block: bool = True,
               timeout: Optional[float] = None,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: int = 0) -> RequestHandle:
        """Enqueue one request; returns its :class:`RequestHandle`.

        ``prompt``: (P,) int tokens.  Sampling/stopping knobs mirror
        ``generate`` (that is the determinism contract); the request's key
        is ``rng`` if given (an int seed, a ``torch.Generator`` or two key
        words), else ``seed``'s.  Backpressure: with the queue at
        ``queue_capacity``, ``block=True`` waits (up to ``timeout``),
        ``block=False`` raises :class:`QueueFull` immediately.
        ``deadline_s`` (default: the tenant's ``TenantPolicy.deadline_s``,
        else the engine's ``default_deadline_s``) bounds the request's
        whole lifetime, queueing included.  Raises :class:`Draining` while
        ``drain`` is in progress and :class:`EngineDead` on a dead engine.

        QoS: ``tenant`` names the submitting tenant (default
        ``"default"``); admission is weighted-fair across backlogged
        tenants by their registered :class:`TenantPolicy`, and a tenant
        over its token-bucket quota raises :class:`QuotaExceeded` at once
        (also with ``block=True``).  ``priority`` orders requests within a
        tenant's queue (higher first) and picks preemption victims (lower
        first)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D tokens, got shape "
                             f"{prompt.shape} — submit one request per row")
        if num_steps < 0:
            raise ValueError(f"num_steps must be >= 0, got {num_steps}")
        tenant = "default" if tenant is None else str(tenant)
        priority = int(priority)
        if deadline_s is None:
            with self._qlock:  # register_tenant may race admission
                pol = self._tenants.get(tenant)
            if pol is not None and pol.deadline_s is not None:
                deadline_s = pol.deadline_s
            else:
                deadline_s = self.default_deadline_s
        elif deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        key = np.asarray(rng_key(rng if rng is not None else int(seed)),
                         np.uint32)
        _validate_sampling(temperature, key, top_k, top_p)
        _validate_stopping(eos_id, pad_id, self._vocab)
        total = len(prompt) + int(num_steps)
        if len(prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if total > self.max_len:
            raise ValueError(f"prompt ({len(prompt)}) + num_steps "
                             f"({num_steps}) = {total} exceeds the engine's "
                             f"max_len {self.max_len}")
        with self._qlock:
            if self._dead is not None:
                raise EngineDead(str(self._dead)) from self._dead
            if self._draining:
                raise Draining("serving engine is draining; admission "
                               "stopped")
            pol = self._tenants.get(tenant)
            if pol is not None and not pol._take(time.monotonic()):
                # a policy refusal, before requests_submitted counts (so
                # drain's terminal accounting never waits on it) and apart
                # from requests_rejected (it does not dilute shed_rate)
                self._tenant_stats(tenant)["quota_refused"] += 1
                self.stats["quota_refused"] += 1
                raise QuotaExceeded(
                    f"tenant {tenant!r} over its token-bucket quota "
                    f"({pol.rate}/s, burst {pol.burst})")
            self._next_id += 1
            handle = RequestHandle(self._next_id, prompt, num_steps,
                                   temperature, top_k, top_p, eos_id,
                                   pad_id, key, deadline_s=deadline_s,
                                   tenant=tenant, priority=priority)
            self.stats["requests_submitted"] += 1
            tstats = self._tenant_stats(tenant)
            tstats["submitted"] += 1
            if num_steps == 0:  # nothing to generate: complete in place
                handle._finish("empty")
                self.stats["requests_completed"] += 1
                tstats["completed"] += 1
                return handle
            while self._qdepth >= self.queue_capacity:
                if not block or not self._not_full.wait(timeout=timeout):
                    self.stats["requests_rejected"] += 1
                    tstats["shed"] += 1
                    raise QueueFull(
                        f"admission queue at capacity "
                        f"({self.queue_capacity}); request {handle.id} shed")
                # _declare_dead / drain notify _not_full while we wait —
                # re-check on every wake, or the request lands in a queue
                # no scheduler will ever pop; both raises count as sheds
                if self._dead is not None:
                    self.stats["requests_rejected"] += 1
                    raise EngineDead(str(self._dead)) from self._dead
                if self._draining:
                    self.stats["requests_rejected"] += 1
                    raise Draining("serving engine is draining; admission "
                                   "stopped")
            self._q_push(handle)
            qd = self._qdepth
            self.stats["queue_peak"] = max(self.stats["queue_peak"], qd)
            self._have_work.notify()
        self._publish_load(qd=qd)
        return handle

    @property
    def queue_depth(self) -> int:
        with self._qlock:
            return self._qdepth

    # ------------------------------------------------- tenant QoS plumbing
    def register_tenant(self, policy: TenantPolicy) -> None:
        """Install (or replace) one tenant's :class:`TenantPolicy`.
        Thread-safe; it takes effect at the next admission.  A request
        naming no tenant, or one not registered, is treated as batch tier,
        weight 1, no quota."""
        if not isinstance(policy, TenantPolicy):
            raise ValueError(f"expected a TenantPolicy, got "
                             f"{type(policy).__name__}")
        with self._qlock:
            self._tenants[policy.name] = policy

    def _tenant_stats(self, tenant: str) -> Dict[str, int]:
        """The tenant's counter dict, made at first use.  The caller holds
        ``_qlock``."""
        ts = self.stats["tenants"].get(tenant)
        if ts is None:
            ts = {"submitted": 0, "completed": 0, "shed": 0,
                  "quota_refused": 0, "preemptions": 0, "resumes": 0}
            self.stats["tenants"][tenant] = ts
        return ts

    def _tier_of(self, tenant: str) -> str:
        """The tenant's tier (``"batch"`` when not registered).  The
        caller holds ``_qlock``."""
        pol = self._tenants.get(tenant)
        return "batch" if pol is None else pol.tier

    def _q_push(self, h: RequestHandle, front: bool = False) -> None:
        """Enqueue under ``_qlock``.  A tenant joining the backlog starts
        its stride pass at the least pass among backlogged tenants, so
        idle time banks no credit."""
        q = self._queues.get(h.tenant)
        if q is None:
            q = self._queues[h.tenant] = []
        if not q:
            floor = min((self._wf_pass.get(n, 0.0)
                         for n, qq in self._queues.items() if qq),
                        default=0.0)
            self._wf_pass[h.tenant] = max(
                self._wf_pass.get(h.tenant, 0.0), floor)
        if front:
            q.insert(0, h)
        else:
            q.append(h)
        self._qdepth += 1
        if self._tier_of(h.tenant) == "interactive":
            self._q_int += 1

    def _q_pop_locked(self) -> Optional[RequestHandle]:
        """The weighted-fair pick under ``_qlock``: interactive-tier
        tenants strictly before batch-tier ones; within a tier the
        backlogged tenant of least stride pass (ties by name; ``pass +=
        1 / weight`` a pick); within a tenant the highest ``priority``,
        FIFO among equals.  One tenant of uniform priority pops FIFO."""
        best_name, best_key = None, None
        for name, q in self._queues.items():
            if not q:
                continue
            lvl = 0 if self._tier_of(name) == "interactive" else 1
            key = (lvl, self._wf_pass.get(name, 0.0), name)
            if best_key is None or key < best_key:
                best_name, best_key = name, key
        if best_name is None:
            return None
        q = self._queues[best_name]
        idx = max(range(len(q)), key=lambda i: (q[i].priority, -i))
        h = q.pop(idx)
        self._qdepth -= 1
        if self._tier_of(best_name) == "interactive":
            self._q_int -= 1
        pol = self._tenants.get(best_name)
        weight = 1.0 if pol is None else pol.weight
        self._wf_pass[best_name] = (self._wf_pass.get(best_name, 0.0)
                                    + 1.0 / weight)
        return h

    def _q_snapshot_locked(self) -> List[RequestHandle]:
        """Every queued handle, tenant by tenant, under ``_qlock``."""
        return [h for q in self._queues.values() for h in q]

    def _q_clear_locked(self) -> List[RequestHandle]:
        """Empty every queue under ``_qlock``; returns what was queued."""
        out = self._q_snapshot_locked()
        self._queues.clear()
        self._qdepth = 0
        self._q_int = 0
        return out

    @property
    def active_requests(self) -> int:
        return int(self._active.sum())

    # --------------------------------------------------- load snapshot
    def _publish_load(self, qd: Optional[int] = None,
                      draining: Optional[bool] = None,
                      dead: Optional[bool] = None) -> None:
        """Republish the lock-free load snapshot.  Called outside any
        ``_qlock`` block; a ``None`` field carries the previous value."""
        prev = self._load_snapshot
        stats = self.stats
        with self._qlock:
            qi = self._q_int
        self._load_snapshot = {
            "queue_depth": prev["queue_depth"] if qd is None else int(qd),
            "slots_free": len(self._free),
            "slots_total": self.num_slots,
            "active": int(self._active.sum()),
            "trie_blocks": self._pool.trie_nodes if self.paged else 0,
            "queue_capacity": self.queue_capacity,
            "max_len": self.max_len,
            "draining": (prev["draining"] if draining is None
                         else bool(draining)),
            "dead": prev["dead"] if dead is None else bool(dead),
            "prefix_hit_tokens": stats["prefix_hit_tokens"],
            "prefill_tokens": stats["prefill_tokens"],
            "tokens_generated": stats["tokens_generated"],
            "requests_completed": stats["requests_completed"],
            "requests_failed": stats["requests_failed"],
            "queued_interactive": qi,
        }

    def load(self) -> Dict[str, Any]:
        """Cheap read-only load snapshot for routing decisions (no locks;
        values may trail the engine by one iteration)."""
        return dict(self._load_snapshot)

    def _pop_queued(self) -> Optional[RequestHandle]:
        with self._qlock:
            h = self._q_pop_locked()
            if h is None:
                return None
            self._not_full.notify()
            qd = self._qdepth
        self._publish_load(qd=qd)
        return h

    # ------------------------------------------------- cancel + deadlines
    def cancel(self, handle: RequestHandle) -> bool:
        """Request cancellation (thread-safe, any thread): the scheduler
        retires the request with reason ``"cancel"`` within ONE iteration
        — a queued request is shed before prefill, a running one frees its
        slot.  Returns False if the request already finished."""
        with handle._cond:
            if handle.finish is not None:
                return False
            if handle.cancelled_at is None:
                handle.cancelled_at = time.perf_counter()
        with self._qlock:
            self._have_work.notify_all()  # prompt reclamation on idle loops
        return True

    def _reap(self) -> bool:
        """Retire cancelled and deadline-expired requests: queued ones are
        shed before ever taking a slot; running and mid-chunked-prefill
        ones free their slot; suspended ones drop their host copy.  Runs
        at the top of every iteration."""
        now = time.perf_counter()
        shed: List[RequestHandle] = []
        with self._qlock:
            for name, q in self._queues.items():
                if not any(h.cancelled_at is not None or h._expired(now)
                           for h in q):
                    continue
                keep: List[RequestHandle] = []
                for h in q:
                    if h.cancelled_at is not None or h._expired(now):
                        shed.append(h)
                        self._qdepth -= 1
                        if self._tier_of(name) == "interactive":
                            self._q_int -= 1
                    else:
                        keep.append(h)
                self._queues[name] = keep
            if shed:
                self._not_full.notify_all()
        for h in shed:
            reason = "cancel" if h.cancelled_at is not None else "deadline"
            if h._finish(reason):
                # held_slot=False: a queued shed never held a KV slot, so
                # it adds no slot_reclaim_ms sample
                self._account_terminal(h, reason, now, held_slot=False)
                with self._qlock:  # drain()'s busy() sums this cross-thread
                    self.stats["requests_completed"] += 1
                    self._tenant_stats(h.tenant)["completed"] += 1
        did = bool(shed)
        for slot in np.flatnonzero(self._active):
            h = self._handles[slot]
            if h.cancelled_at is not None:
                self._retire(int(slot), "cancel")
                did = True
            elif h._expired(now):
                self._retire(int(slot), "deadline")
                did = True
        for slot in list(self._prefilling):
            h = self._prefilling[slot].handle
            if h.cancelled_at is not None:
                self._abort_prefill(slot, "cancel")
                did = True
            elif h._expired(now):
                self._abort_prefill(slot, "deadline")
                did = True
        # a suspended request holds no slot and no block: its cancel or
        # deadline drops the host copy and retires the handle (no
        # slot_reclaim_ms sample: nothing to reclaim)
        with self._qlock:  # _declare_dead clears _suspended cross-thread
            susp = list(self._suspended.items())
        for rid, rec in susp:
            h = rec.handle
            if h.cancelled_at is not None:
                reason = "cancel"
            elif h._expired(now):
                reason = "deadline"
            else:
                continue
            with self._qlock:
                self._suspended.pop(rid, None)
            if h._finish(reason):
                self._account_terminal(h, reason, now, held_slot=False)
                with self._qlock:
                    self.stats["requests_completed"] += 1
                    self._tenant_stats(h.tenant)["completed"] += 1
            did = True
        return did

    def _abort_prefill(self, slot: int, reason: str) -> None:
        """Retire a request mid-chunked-prefill: the slot goes straight
        back to the pool (its staging cache dies with the job; the pool
        row is rewritten by the next occupant's prefill).  Paged engines
        release the job's block plan: refcounts drop and its private
        blocks, chunks written so far included, go back to the allocator;
        the slot's device table row was never installed, so no decode
        write can reach them once they are handed out again."""
        h = self._prefilling.pop(slot).handle
        self._handles[slot] = None
        self._free.append(slot)
        self._release_blocks(slot)
        if h._finish(reason):
            with self._qlock:
                self.stats["requests_completed"] += 1
                self._tenant_stats(h.tenant)["completed"] += 1
            self._account_terminal(h, reason, time.perf_counter())

    def _release_blocks(self, slot: int) -> None:
        if self._pool is None:
            return
        plan = self._plans.pop(slot, None)
        if plan is not None:
            self._pool.release(plan)

    def _account_terminal(self, h: RequestHandle, reason: str,
                          now: float, held_slot: bool = True) -> None:
        """Reason counters, plus — for requests that held a KV slot — the
        slot-reclaim latency sample (cancel/expiry instant → slot free)."""
        if reason == "cancel":
            self.stats["requests_cancelled"] += 1
            if held_slot and h.cancelled_at is not None:
                self.stats["slot_reclaim_ms"].append(
                    round((now - h.cancelled_at) * 1e3, 3))
        elif reason == "deadline":
            self.stats["requests_expired"] += 1
            if held_slot and h.deadline is not None:
                self.stats["slot_reclaim_ms"].append(
                    round((now - h.deadline) * 1e3, 3))

    # ------------------------------------------------------------- prefill
    def _prefill(self, slot: int, h: RequestHandle) -> None:
        """EAGER-mode admission (the reference path): one per-request
        prompt forward through the same ``_forward`` that ``generate``
        prefills with, the first token through the shared
        ``sample_logits``, the cache row written into the pool."""
        p_len = len(h.prompt)
        prompt = torch.as_tensor(h.prompt[None], device=self.device)
        row = init_cache(self.model, 1,
                         p_len if self.rolling else self.max_len)
        logits, row = _forward(self.model, row, prompt, 0)
        first = sample_logits(logits[:, -1], p_len - 1, h.temperature,
                              h.key, h.top_k, h.top_p)
        for layer, big, cache in zip(self.model.layers, self.caches, row):
            if big is None:
                continue
            for name in ("k", "v"):
                src = cache[name]
                if self.rolling:
                    src = _to_ring(src, p_len,
                                   layer._mha().attention_window)
                big[name][slot] = src[0]
        h.slot = slot
        h.started_at = time.perf_counter()
        self._handles[slot] = h
        self._mirror_admit(slot, h)
        token = int(first[0])
        self._cur_tok[slot] = token
        self.stats["prefills"] += 1
        self.stats["slot_requests"][slot] += 1
        self.stats["prefill_tokens"] += p_len
        self._emit(slot, token)

    def _bucket_of(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _schedule_prefills(self) -> bool:
        """Spend up to ``prefills_per_step`` prefill work units this
        iteration: first advance chunked prefills already holding slots
        (one chunk each), then admit queued requests.  Bucketed mode
        gathers short prompts into per-bucket batches and routes prompts
        longer than ``prefill_chunk`` to the chunked path; eager mode
        prefills per request.

        Paged engines walk the radix trie per admission: matched prefix
        blocks are shared (copied on write at a partial boundary), the
        block chain is reserved from the allocator, and when blocks run
        out even after evicting cached chains the head request goes back
        to the front of its queue until retirements free blocks
        (head-of-line: admission order is the fairness contract).  Chunked
        routing keys on the unmatched suffix length, so a long prompt
        with a hot prefix admits in one bucket program."""
        did = False
        budget = self.prefills_per_step
        if self.paged:
            self._pool.next_epoch()
        for slot in list(self._prefilling):
            if budget <= 0:
                break
            self._advance_chunk(slot)
            budget -= 1
            did = True
        batch: List[RequestHandle] = []
        plans: Dict[int, _BlockPlan] = {}
        while budget > 0 and len(self._free) > len(batch):
            h = self._pop_queued()
            if h is None:
                break
            plan = None
            if self.paged:
                plan = self._admit_blocks(h)
                if plan is None:
                    # an interactive request starving on blocks (not
                    # slots) flags the next iteration's preemption pass
                    with self._qlock:
                        interactive = (self._tier_of(h.tenant)
                                       == "interactive")
                        self._q_push(h, front=True)
                        qd = self._qdepth
                    if interactive:
                        self._int_blocked = True
                    self._publish_load(qd=qd)
                    break
            budget -= 1
            did = True
            if self.prefill_mode == "eager":
                self._prefill(self._free.pop(), h)
            elif (len(h.prompt) - (plan.matched if plan else 0)
                    > self.prefill_chunk):
                self._start_chunked(self._free.pop(), h, plan)
            else:
                if plan is not None:
                    plans[h.id] = plan
                    self._pool.publish(plan, h.prompt)
                batch.append(h)
        if batch:
            self._batch_prefill(batch, plans)
        return did

    # ----------------------------------------------------- paged admission
    def _admit_blocks(self, h: RequestHandle) -> Optional[_BlockPlan]:
        """Reserve a request's block chain (trie walk and allocation) and
        make its copy-on-write block copy, if any.  Positions past the
        request's end go to the null block through the table, so
        ``ceil((p_len + num_steps) / block_size)`` blocks cover every
        entry a live query can attend."""
        if self.rolling:
            plan = self._pool.admit(None, self._blocks_per_slot)
        else:
            total = len(h.prompt) + h.num_steps
            plan = self._pool.admit(h.prompt, -(-total // self.block_size))
        if plan is not None and plan.cow is not None:
            self._copy_block(*plan.cow)
        return plan

    def _row_tables(self, plan: _BlockPlan):
        """A plan's chain as null-padded block-table rows (their last
        column always null): the target's, and the draft's over
        ``max_len`` (None without a draft)."""
        def row(width):
            t = np.full((width,), self.kv_blocks, np.int64)
            n = min(len(plan.blocks), width - 1)
            t[:n] = plan.blocks[:n]
            return t
        return (row(self._t_tbl),
                row(self._d_tbl) if self._draft_model is not None else None)

    def _batch_prefill(self, batch: List[RequestHandle],
                       plans: Optional[Dict[int, _BlockPlan]] = None
                       ) -> None:
        """Admit up to ``prefills_per_step`` short prompts in ONE batched
        forward per length bucket.  The batch is always
        ``prefills_per_step`` rows; unfilled rows target slot
        ``num_slots`` and write nothing.  Paged engines bucket by the
        unmatched suffix length and pass each row's match and table row;
        ``prefill_tokens`` counts only what is prefilled (the hit tokens
        are in ``prefix_hit_tokens``)."""
        plans = plans or {}
        groups: Dict[int, List[RequestHandle]] = {}
        for h in batch:
            matched = plans[h.id].matched if h.id in plans else 0
            groups.setdefault(self._bucket_of(len(h.prompt) - matched),
                              []).append(h)
        for width, group in groups.items():
            nb = self.prefills_per_step
            prompts = np.zeros((nb, width), np.int32)
            match = np.zeros((nb,), np.int64)
            p_lens = np.ones((nb,), np.int64)
            slots = np.full((nb,), self.num_slots, np.int64)
            r_temp = np.zeros((nb,), np.float32)
            r_topk = np.zeros((nb,), np.int64)
            r_topp = np.zeros((nb,), np.float32)
            r_keys = np.zeros((nb, 2), np.int64)
            row_bt = row_dbt = None
            if self.paged:
                row_bt = np.full((nb, self._t_tbl), self.kv_blocks,
                                 np.int64)
                if self._draft_model is not None:
                    row_dbt = np.full((nb, self._d_tbl), self.kv_blocks,
                                      np.int64)
            entries: List[Tuple[int, RequestHandle]] = []
            for i, h in enumerate(group):
                slot = self._free.pop()
                p = len(h.prompt)
                m = 0
                if self.paged:
                    plan = plans[h.id]
                    m = plan.matched
                    self._plans[slot] = plan
                    rb, rd = self._row_tables(plan)
                    row_bt[i] = rb
                    if rd is not None:
                        row_dbt[i] = rd
                prompts[i, :p - m] = h.prompt[m:]
                match[i] = m
                p_lens[i] = p
                slots[i] = slot
                r_temp[i] = h.temperature
                r_topk[i] = 0 if h.top_k is None else int(h.top_k)
                r_topp[i] = 0.0 if h.top_p is None else float(h.top_p)
                r_keys[i] = np.asarray(h.key, np.int64)
                h.slot = slot
                h.started_at = time.perf_counter()
                self._handles[slot] = h
                self._mirror_admit(slot, h)
                self.stats["prefills"] += 1
                self.stats["slot_requests"][slot] += 1
                self.stats["prefill_tokens"] += p - m
                entries.append((slot, h))
            paged = {}
            if self.paged:
                paged = dict(match=self._put(match),
                             row_bt=self._put(row_bt))
                if row_dbt is not None:
                    paged["row_dbt"] = self._put(row_dbt)
            first = self._bucket_prefill(
                width, self._put(prompts), self._put(p_lens),
                self._put(slots), len(group), self._put(r_temp),
                self._put(r_topk), self._put(r_topp), self._put(r_keys),
                **paged)
            self.stats["prefill_batches"] += 1
            self.stats["prefill_batched_requests"] += len(group)
            self.stats["prefill_batch_size_mean"] = round(
                self.stats["prefill_batched_requests"]
                / self.stats["prefill_batches"], 3)
            self._pending.append(("prefill", self._snapshot(first),
                                  entries))

    def _start_chunked(self, slot: int, h: RequestHandle,
                       plan: Optional[_BlockPlan] = None) -> None:
        """Claim ``slot`` for a long prompt and run its first chunk; the
        scheduler advances one more chunk per iteration (``_reap`` can
        retire it mid-prefill).  Paged non-rolling jobs have no staging
        cache: chunks write into the request's own blocks, from the
        matched frontier on, so a hot shared prefix skips its chunks."""
        h.slot = slot
        h.started_at = time.perf_counter()
        self._handles[slot] = h
        draft = self._draft_model
        bt = dbt = None
        if self.paged:
            self._plans[slot] = plan
            rb, rd = self._row_tables(plan)
            bt = self._put(rb[None])
            if rd is not None:
                dbt = self._put(rd[None])
        if self.paged and not self.rolling:
            job = _PrefillJob(h, bt=bt, dbt=dbt)
            job.written = plan.matched
        else:
            job = _PrefillJob(
                h, init_cache(self.model, 1, self.max_len), bt,
                None if draft is None else init_cache(draft, 1,
                                                      self.max_len), dbt)
        self._prefilling[slot] = job
        self.stats["prefills"] += 1
        self.stats["slot_requests"][slot] += 1
        self._advance_chunk(slot)

    def _advance_chunk(self, slot: int) -> None:
        """One chunk of one prefilling slot: ``prefill_chunk`` more prompt
        tokens into its staging cache (the final chunk rounds up to a
        length bucket instead, samples the first token, commits the row
        and activates the slot)."""
        job = self._prefilling[slot]
        h = job.handle
        p_len = len(h.prompt)
        remaining = p_len - job.written
        offset = job.written
        if remaining > self._chunk_width:
            width, real, final = self._chunk_width, self._chunk_width, False
        else:
            width, real, final = self._bucket_of(remaining), remaining, True
        toks = np.zeros((1, width), np.int32)
        toks[0, :real] = h.prompt[offset:offset + real]
        toks_d = self._put(toks)
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += real
        if not final:
            if self.paged and not self.rolling:
                self._paged_chunk(toks_d, offset, p_len, job.bt, job.dbt)
            else:
                self._stage_chunk(job, toks_d, offset)
        else:
            first = self._final_chunk(job.staging, toks_d, slot, offset,
                                      real - 1, p_len,
                                      *self._sampling_row(h), bt=job.bt,
                                      d_staging=job.d_staging, dbt=job.dbt)
            job.staging = job.d_staging = None
            if self.paged:
                # the chain's contents are now all dispatched: publish
                # the prompt's full blocks into the prefix trie
                self._pool.publish(self._plans[slot], h.prompt)
        job.written += real
        if final:
            del self._prefilling[slot]
            self._mirror_admit(slot, h)
            self._pending.append(("prefill", self._snapshot(first),
                                  [(slot, h)]))

    def _mirror_admit(self, slot: int, h: RequestHandle) -> None:
        """Host mirrors of the per-slot state the prefill just set on the
        device — the scheduler's bookkeeping view (``_cur_tok`` lands when
        the first token is drained)."""
        self._active[slot] = True
        self._positions[slot] = len(h.prompt)
        self._temp[slot] = h.temperature
        self._topk[slot] = 0 if h.top_k is None else int(h.top_k)
        self._topp[slot] = 0.0 if h.top_p is None else float(h.top_p)
        self._keys[slot] = np.asarray(h.key, np.int64)

    # ---------------------------------------------------------- retirement
    def _emit(self, slot: int, token: int) -> None:
        """Record one produced token for the request in ``slot``; retire on
        eos (the eos itself is emitted, as in ``generate``) or length."""
        h = self._handles[slot]
        h._push(token)
        self.stats["tokens_generated"] += 1
        if h.eos_id is not None and token == h.eos_id:
            self._retire(slot, "eos")
        elif len(h.tokens) >= h.num_steps:
            self._retire(slot, "length")

    def _retire(self, slot: int, reason: str) -> None:
        h = self._handles[slot]
        self._handles[slot] = None
        self._active[slot] = False
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 0.0
        self._positions[slot] = 0
        self._cur_tok[slot] = 0
        self._free.append(slot)
        if self.prefill_mode == "bucketed":
            # deactivate the device row too (a fill on the device, no
            # upload): an in-flight lookahead step may compute one junk
            # token for it (drained entries skip finished handles), but
            # from the next step on the slot is inert until a prefill
            # rewrites it.  Paged: the slot's table row is re-nulled in
            # place, so that junk and every later idle step go to the null
            # block while the released blocks go back to the allocator
            # (the in-flight step is ordered before any program that
            # could reuse them)
            self._dev_act[slot] = False
            if self.paged:
                self._dev_bt[slot] = self.kv_blocks
                if self._dev_dbt is not None:
                    self._dev_dbt[slot] = self.kv_blocks
                self._release_blocks(slot)
        if h._finish(reason):  # no-op when _declare_dead already failed it
            with self._qlock:
                self.stats["requests_completed"] += 1
                self._tenant_stats(h.tenant)["completed"] += 1
            self._account_terminal(h, reason, time.perf_counter())

    # ----------------------------------------------- preemption (QoS swap)
    def preempt(self, handle: RequestHandle) -> bool:
        """Mark a running request for preemption (thread-safe): within one
        iteration its live KV rows and decode frontier are read to host
        memory, its slot and blocks are freed, and it waits, suspended,
        until capacity is free again; then it resumes with the token
        stream it would have emitted unpreempted.  The scheduler takes the
        same path itself when the interactive tier starves.  Returns False
        when the request already finished or the engine cannot preempt
        (it needs ``paged=True``, bucketed prefill, no rolling window and
        no draft)."""
        if not self._can_preempt:
            return False
        with handle._cond:
            if handle.finish is not None:
                return False
        with self._qlock:
            self._preempt_ids.add(handle.id)
            self._have_work.notify_all()
        return True

    def _read_host(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Device→host read of several tensors together, one readback in
        ``d2h_transfers``: on a card asynchronous copies into pinned
        memory behind one event, waited for here; elsewhere copies."""
        self.stats["d2h_transfers"] += 1
        if self.device.type != "cuda":
            return [t.clone() for t in tensors]
        out = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            out.append(host)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        return out

    def _swap_out(self, slot: int, n_src: int):
        """The swap-out program: ``gather_slot_state`` over the first
        ``n_src`` blocks of the slot's device table row (their physical
        rows expanded on the device) with the slot's device token,
        position and key, read to the host together.  Returns the host
        payload (the ``gather_blocks`` layout), token and position."""
        bs = self.block_size
        blocks = self._dev_bt[slot, :n_src]
        rows = (blocks[:, None] * bs
                + torch.arange(bs, device=self.device)[None, :]).reshape(-1)
        dev, tok, pos, _ = _dec.gather_slot_state(
            self.caches, rows, self._dev_tok, self._dev_pos, self._dev_keys,
            slot)
        leaves = [t for c in dev if c is not None for t in c.values()]
        host = iter(self._read_host(leaves + [tok, pos]))
        layers = [None if c is None else {k: next(host) for k in c}
                  for c in dev]
        return layers, int(next(host)), int(next(host))

    def _ingest(self, slot: int, rows, payload, row_bt, tok, pos, temp,
                topk, topp, keys) -> None:
        """The swap-in program (the JAX engine's ``_build_ingest_fn``):
        ``scatter_blocks`` of ``payload`` into the arena rows ``rows`` (a
        device tensor of physical slot indices), then slot ``slot``'s
        device row (table row, token, position, active, sampling
        parameters, key: (1, ...) device tensors) through ``_install``.
        Every write is in place, on the current stream, behind any
        lookahead snapshot: the decode step's CUDA graph replays over the
        ingested row as it is."""
        _dec.scatter_blocks(self.caches, rows, payload)
        self._install(slice(slot, slot + 1), tok, pos, temp, topk, topp,
                      keys, bt=row_bt)

    def _suspend_slot(self, slot: int) -> bool:
        """Swap one running request out: flush the lookahead (so the
        handle's tokens reach the true frontier), read its live KV rows
        and device frontier to the host, then free the slot and its blocks
        as ``_retire`` does, minus the terminal transition.  Returns False
        when the request retired in the flush."""
        h = self._handles[slot]
        if h is None:
            return False
        t0 = time.perf_counter()
        if self._pending:
            self._drain_pending(flush=True)
        if self._handles[slot] is not h or h.finish is not None:
            return False  # eos/length/cancel landed in the flush
        n_src = max(-(-int(self._positions[slot]) // self.block_size), 1)
        layers, tok, pos = self._swap_out(slot, n_src)
        rec = _SuspendedReq(h, layers, n_src, pos, tok)
        self._handles[slot] = None
        self._active[slot] = False
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 0.0
        self._positions[slot] = 0
        self._cur_tok[slot] = 0
        self._free.append(slot)
        self._dev_act[slot] = False
        self._dev_bt[slot] = self.kv_blocks
        self._release_blocks(slot)
        h.slot = None
        nbytes = sum(t.numel() * t.element_size() for c in layers
                     if c is not None for t in c.values())
        with self._qlock:  # _declare_dead drains _suspended cross-thread
            self._suspended[h.id] = rec
            self.stats["preemptions"] += 1
            self._tenant_stats(h.tenant)["preemptions"] += 1
        self.stats["kv_blocks_swapped_out"] += n_src
        self.stats["kv_block_bytes_swapped_out"] += nbytes
        self.stats["preempt_swap_ms"].append(
            (time.perf_counter() - t0) * 1000.0)
        return True

    def _resume_suspended(self, rec: _SuspendedReq) -> bool:
        """Swap one suspended request back in: a free slot, a fresh private
        chain of ``ceil((P + num_steps) / block_size)`` blocks (no trie
        match), the host rows scattered into its first blocks and the
        slot's device row installed at the suspended frontier.  Returns
        False when no slot or no blocks are free (the caller retries)."""
        h = rec.handle
        if not self._free:
            return False
        bs = self.block_size
        total = len(h.prompt) + h.num_steps
        plan = self._pool.admit(None, -(-total // bs))
        if plan is None:
            return False
        t0 = time.perf_counter()
        slot = self._free.pop()
        h.slot = slot
        self._handles[slot] = h
        self._plans[slot] = plan
        self.stats["slot_requests"][slot] += 1
        n_src = rec.n_blocks
        phys = (np.asarray(plan.blocks[:n_src], np.int64)[:, None] * bs
                + np.arange(bs, dtype=np.int64)[None, :]).reshape(-1)
        payload = [None if c is None else {k: self._put(v)
                                           for k, v in c.items()}
                   for c in rec.layers]
        nbytes = sum(t.numel() * t.element_size() for c in rec.layers
                     if c is not None for t in c.values())
        bt, _ = self._row_tables(plan)
        self._ingest(
            slot, self._put(phys), payload, self._put(bt[None]),
            self._put(np.asarray([rec.tok], np.int32)),
            self._put(np.asarray([rec.pos], np.int64)),
            self._put(np.asarray([h.temperature], np.float32)),
            self._put(np.asarray([0 if h.top_k is None else h.top_k],
                                 np.int64)),
            self._put(np.asarray([0.0 if h.top_p is None else h.top_p],
                                 np.float32)),
            self._put(np.asarray(h.key, np.int64)[None]))
        self._mirror_admit(slot, h)
        self._positions[slot] = rec.pos   # the suspended frontier, not
        self._cur_tok[slot] = rec.tok     # the prompt's end
        with self._qlock:
            self.stats["resumes"] += 1
            self._tenant_stats(h.tenant)["resumes"] += 1
        self.stats["kv_blocks_resumed"] += n_src
        self.stats["kv_block_bytes_resumed"] += nbytes
        self.stats["preempt_resume_ms"].append(
            (time.perf_counter() - t0) * 1000.0)
        return True

    def _balance_qos(self) -> bool:
        """The preemption pass (between ``_reap`` and
        ``_schedule_prefills``): suspend the marked requests and, when an
        interactive request waits with no free slot or was refused blocks,
        one batch-tier victim an iteration (least ``priority``, then the
        latest started, then the lowest slot); then resume suspended
        requests oldest first while slots are free and no interactive
        request waits, never one suspended in this pass."""
        did = False
        suspended_now = set()
        with self._qlock:
            explicit = set(self._preempt_ids)
            self._preempt_ids.clear()
            starved = self._q_int > 0
        blocked = self._int_blocked
        self._int_blocked = False
        if explicit:
            for slot in np.flatnonzero(self._active):
                h = self._handles[int(slot)]
                if h is not None and h.id in explicit:
                    if self._suspend_slot(int(slot)):
                        suspended_now.add(h.id)
                        did = True
        if starved and (not self._free or blocked):
            victims = []
            for slot in np.flatnonzero(self._active):
                h = self._handles[int(slot)]
                if h is None:
                    continue
                with self._qlock:
                    tier = self._tier_of(h.tenant)
                if tier == "interactive":
                    continue
                victims.append((h.priority, -(h.started_at or 0.0),
                                int(slot)))
            if victims:
                victims.sort()
                v = self._handles[victims[0][2]]
                if self._suspend_slot(victims[0][2]):
                    suspended_now.add(v.id)
                    did = True
        with self._qlock:  # _declare_dead drains _suspended cross-thread
            waiting_int = self._q_int > 0
            susp = list(self._suspended.items())
        if susp and self._free and not waiting_int:
            for rid, rec in susp:
                if not self._free:
                    break
                if rid in suspended_now:
                    # the capacity it freed goes first to what starved it
                    # (admitted later in this iteration)
                    continue
                if rec.handle.finish is not None:
                    with self._qlock:
                        self._suspended.pop(rid, None)  # failed meanwhile
                    continue
                if not self._resume_suspended(rec):
                    break  # block-starved: wait for retirements
                with self._qlock:
                    self._suspended.pop(rid, None)
                did = True
        return did

    # ------------------------------------------------------------ schedule
    def step(self) -> bool:
        """One engine iteration: retire cancelled/expired requests, run the
        preemption pass (paged engines with QoS work), spend up to
        ``prefills_per_step`` prefill work units, dispatch one decode
        step for every running request, then drain the pipeline's oldest
        in-flight step (one-step lookahead: the device computes step t+1
        while the host emits step t's tokens).  Returns whether any work
        happened."""
        self.last_beat = time.monotonic()
        did = self._reap()
        if self._can_preempt:
            with self._qlock:
                qos_work = bool(self._preempt_ids or self._suspended
                                or self._q_int)
            if qos_work or self._int_blocked:
                did = self._balance_qos() or did
        did = self._schedule_prefills() or did
        if self._active.any():
            self._decode_once()
            did = True
        if self._pending:
            did = self._drain_pending(flush=not self._active.any()) or did
        self._publish_load()
        return did

    def _decode_once(self) -> None:
        if self.prefill_mode == "eager":
            def up(a, dtype=None):
                return torch.as_tensor(a).to(self.device, dtype)
            nxt = self._step(up(self._cur_tok), up(self._positions),
                             up(self._active), up(self._temp),
                             up(self._topk), up(self._topp), up(self._keys))
            nxt = nxt.cpu().numpy()
            self.stats["decode_steps"] += 1
            self.stats["active_slot_steps"] += int(self._active.sum())
            for slot in np.flatnonzero(self._active):
                self._positions[slot] += 1
                self._cur_tok[slot] = nxt[slot]
                self._emit(int(slot), int(nxt[slot]))
            return
        # bucketed: dispatch only — the step reads the static device state
        # (zero uploads), and the sampled row is fetched one iteration
        # later by _drain_pending (one-step lookahead)
        entries = [(int(s), self._handles[s])
                   for s in np.flatnonzero(self._active)]
        if self._graphed:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self.stats["graph_replays"] += 1
        else:
            self._device_iteration()
        self.stats["decode_steps"] += 1
        self.stats["active_slot_steps"] += len(entries)
        if self._draft_model is not None:
            # one speculative round: rows commit 1..spec_len + 1 tokens
            # each, packed with their counts into the one drained array
            self.stats["verify_calls"] += 1
            self.stats["target_calls"] += 1
            self.stats["drafted"] += self.spec_len * len(entries)
            self._pending.append(("spec", self._snapshot(self._dev_spec),
                                  entries))
            return
        self._pending.append(("decode", self._snapshot(self._dev_tok),
                              entries))

    def _drain_pending(self, flush: bool = False) -> bool:
        """Emit the tokens of in-flight steps older than the lookahead
        window (``flush=True`` empties the pipeline).  Each drained entry
        costs exactly one device→host fetch.  A slot whose request retired
        (or was recycled) after dispatch is skipped: the lookahead step
        computed one junk token for it, which dies here."""
        did = False
        keep = 0 if flush else self._lookahead
        while len(self._pending) > keep:
            kind, snap, entries = self._pending.popleft()
            vals = self._fetch(snap)
            for i, (slot, h) in enumerate(entries):
                if h.finish is not None or self._handles[slot] is not h:
                    continue
                if kind == "spec":
                    # row ``slot`` committed n tokens this round; emit in
                    # order and stop the moment eos or length retires the
                    # request (the round's trailing tokens die here, like
                    # any lookahead junk)
                    n = int(vals[slot, -1])
                    self.stats["accepted"] += max(n - 1, 0)
                    self._positions[slot] += n
                    for j in range(n):
                        token = int(vals[slot, j])
                        self._cur_tok[slot] = token
                        self._emit(slot, token)
                        if (h.finish is not None
                                or self._handles[slot] is not h):
                            break
                    continue
                token = int(vals[slot] if kind == "decode" else vals[i])
                if kind == "decode":
                    self._positions[slot] += 1
                self._cur_tok[slot] = token
                self._emit(slot, token)
            did = True
        return did

    def run_until_idle(self, max_steps: Optional[int] = None) -> None:
        """Drive the scheduler inline until queue and slots are empty.  A
        crash inside a step fails every in-flight handle with
        :class:`EngineDead` before re-raising."""
        steps = 0
        while True:
            try:
                if not self.step():
                    return
            except Exception as e:
                self._declare_dead(e)
                raise
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine still busy after {max_steps} steps "
                    f"(queue={self.queue_depth}, "
                    f"active={self.active_requests})")

    @property
    def slot_occupancy(self) -> Optional[float]:
        """Mean fraction of slots doing useful work per decode step — the
        continuous-batching health metric (1.0 = every step fully
        packed)."""
        if not self.stats["decode_steps"]:
            return None
        return (self.stats["active_slot_steps"]
                / (self.stats["decode_steps"] * self.num_slots))

    # --------------------------------------------------- background thread
    def start(self) -> "ServingEngine":
        """Run the scheduler on a background thread; it idles on the work
        condition when nothing is queued or active."""
        if self._thread is not None:
            return self
        with self._qlock:
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dkt-serving-engine")
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        """Stop the background scheduler thread.  A thread that outlives
        ``join_timeout`` is wedged inside a step: it is logged, every
        in-flight handle is failed with :class:`EngineDead`, and the
        thread is detached."""
        with self._qlock:
            self._running = False
            self._have_work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                logger.error(
                    "serving engine decode thread still alive after "
                    "stop(join_timeout=%.1fs) — wedged in a decode step; "
                    "failing in-flight requests and detaching the thread",
                    join_timeout)
                self._declare_dead(EngineDead(
                    f"decode thread wedged: did not exit within "
                    f"stop(join_timeout={join_timeout})"))
            self._thread = None

    def drain(self, timeout: Optional[float] = None,
              poll: float = 0.01) -> bool:
        """Graceful drain: stop admission (``submit`` raises
        :class:`Draining`), let every queued and running request finish,
        then stop the scheduler.  Returns True when everything finished
        within ``timeout`` (None = wait forever); on timeout the remaining
        handles are failed with :class:`EngineDead` (reason ``"drain"``).
        An engine never ``start()``-ed is driven to idle inline."""
        with self._qlock:
            self._draining = True
            self._not_full.notify_all()  # blocked submitters raise Draining
        self._publish_load(draining=True)
        t0 = time.monotonic()

        def busy() -> bool:
            # terminal accounting, not queue+active snapshots: a request
            # between queue-pop and slot activation is in neither, and a
            # suspended one in no slot
            with self._qlock:
                s = self.stats
                return (s["requests_submitted"]
                        > s["requests_completed"] + s["requests_failed"]
                        + s["requests_rejected"])

        def timed_out() -> bool:
            return (timeout is not None
                    and time.monotonic() - t0 > timeout)

        if self._thread is None and self._dead is None:
            while busy() and not timed_out():
                try:
                    self.step()
                except Exception as e:
                    self._declare_dead(e)
                    raise
        else:
            while busy() and self._dead is None and not timed_out():
                time.sleep(poll)
        clean = self._dead is None and not busy()
        if not clean and self._dead is None:
            # declare BEFORE stop so waiters unblock at once with reason
            # "drain"
            self._declare_dead(
                EngineDead(f"drain timed out after {timeout}s with work "
                           f"in flight"), reason="drain")
        self.stop(join_timeout=10.0 if clean else 2.0)
        if not clean:
            self._fail_stragglers(reason="drain")
        return clean

    def _fail_stragglers(self, reason: str) -> None:
        """Post-join sweep: a request the scheduler popped BEFORE
        ``_declare_dead`` swept the queue can land in ``_handles`` (or
        ``_suspended``) during the loop's final iteration; with the loop
        joined, fail it."""
        exc = self._dead
        if exc is None:
            return
        with self._qlock:
            suspended = [rec.handle for rec in self._suspended.values()]
            self._suspended.clear()
        self._fail_suspended(suspended, exc, reason)
        for h in list(self._handles):
            if h is not None and h._fail(EngineDead(str(exc)),
                                         reason=reason):
                with self._qlock:
                    self.stats["requests_failed"] += 1

    # -------------------------------------------------- failure semantics
    def declare_dead(self, reason: str) -> None:
        """Supervisor-facing: mark the engine dead and fail every in-flight
        handle with a typed :class:`EngineDead`."""
        self._declare_dead(EngineDead(reason))

    def _declare_dead(self, cause: BaseException,
                      reason: str = "error") -> None:
        """Terminal engine failure: stop the loop, shed the queue, and fail
        every queued + running handle so no waiter hangs.  Idempotent
        (first cause wins).  The pool is not recycled — a wedged thread
        may still write it; a restart goes through ``respawn_clone``."""
        exc = (cause if isinstance(cause, EngineDead)
               else EngineDead(f"serving engine died: {cause!r}"))
        if exc is not cause:
            exc.__cause__ = cause
        with self._qlock:
            self._running = False
            if self._dead is not None:
                return
            self._dead = exc
            queued = self._q_clear_locked()
            suspended = [rec.handle for rec in self._suspended.values()]
            self._suspended.clear()
            self._not_full.notify_all()
            self._have_work.notify_all()
        # suspended requests are in neither the queue nor _handles: without
        # this their waiters (and drain's terminal accounting) would hang
        self._fail_suspended(suspended, exc, reason)
        for h in queued + [h for h in self._handles if h is not None]:
            # only a true transition counts: a still-running thread may
            # retire a handle concurrently
            if h._fail(EngineDead(str(exc)), reason=reason):
                with self._qlock:
                    self.stats["requests_failed"] += 1
        self._publish_load(qd=0, dead=True)

    def _fail_suspended(self, handles, exc: BaseException,
                        reason: str) -> None:
        """Fail swapped-out requests with an :class:`EngineDead` naming the
        swap-out; each true transition counts a failure (and, as in the
        JAX engine, a completion of its tenant)."""
        for h in handles:
            if h._fail(EngineDead(
                    f"request was swapped out (preempted) and not resumed "
                    f"before engine shutdown: {exc}"), reason=reason):
                with self._qlock:
                    self.stats["requests_failed"] += 1
                    self._tenant_stats(h.tenant)["completed"] += 1

    @property
    def dead(self) -> Optional[BaseException]:
        """The :class:`EngineDead` that killed this engine, or None."""
        return self._dead

    def respawn_clone(self) -> "ServingEngine":
        """A fresh engine over the same model and knobs — new slot pool,
        empty queue, fresh stats (the supervisor's restart path).  The
        draft, ``spec_len`` and both quantization knobs carry over; the
        models are already quantized, so the clone shares them instead of
        quantizing again.  Tenant policies carry over as clones with full
        buckets."""
        with self._qlock:  # register_tenant may race a respawn
            tenant_pols = [p.clone() for p in self._tenants.values()]
        return ServingEngine(
            self.model, num_slots=self.num_slots, max_len=self.max_len,
            queue_capacity=self.queue_capacity,
            prefills_per_step=self.prefills_per_step, rolling=self.rolling,
            default_deadline_s=self.default_deadline_s,
            prefill_mode=self.prefill_mode,
            prefill_chunk=self.prefill_chunk,
            spec_draft=self._draft_model, spec_len=self.spec_len,
            quantize=self.quantize, kv_dtype=self.kv_dtype,
            # the same arena shape, a fresh trie and allocator: cached
            # chains index the dead pool's arena contents
            paged=self.paged, block_size=self.block_size,
            kv_blocks=self.kv_blocks, tenants=tenant_pols or None)

    @property
    def kv_pool_bytes(self) -> int:
        """Device bytes of the target's KV slot pool (the flat block
        arena, null block included, when paged; int8 codes + scales for
        ``kv_dtype="int8"``): the byte accounting behind bench.py's
        ``serving_quant_capacity_slots``."""
        return kv_cache_bytes(self.caches)

    @property
    def kv_blocks_in_use(self) -> Optional[int]:
        """Paged engines: blocks held by live requests (private ones and
        trie-shared ones with a non-zero refcount); 0 when idle, since
        refcount-0 cached chains are reusable capacity, not leaks.  None
        for dense engines."""
        return None if self._pool is None else self._pool.in_use()

    def warmup(self) -> "ServingEngine":
        """Prepare every program before serving traffic: on a CUDA card
        capture the decode iteration's graph (once per engine: the plain
        step, or the speculative round), elsewhere run it once; then —
        bucketed — run every bucket's batched prefill and, when long
        prompts can chunk, the chunk programs (speculative engines: their
        draft halves too), each with every write dropped (slot
        ``num_slots``; paged: all-null block tables, so that every arena
        write goes to the null block, and a null-onto-null copy-on-write
        copy), so that the first live iteration pays no first-call cost.
        Engines that can preempt, with tenants registered, also run one
        swap-out and one ingest, through the null block and a free slot's
        row, which is left inactive with the state of a never-used row.
        Fresh or idle engines only."""
        if self._active.any() or self._prefilling:
            raise RuntimeError("warmup() on an engine with active slots "
                               "would consume a real decode step")
        if self.prefill_mode == "eager":
            def up(a):
                return torch.as_tensor(a).to(self.device)
            self._step(up(self._cur_tok), up(self._positions),
                       up(self._active), up(self._temp), up(self._topk),
                       up(self._topp), up(self._keys))
            return self
        if self._graphed:
            if self._graph is None:
                self._capture()
        else:
            self._device_iteration()
        nb, dev = self.prefills_per_step, self.device
        draft = self._draft_model

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        paged, null_bt, null_dbt = {}, None, None
        if self.paged:
            null_bt = torch.full((nb, self._t_tbl), self.kv_blocks,
                                 dtype=torch.int64, device=dev)
            paged = dict(match=zeros(nb, dtype=torch.int64), row_bt=null_bt)
            if draft is not None:
                null_dbt = torch.full((nb, self._d_tbl), self.kv_blocks,
                                      dtype=torch.int64, device=dev)
                paged["row_dbt"] = null_dbt
            self._copy_block(self.kv_blocks, self.kv_blocks)
        for width in self._buckets:
            self._bucket_prefill(
                width, zeros(nb, width, dtype=torch.int32),
                torch.ones((nb,), dtype=torch.int64, device=dev),
                torch.full((nb,), self.num_slots, dtype=torch.int64,
                           device=dev), 0,
                zeros(nb), zeros(nb, dtype=torch.int64), zeros(nb),
                zeros(nb, 2, dtype=torch.int64), **paged)
        if self.max_len > self.prefill_chunk:
            bt = None if null_bt is None else null_bt[:1]
            dbt = None if null_dbt is None else null_dbt[:1]
            for width in sorted({self._chunk_width, *self._buckets}):
                toks = zeros(1, width, dtype=torch.int32)
                job = _PrefillJob(None, bt=bt, dbt=dbt)
                if self.paged and not self.rolling:
                    self._paged_chunk(toks, 0, 1, bt, dbt)
                else:
                    job.staging = init_cache(self.model, 1, self.max_len)
                    if draft is not None:
                        job.d_staging = init_cache(draft, 1, self.max_len)
                    self._stage_chunk(job, toks, 0)
                self._final_chunk(job.staging, toks, self.num_slots, 0, 0, 1,
                                  zeros(1), zeros(1, dtype=torch.int64),
                                  zeros(1), zeros(1, 2, dtype=torch.int64),
                                  bt=bt, d_staging=job.d_staging, dbt=dbt)
        with self._qlock:
            qos_on = bool(self._tenants)
        if self._can_preempt and qos_on:
            # the free slot's table row is null, so the gather reads and
            # the ingest writes the null block alone
            slot = self._free[-1]
            bs = self.block_size
            rows = self.kv_blocks * bs + torch.arange(bs, device=dev)
            payload = _dec.gather_slot_state(
                self.caches, rows, self._dev_tok, self._dev_pos,
                self._dev_keys, slot)[0]
            self._ingest(slot, rows, payload,
                         null_bt[:1], zeros(1, dtype=torch.int32),
                         zeros(1, dtype=torch.int64), zeros(1),
                         zeros(1, dtype=torch.int64), zeros(1),
                         zeros(1, 2, dtype=torch.int64))
            self._dev_act[slot] = False
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self

    def _loop(self) -> None:
        try:
            while self._running:
                if not self.step():
                    with self._qlock:
                        self._have_work.wait_for(
                            lambda: self._qdepth > 0
                            or bool(self._preempt_ids) or not self._running,
                            timeout=0.05)
        except Exception as e:
            # a crashed decode loop fails loudly: every in-flight handle
            # gets a typed EngineDead instead of hanging its waiter
            logger.exception("serving engine decode loop crashed")
            self._declare_dead(e)

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def attach_ps(self, host: str, port: int, every: int = 1,
                  retry_policy=None, shard_plan=None,
                  shard_addrs=None) -> None:
        """Hot weight reload from a live parameter server: not ported yet
        (it needs the port's socket PS stack)."""
        raise NotImplementedError(
            "ServingEngine.attach_ps: hot weight reload from a parameter "
            "server comes with the async host-PS family (ROADMAP queue A "
            "item 6)")
