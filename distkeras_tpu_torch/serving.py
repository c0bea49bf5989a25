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

Disaggregated serving (``role="prefill"`` / ``"decode"``, paged
non-rolling engines without a draft): a prefill-role engine runs only
prompts — when a request's first token drains, the filled blocks of its
chain are gathered (read-only, trie-shared blocks too) and read to host
memory in one readback as a :class:`networking.KVBlocks` in logical block
order with the request's key, and the request retires ``"prefilled"``; it
never decodes and captures no graph.  A decode-role engine admits only
such block sets (``submit_prefilled``): its scheduler thread allocates a
fresh private chain, scatters the payload into it and installs the slot's
row at the shipped position, in place (the swap-in program of
preemption), so its decode graph replays over the ingested row.
:class:`DisaggPair` puts prefill engines and one decode engine behind the
unified engine's client surface, in process or over the wire.

The wire front-end (:class:`ServingServer`, thread-per-connection or one
selector loop, and :class:`ServingClient`) speaks the frames of the JAX
package's serving wire byte for byte (``networking``, a copy of its
module): ``'q'`` enqueue, ``'r'`` stream, ``'x'`` cancel, ``'k'`` a
shipped block set, ``'s'`` the load snapshot.  Its handler and I/O
threads and the pair's relay loop touch host data only (token lists,
``KVBlocks`` in host memory); only an engine's own scheduler thread
touches its device tensors.

Left for a later slice: hot weight reload from a parameter server
(``attach_ps`` raises ``NotImplementedError`` naming ROADMAP queue A item
6).
"""

from __future__ import annotations

import collections
import copy
import logging
import select
import selectors
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from . import networking
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
    :class:`EngineDead`) and ``"prefilled"`` (a ``role="prefill"`` engine
    finished its half: the first token is pushed and ``kvblocks`` holds
    the request's blocks for the decode engine).  ``key`` is the request's
    two 32-bit key words
    (``core.decode.rng_key``); ``deadline`` an absolute
    ``time.perf_counter()`` instant or None; ``tenant`` and ``priority``
    the QoS fields ``submit`` was given.
    """

    __slots__ = ("id", "prompt", "num_steps", "temperature", "top_k",
                 "top_p", "eos_id", "pad_id", "key", "tokens", "finish",
                 "slot", "submitted_at", "started_at", "first_token_at",
                 "finished_at", "deadline", "error", "cancelled_at",
                 "kvblocks", "tenant", "priority", "_cond", "_chunk_read",
                 "_listener")

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
        #: networking.KVBlocks on a "prefilled" handle (the prefill role's
        #: extraction) or on a decode-role request before its ingest
        self.kvblocks = None
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


def _leaf_dtype(a) -> torch.dtype:
    """The torch dtype of a shipped payload leaf (a numpy array or a host
    tensor)."""
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


def _wire_leaf(t: torch.Tensor):
    """A host tensor read from an arena as a shipped payload leaf: a
    bfloat16 tensor stays a tensor (numpy has no bfloat16), any other
    dtype becomes its numpy array (the JAX package's payload type)."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


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
    an interactive request starves).

    ``role`` (paged, non-rolling, no draft): ``"unified"`` (default) runs
    prompts and tokens; ``"prefill"`` runs prompts only, each request
    retiring ``"prefilled"`` with its blocks on ``handle.kvblocks``;
    ``"decode"`` admits only shipped block sets (``submit_prefilled``).

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
        # -- disaggregation role ("unified": the engine is its whole
        #    self).  "prefill": admissions run the paged prefill programs
        #    and stop before the token loop, the request retiring
        #    "prefilled" with its blocks read to the handle.  "decode":
        #    admission comes from submit_prefilled (a shipped block set
        #    scattered into this engine's own blocks); submit refuses
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"role must be 'unified', 'prefill' or "
                             f"'decode', got {role!r}")
        if role != "unified":
            if not paged:
                raise ValueError(
                    f"role={role!r} needs the paged block arena "
                    "(paged=True): block transfer is defined over "
                    "fixed-size arena blocks")
            if rolling:
                raise ValueError(
                    f"role={role!r} does not compose with rolling pools — "
                    "ring-laid blocks are not positionally addressable on "
                    "the receiving side")
            if spec_draft is not None:
                raise ValueError(
                    f"role={role!r} does not compose with spec_draft: the "
                    "draft arena is engine-private and never shipped")
        self.role = role
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
                             and draft is None and self.role == "unified"
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
            # disaggregation: blocks (and their payload bytes) a prefill-
            # role engine extracted and a decode-role engine ingested;
            # transfer_ms is one sample per extraction (gather + host
            # read) and per ingest (uploads + scatter + install)
            "kv_blocks_shipped": 0, "kv_block_bytes_shipped": 0,
            "kv_blocks_ingested": 0, "kv_block_bytes_ingested": 0,
            "transfer_ms": [],
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
        first).  A ``role="decode"`` engine refuses (``ValueError``): it
        admits shipped block sets only (:meth:`submit_prefilled`)."""
        if self.role == "decode":
            raise ValueError(
                "role='decode' engines admit only shipped block sets "
                "(submit_prefilled) — route plain submissions to the "
                "prefill engine or a DisaggPair")
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

    def submit_prefilled(self, blocks, prompt, first_token: int,
                         num_steps: int, temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         eos_id: Optional[int] = None,
                         pad_id: Optional[int] = None,
                         block: bool = True, timeout: Optional[float] = None,
                         deadline_s: Optional[float] = None,
                         tenant: Optional[str] = None,
                         priority: int = 0) -> RequestHandle:
        """Decode-role admission: enqueue a request whose prefill ran
        elsewhere.  ``blocks`` is the shipped :class:`networking.KVBlocks`
        (the prompt's KV in logical block order and the request's key),
        ``first_token`` the token the prefill engine sampled at the prompt
        boundary, pushed into the handle at once.  ``num_steps`` counts
        every generated token, the shipped one included.  This call only
        queues the request (any thread may make it): the engine's own
        scheduler thread scatters the payload into blocks of its own
        (physical ids never cross engines) and enters the token loop at
        the shipped position.  Geometry that does not fit this engine
        raises ``ValueError``; a torn or hostile payload is rejected by
        ``blocks.validate()`` at the transport boundary, before this
        call.  Backpressure, quota and death behave as in
        :meth:`submit`."""
        if self.role != "decode":
            raise ValueError("submit_prefilled needs role='decode' — "
                             f"this engine is role={self.role!r}")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or len(prompt) < 1:
            raise ValueError(f"prompt must be 1-D tokens (>= 1), got "
                             f"shape {prompt.shape}")
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1 (it counts the "
                             f"shipped first token), got {num_steps}")
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
        kvb = blocks
        if kvb.block_size != self.block_size:
            raise ValueError(
                f"shipped blocks are {kvb.block_size}-token, this arena "
                f"pages {self.block_size}-token blocks")
        if kvb.positions != len(prompt):
            raise ValueError(
                f"shipped positions ({kvb.positions}) disagree with the "
                f"prompt length ({len(prompt)})")
        total = len(prompt) + int(num_steps)
        if total > self.max_len:
            raise ValueError(f"prompt ({len(prompt)}) + num_steps "
                             f"({num_steps}) = {total} exceeds the engine's "
                             f"max_len {self.max_len}")
        if len(kvb.layers) != len(self.caches):
            raise ValueError(
                f"shipped payload spans {len(kvb.layers)} layers, this "
                f"model has {len(self.caches)}")
        for i, (c, mine) in enumerate(zip(kvb.layers, self.caches)):
            if (c is None) != (mine is None):
                raise ValueError(f"layer {i} cache presence disagrees "
                                 "with this model")
            if c is None:
                continue
            if ("ks" in c) != ("ks" in mine):
                raise ValueError(
                    f"layer {i} quantization disagrees: shipped "
                    f"{'int8' if 'ks' in c else 'dense'} KV, this arena is "
                    f"{'int8' if 'ks' in mine else 'dense'}")
            shipped = (tuple(c["k"].shape[1:]), _leaf_dtype(c["k"]))
            held = (tuple(mine["k"].shape[1:]), mine["k"].dtype)
            if shipped != held:
                raise ValueError(
                    f"layer {i} shipped rows are {shipped[0]} {shipped[1]}, "
                    f"this arena holds {held[0]} {held[1]}")
        _validate_stopping(eos_id, pad_id, self._vocab)
        key = np.asarray(kvb.key, np.uint32)
        with self._qlock:
            if self._dead is not None:
                raise EngineDead(str(self._dead)) from self._dead
            if self._draining:
                raise Draining("serving engine is draining; admission "
                               "stopped")
            pol = self._tenants.get(tenant)
            if pol is not None and not pol._take(time.monotonic()):
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
            handle.kvblocks = kvb
            self.stats["requests_submitted"] += 1
            tstats = self._tenant_stats(tenant)
            tstats["submitted"] += 1
            # the shipped first token is this request's first generated
            # token: push it now (TTFT on this engine is the hand-off
            # instant) and complete in place when it already ends the row
            first = int(first_token)
            handle._push(first)
            eos = eos_id is not None and first == int(eos_id)
            if eos or num_steps == 1:
                handle._finish("eos" if eos else "length")
                self.stats["requests_completed"] += 1
                tstats["completed"] += 1
                self.stats["tokens_generated"] += 1
                return handle
            while self._qdepth >= self.queue_capacity:
                if not block or not self._not_full.wait(timeout=timeout):
                    self.stats["requests_rejected"] += 1
                    tstats["shed"] += 1
                    raise QueueFull(
                        f"admission queue at capacity "
                        f"({self.queue_capacity}); request {handle.id} shed")
                if self._dead is not None:
                    self.stats["requests_rejected"] += 1
                    raise EngineDead(str(self._dead)) from self._dead
                if self._draining:
                    self.stats["requests_rejected"] += 1
                    raise Draining("serving engine is draining; admission "
                                   "stopped")
            self.stats["tokens_generated"] += 1
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
        if self.role == "decode":
            # the decode role's admission replaces prefill: each queued
            # handle carries a shipped block set, admitted through one
            # block allocation and the ingest program; without blocks the
            # head goes back to the front of its queue (the fairness
            # contract of the paged path)
            while budget > 0 and self._free:
                h = self._pop_queued()
                if h is None:
                    break
                if not self._ingest(h):
                    with self._qlock:
                        self._q_push(h, front=True)
                        qd = self._qdepth
                    self._publish_load(qd=qd)
                    break
                budget -= 1
                did = True
            return did
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
        entry a live query can attend; a prefill-role engine writes the
        prompt's KV alone (the first token's entry is written by the
        decode engine), so its chain stops at ``ceil(p_len /
        block_size)``."""
        if self.rolling:
            plan = self._pool.admit(None, self._blocks_per_slot)
        else:
            total = len(h.prompt) + (0 if self.role == "prefill"
                                     else h.num_steps)
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

    def _ingest_fn(self, slot: int, rows, payload, row_bt, tok, pos, temp,
                   topk, topp, keys) -> None:
        """The install program of a resume and of the decode role's
        admission (the JAX engine's ``_build_ingest_fn``):
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

    def _install_payload(self, slot: int, h: RequestHandle,
                         plan: _BlockPlan, n_src: int, layers, tok: int,
                         pos: int) -> None:
        """Upload a host payload of ``n_src`` blocks (the
        :func:`~core.decode.gather_blocks` layout) into the first blocks
        of ``plan`` and install slot ``slot``'s row of decode state at
        token ``tok``, position ``pos`` (:meth:`_ingest_fn`), then its
        host mirrors: a resume's and the decode role's admission."""
        bs = self.block_size
        phys = (np.asarray(plan.blocks[:n_src], np.int64)[:, None] * bs
                + np.arange(bs, dtype=np.int64)[None, :]).reshape(-1)
        payload = [None if c is None else {k: self._put(v)
                                           for k, v in c.items()}
                   for c in layers]
        bt, _ = self._row_tables(plan)
        self._ingest_fn(
            slot, self._put(phys), payload, self._put(bt[None]),
            self._put(np.asarray([tok], np.int32)),
            self._put(np.asarray([pos], np.int64)),
            self._put(np.asarray([h.temperature], np.float32)),
            self._put(np.asarray([0 if h.top_k is None else h.top_k],
                                 np.int64)),
            self._put(np.asarray([0.0 if h.top_p is None else h.top_p],
                                 np.float32)),
            self._put(np.asarray(h.key, np.int64)[None]))
        self._mirror_admit(slot, h)
        self._positions[slot] = pos   # the shipped or suspended frontier
        self._cur_tok[slot] = tok

    def _ingest(self, h: RequestHandle) -> bool:
        """Admit one shipped block set (decode role): a fresh private
        chain of ``ceil((P + num_steps) / block_size)`` blocks (no trie
        match, so release is a plain refund at any retirement), the
        payload scattered into its first blocks and the slot's row
        installed at the shipped position with the shipped key, in place.
        Returns False when no blocks are free (the caller requeues the
        request at the front)."""
        kvb = h.kvblocks
        total = len(h.prompt) + h.num_steps
        plan = self._pool.admit(None, -(-total // self.block_size))
        if plan is None:
            return False
        t0 = time.perf_counter()
        slot = self._free.pop()
        h.slot = slot
        h.started_at = t0
        self._handles[slot] = h
        self._plans[slot] = plan
        self.stats["slot_requests"][slot] += 1
        self._install_payload(slot, h, plan, kvb.num_blocks, kvb.layers,
                              h.tokens[0], len(h.prompt))
        self.stats["kv_blocks_ingested"] += kvb.num_blocks
        self.stats["kv_block_bytes_ingested"] += kvb.nbytes
        self.stats["transfer_ms"].append(
            (time.perf_counter() - t0) * 1000.0)
        return True

    def _finish_prefilled(self, slot: int, token: int) -> None:
        """The prefill role's hand-off: the drained first token means the
        request's prompt KV is written, so gather the first ``ceil(P /
        block_size)`` blocks of its chain (read-only: trie-shared blocks
        gather safely; the physical rows expanded on the device from the
        slot's table row), read them to host memory in one readback, hang
        a :class:`networking.KVBlocks` with the request's key on the
        handle, push the token and retire ``"prefilled"`` through
        :meth:`_retire`, which releases the blocks as at any
        retirement."""
        h = self._handles[slot]
        t0 = time.perf_counter()
        bs = self.block_size
        p_len = len(h.prompt)
        n_src = -(-p_len // bs)
        blocks = self._dev_bt[slot, :n_src]
        rows = (blocks[:, None] * bs
                + torch.arange(bs, device=self.device)[None, :]).reshape(-1)
        dev = _dec.gather_blocks(self.caches, rows)
        host = iter(self._read_host(
            [t for c in dev if c is not None for t in c.values()]))
        layers = [None if c is None else {k: _wire_leaf(next(host))
                                          for k in c}
                  for c in dev]
        h.kvblocks = networking.KVBlocks(layers, bs, n_src, p_len,
                                         np.asarray(h.key, np.uint32))
        h._push(token)
        self.stats["tokens_generated"] += 1
        self.stats["kv_blocks_shipped"] += n_src
        self.stats["kv_block_bytes_shipped"] += h.kvblocks.nbytes
        self.stats["transfer_ms"].append(
            (time.perf_counter() - t0) * 1000.0)
        self._retire(slot, "prefilled")

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
        total = len(h.prompt) + h.num_steps
        plan = self._pool.admit(None, -(-total // self.block_size))
        if plan is None:
            return False
        t0 = time.perf_counter()
        slot = self._free.pop()
        h.slot = slot
        self._handles[slot] = h
        self._plans[slot] = plan
        self.stats["slot_requests"][slot] += 1
        n_src = rec.n_blocks
        nbytes = sum(t.numel() * t.element_size() for c in rec.layers
                     if c is not None for t in c.values())
        self._install_payload(slot, h, plan, n_src, rec.layers, rec.tok,
                              rec.pos)
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
        while the host emits step t's tokens).  A prefill-role engine
        never decodes: it drains every dispatched prefill in the same
        iteration.  Returns whether any work happened."""
        self.last_beat = time.monotonic()
        did = self._reap()
        if self._can_preempt:
            with self._qlock:
                qos_work = bool(self._preempt_ids or self._suspended
                                or self._q_int)
            if qos_work or self._int_blocked:
                did = self._balance_qos() or did
        did = self._schedule_prefills() or did
        if self.role == "prefill":
            # no token loop: drain every dispatched prefill now (the
            # drained first token triggers the extraction and hand-off,
            # and nothing else would push a lookahead entry out)
            if self._pending:
                did = self._drain_pending(flush=True) or did
            self._publish_load()
            return did
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
                if self.role == "prefill":
                    self._finish_prefilled(slot, token)
                else:
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
        buckets, and so does the role."""
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
            kv_blocks=self.kv_blocks, role=self.role,
            tenants=tenant_pols or None)

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
        A prefill-role engine never decodes, so it captures no graph: it
        runs the extraction gather (over the null block) instead of the
        decode iteration.  A decode-role engine never prefills: after the
        decode iteration it runs the ingest program alone, as above.
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
        nb, dev = self.prefills_per_step, self.device
        draft = self._draft_model

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        null_rows = (self.kv_blocks * self.block_size
                     + torch.arange(self.block_size, device=dev)
                     if self.paged else None)
        if self.role == "prefill":
            _dec.gather_blocks(self.caches, null_rows)
        elif self._graphed:
            if self._graph is None:
                self._capture()
        else:
            self._device_iteration()
        if self.role == "decode":
            # the ingest program alone (a decode-role engine runs no
            # prefill), through the null block and a free slot's row,
            # left inactive as a never-used row
            slot = self._free[-1]
            payload = _dec.gather_blocks(self.caches, null_rows)
            self._ingest_fn(slot, null_rows, payload,
                            torch.full((1, self._t_tbl), self.kv_blocks,
                                       dtype=torch.int64, device=dev),
                            zeros(1, dtype=torch.int32),
                            zeros(1, dtype=torch.int64), zeros(1),
                            zeros(1, dtype=torch.int64), zeros(1),
                            zeros(1, 2, dtype=torch.int64))
            self._dev_act[slot] = False
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return self

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
            payload = _dec.gather_slot_state(
                self.caches, null_rows, self._dev_tok, self._dev_pos,
                self._dev_keys, slot)[0]
            self._ingest_fn(slot, null_rows, payload,
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


# ---------------------------------------------------------------------------
# wire layer: the serving protocol over the shared frame codec
# ---------------------------------------------------------------------------

#: serving-protocol opcodes (this protocol's own namespace — a serving
#: server port never speaks the PS protocol): 'q' enqueue request (frame:
#: prompt + sampling params → ack/backpressure reply), 'r' stream reply
#: (frame: {"id"} → chunk frames until {"done": True}), 'x' cancel (frame:
#: {"id"} → ack; mid-stream it is unacked — the stream's final frame
#: carries finish="cancel").
OP_ENQUEUE = networking.SERVING_OP_ENQUEUE
OP_STREAM = networking.SERVING_OP_STREAM
OP_CANCEL = networking.SERVING_OP_CANCEL
OP_KVBLOCKS = networking.SERVING_OP_KVBLOCKS
OP_STATS = networking.SERVING_OP_STATS

#: the selectable serving transport cores (``server_core=`` on
#: :class:`ServingServer`): ``"threaded"`` is the seed's
#: thread-per-connection handler, ``"event"`` the one-selector I/O loop
#: (the ``parameter_servers.PS_CORES`` twin — same knob idiom)
SERVING_CORES = ("threaded", "event")

#: event-core receive chunk: big enough that a steady-state request frame
#: lands complete in ONE recv (the parser's zero-copy fast path); larger
#: frames reassemble through the parser accumulator
_EV_RECV_CHUNK = 1 << 20

#: frames coalesced per ``sendmsg`` — comfortably under IOV_MAX, and one
#: loop wake rarely owes a connection more than a few token chunks
_EV_SENDMSG_BATCH = 64


class _EvPoisoned:
    """A deferred KV-block payload that failed its transport-boundary
    ``validate()`` while being deep-copied out of the receive scratch —
    the rejection is replayed when the deferred op is dispatched, so a
    hostile pipelined ``'k'`` sheds the connection through the same
    ``ProtocolError`` path the threaded core uses."""

    __slots__ = ("error",)

    def __init__(self, error: str):
        self.error = str(error)


def _deepcopy_wire_msg(msg: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-copy a parsed wire message whose ndarray leaves are zero-copy
    views into the connection's receive scratch.  Deferred (pipelined)
    ops outlive that scratch — the next ``recv_into`` overwrites it — so
    views must be promoted to owned memory at deferral time."""
    out: Dict[str, Any] = {}
    for k, v in msg.items():
        if isinstance(v, np.ndarray):
            out[k] = np.array(v, copy=True)
        elif isinstance(v, networking.KVBlocks):
            try:
                out[k] = v.validate().decoded()
            except ValueError as e:  # replayed at dispatch (see above)
                out[k] = _EvPoisoned(str(e))
        else:
            out[k] = v
    return out


class _ServingConn:
    """Per-connection state on the serving event loop: the incremental
    frame parser over a pooled receive scratch, the pending-write queue
    with its encode pool, and the streaming-relay state (the handle being
    pumped, ops the client pipelined past it, backpressure flags).

    Touched ONLY on the loop thread — no lock.  The decoded-view lifetime
    contract matches the PS event core: every parsed op is consumed (or
    deep-copied into ``deferred``) before this connection's next
    ``recv_into`` can overwrite the scratch."""

    __slots__ = ("sock", "parser", "out", "out_bytes", "recv_pool",
                 "send_pool", "want_write", "paused", "stream", "deferred",
                 "last_progress", "closed")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.parser = networking.FrameParser(
            frame_ops=OP_ENQUEUE + OP_STREAM + OP_CANCEL + OP_KVBLOCKS)
        self.out: List[memoryview] = []
        self.out_bytes = 0
        self.recv_pool = networking.BufferPool()
        self.send_pool = networking.BufferPool()
        self.want_write = False
        self.paused = False   # backpressure: reads masked off, pump held
        self.stream: Optional[RequestHandle] = None  # handle mid-relay
        self.deferred: List[Tuple[bytes, Dict[str, Any]]] = []
        self.last_progress = 0.0  # perf_counter of the last stream chunk
        self.closed = False


class ServingServer:
    """TCP front-end for a :class:`ServingEngine` — same accept-loop /
    frame-codec / BufferPool idiom as ``SocketParameterServer``, so serving
    clients speak the exact wire the PS stack already speaks.

    Two transport cores behind one constructor knob (``server_core``, the
    ``parameter_servers.PS_CORES`` idiom): ``"threaded"`` (default) keeps
    the seed's thread-per-connection handler bit-identical; ``"event"``
    multiplexes every connection on ONE selector I/O thread
    (``dkt-serving-io``) — per-connection read/write buffers over the
    incremental ``networking.FrameParser``, token frames flushed through
    a socketpair waker when the engine thread pushes (no per-connection
    thread), non-blocking coalesced writes so a slow client never pins
    the relay, and a per-connection outbound cap (``max_conn_buffer``)
    that stops reading from — and pumping to — a client that stops
    reading us.  Protocol, typed errors, counters, and the failure matrix
    below are identical on both cores (docs/serving.md "Event
    transport").

    Per connection: ``'q'`` + request frame → ack ``{"ok": True, "id": n}``
    or a typed rejection (``kind`` ``"backpressure"`` / ``"draining"`` /
    ``"engine_dead"`` / ``"bad_request"``); ``'r'`` + ``{"id": n}`` → a
    stream of ``{"id", "tokens", "done"}`` chunk frames, the last one
    carrying ``done=True`` + ``finish`` (eos/length/deadline/cancel/…) +
    the final padded ``row`` (or a typed error instead of a row when the
    engine died); ``'x'`` + ``{"id": n}`` → cancel ack.  EOF closes the
    connection; the engine keeps running.

    Failure semantics (this is the client-disconnect reclamation layer):

     - every empty stream-poll slice (``poll_s``) checks the client socket
       — EOF/RST cancels the streamed request, so an abandoned connection
       reclaims its KV slot within one scheduler iteration of detection
       instead of decoding to completion;
     - a request is *owned* by the connection that submitted it (ownership
       transfers to whichever connection streams it); when a connection
       dies, its unfinished owned requests are cancelled
       (``cancel_on_disconnect``, default True) and their handles
       released — a dead client leaks neither slots nor handle entries;
     - a stream that makes no progress is bounded by the request deadline
       (plus a grace period) or, for deadline-less requests, by
       ``stream_timeout_s`` — a stalled engine gets a typed ``"stall"``
       error frame instead of pinning the handler thread for a fixed
       minute;
     - a torn/corrupt frame (``protocol_errors``) or transport fault
       (``disconnects``) sheds the connection silently; its pooled
       buffers are per-handler locals so they are released with it, and
       ``live_connections`` decrements (asserted in
       tests/test_torch_serving_wire*.py).
    """

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, stream_timeout_s: float = 60.0,
                 poll_s: float = 0.02, cancel_on_disconnect: bool = True,
                 server_core: str = "threaded",
                 max_conn_buffer: int = 1 << 20):
        if server_core not in SERVING_CORES:
            raise ValueError(f"server_core must be one of "
                             f"{sorted(SERVING_CORES)}, got {server_core!r}")
        self.engine = engine
        self.host = host
        self.port = int(port)
        self.stream_timeout_s = float(stream_timeout_s)
        self.poll_s = float(poll_s)
        self.cancel_on_disconnect = bool(cancel_on_disconnect)
        self.server_core = server_core
        #: event core only: per-connection outbound-buffer cap in bytes.
        #: A client that stops reading its token stream grows the pending
        #: write queue; past this cap the loop stops reading from AND
        #: pumping to that connection until the flush drains below half
        #: the cap (the PS core's oversize-guard idiom, per connection).
        self.max_conn_buffer = int(max_conn_buffer)
        self._handles: Dict[int, RequestHandle] = {}
        #: request id → owning connection (submitting conn, re-claimed by
        #: the streaming conn) — the disconnect-reclamation bookkeeping
        self._owner: Dict[int, socket.socket] = {}
        self._hlock = threading.Lock()
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()  # guards: _conns
        #: lock-free stop flag: written once by start()/stop(), polled by
        #: the accept path on either core — monotonic, so races are benign
        self._running = False
        #: event core: the shared I/O loop and its per-socket conn state
        #: (the latter touched ONLY on the loop thread — no lock)
        self._loop: Optional[networking.EventLoop] = None
        self._econns: Dict[socket.socket, _ServingConn] = {}
        self.disconnects = 0       # transport faults / EOF mid-frame
        self.protocol_errors = 0   # corrupt frames (bad magic, length lies)
        self.disconnect_cancels = 0  # requests reclaimed from dead clients

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)

    @property
    def live_connections(self) -> int:
        """Open client connections with a live handler (the serving twin of
        ``SocketParameterServer.live_connections`` — shed connections must
        decrement this, pooled buffers and all)."""
        with self._lock:
            return len(self._conns)

    def start(self) -> "ServingServer":
        self.engine.start()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._server.listen(128)
        self._running = True
        if self.server_core == "event":
            self._server.setblocking(False)
            self._loop = networking.EventLoop(name="dkt-serving-io")
            self._loop.stop_hooks.append(self._ev_shutdown)
            self._loop.start()
            self._loop.call_soon(
                lambda: self._loop.add(self._server, self._ev_accept))
            # the name is load-bearing: supervisors probe server liveness
            # through ``_accept_thread.is_alive()`` on either core
            self._accept_thread = self._loop.thread
        else:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, daemon=True,
                name="dkt-serving-accept")
            self._accept_thread.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        self._running = False
        if self.server_core == "event":
            loop = self._loop
            if loop is not None and not loop.stop(join_timeout=join_timeout):
                # wedged inside a callback (the loop itself never blocks
                # on a socket): force-close everything from here so the
                # wedged thread fails fast on its next socket op and a
                # same-address respawn can bind
                logger.warning(
                    "serving I/O loop still alive after stop(join_timeout="
                    "%.1fs); force-closing its connections and listener",
                    join_timeout)
                with self._lock:
                    conns = list(self._conns)
                    self._conns.clear()
                for c in conns:
                    networking._hard_close(c)
                if self._server is not None:
                    try:
                        self._server.close()
                    except OSError:
                        pass
            self.engine.stop()
            return
        if self._server is not None:
            try:  # wake the blocked accept()
                socket.create_connection((self.host, self.port),
                                         timeout=1.0).close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=join_timeout)
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self.engine.stop()

    def respawn_clone(self, engine: Optional[ServingEngine] = None
                      ) -> "ServingServer":
        """A same-core replacement server on this address with every
        transport knob carried over — ``server_core`` included, so a
        supervisor restart never silently changes the I/O architecture.
        ``engine`` defaults to this server's (an engine supervisor
        re-points ``.engine`` in place; this seam is for the
        whole-server restart path, mirroring
        ``SocketParameterServer.respawn_clone``)."""
        return ServingServer(
            engine if engine is not None else self.engine,
            host=self.host, port=self.port,
            stream_timeout_s=self.stream_timeout_s, poll_s=self.poll_s,
            cancel_on_disconnect=self.cancel_on_disconnect,
            server_core=self.server_core,
            max_conn_buffer=self.max_conn_buffer)

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            if not self._running:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True, name="dkt-serving-conn").start()

    def _handle(self, conn: socket.socket) -> None:
        # per-connection pools: requests land in a reusable receive buffer,
        # replies re-serialize into a reusable send buffer.  The send pool
        # is per-connection (BufferPool is lock-protected, but a shared
        # pool would still let another connection's encode overwrite a
        # frame between encode and sendall).  Both are handler locals, so
        # every exit path — clean EOF, torn frame, transport fault —
        # releases them with the handler.
        recv_pool = networking.BufferPool()
        send_pool = networking.BufferPool()
        pending_op = b""  # opcode the client pipelined during a stream
        try:
            while True:
                if pending_op:
                    op, pending_op = pending_op, b""
                else:
                    op = networking.recv_opcode(conn)
                if op == b"":
                    return
                if op == OP_ENQUEUE:
                    msg = networking.recv_data(conn, pool=recv_pool)
                    try:
                        h = self.engine.submit(
                            np.array(msg["prompt"], np.int32, copy=True),
                            int(msg["num_steps"]),
                            temperature=float(msg.get("temperature", 0.0)),
                            top_k=msg.get("top_k"),
                            top_p=msg.get("top_p"),
                            eos_id=msg.get("eos_id"),
                            pad_id=msg.get("pad_id"),
                            seed=int(msg.get("seed", 0)),
                            deadline_s=msg.get("deadline_s"),
                            tenant=msg.get("tenant"),
                            priority=int(msg.get("priority", 0)),
                            block=False)
                    except QuotaExceeded as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "quota"}, pool=send_pool)
                        continue
                    except QueueFull:
                        networking.send_data(
                            conn, {"ok": False, "error": "queue full",
                                   "kind": "backpressure"},
                            pool=send_pool)
                        continue
                    except Draining as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "draining"}, pool=send_pool)
                        continue
                    except EngineDead as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "engine_dead"}, pool=send_pool)
                        continue
                    except ValueError as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "bad_request"}, pool=send_pool)
                        continue
                    with self._hlock:
                        self._handles[h.id] = h
                        self._owner[h.id] = conn
                    networking.send_data(conn, {"ok": True, "id": h.id},
                                         pool=send_pool)
                elif op == OP_KVBLOCKS:
                    # disaggregated hand-off: a prefill engine (via
                    # DisaggPair) ships a request's filled KV blocks.
                    # validate() runs BEFORE any engine call — a
                    # hostile/torn payload raises ProtocolError (a
                    # ValueError) out to the shed path below with the
                    # receiving pool untouched; decoded() copies the
                    # pooled recv views before they die on the next recv.
                    msg = networking.recv_data(conn, pool=recv_pool)
                    kvb = msg.get("blocks")
                    if not isinstance(kvb, networking.KVBlocks):
                        raise networking.ProtocolError(
                            "kv-block frame carries no KVBlocks payload")
                    kvb = kvb.validate().decoded()
                    try:
                        h = self.engine.submit_prefilled(
                            kvb,
                            np.array(msg["prompt"], np.int32, copy=True),
                            int(msg["first_token"]),
                            int(msg["num_steps"]),
                            temperature=float(msg.get("temperature", 0.0)),
                            top_k=msg.get("top_k"),
                            top_p=msg.get("top_p"),
                            eos_id=msg.get("eos_id"),
                            pad_id=msg.get("pad_id"),
                            deadline_s=msg.get("deadline_s"),
                            tenant=msg.get("tenant"),
                            priority=int(msg.get("priority", 0)),
                            block=False)
                    except QuotaExceeded as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "quota"}, pool=send_pool)
                        continue
                    except QueueFull:
                        networking.send_data(
                            conn, {"ok": False, "error": "queue full",
                                   "kind": "backpressure"},
                            pool=send_pool)
                        continue
                    except Draining as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "draining"}, pool=send_pool)
                        continue
                    except EngineDead as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "engine_dead"}, pool=send_pool)
                        continue
                    except ValueError as e:
                        networking.send_data(
                            conn, {"ok": False, "error": str(e),
                                   "kind": "bad_request"}, pool=send_pool)
                        continue
                    with self._hlock:
                        self._handles[h.id] = h
                        self._owner[h.id] = conn
                    networking.send_data(conn, {"ok": True, "id": h.id},
                                         pool=send_pool)
                elif op == OP_STREAM:
                    msg = networking.recv_data(conn, pool=recv_pool)
                    rid = int(msg["id"])
                    with self._hlock:
                        h = self._handles.get(rid)
                        if h is not None:
                            self._owner[rid] = conn  # stream claims it
                    if h is None:
                        networking.send_data(
                            conn, {"ok": False, "done": True,
                                   "kind": "unknown_id",
                                   "error": f"unknown id {rid}"},
                            pool=send_pool)
                        continue
                    alive, pending_op = self._stream(conn, h, recv_pool,
                                                     send_pool)
                    if not alive:
                        return  # client gone mid-stream (finally reclaims)
                elif op == OP_CANCEL:
                    msg = networking.recv_data(conn, pool=recv_pool)
                    with self._hlock:
                        h = self._handles.get(int(msg["id"]))
                    ok = h is not None and self.engine.cancel(h)
                    networking.send_data(
                        conn, {"ok": True, "cancelled": bool(ok)},
                        pool=send_pool)
                elif op == OP_STATS:
                    # load probe (no request body): the engine's lock-free
                    # snapshot, the signal a ServingRouter dispatches on
                    networking.send_data(
                        conn, {"ok": True, "load": self.engine.load()},
                        pool=send_pool)
                else:
                    return  # protocol violation: drop the connection
        except ValueError:
            self.protocol_errors += 1  # corrupt frame: shed silently
            return
        except (ConnectionError, OSError):
            self.disconnects += 1  # incl. a half-frame EOF/RST mid-recv
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            self._release_owned(conn)

    def _release_owned(self, conn: socket.socket) -> None:
        """Disconnect reclamation: cancel this connection's unfinished
        requests and drop their handle entries — a dead client's KV slot is
        back in the pool within one scheduler iteration, and the handle
        table does not grow with abandoned ids."""
        with self._hlock:
            owned = [rid for rid, c in self._owner.items() if c is conn]
            handles = [self._handles.pop(rid, None) for rid in owned]
            for rid in owned:
                self._owner.pop(rid, None)
        if not self.cancel_on_disconnect:
            return
        for h in handles:
            if h is not None and self.engine.cancel(h):
                self.disconnect_cancels += 1

    def _stream(self, conn: socket.socket, h: RequestHandle,
                recv_pool: "networking.BufferPool",
                send_pool: "networking.BufferPool"
                ) -> Tuple[bool, bytes]:
        """Relay ``h``'s token chunks until its final frame.  Bounded
        waits: each empty ``poll_s`` slice checks the client socket for
        EOF/RST (→ cancel + reclaim) or a mid-stream ``'x'`` cancel
        opcode; a stream with no progress past the request deadline (+
        grace) or ``stream_timeout_s`` sends a typed ``"stall"`` error
        frame.  Returns ``(alive, pending_op)``: ``alive`` is False when
        the connection is gone; ``pending_op`` is an opcode the client
        pipelined while the stream was relaying, for ``_handle`` to
        process after the final frame."""
        grace = max(1.0, 4 * self.poll_s)
        waited = 0.0
        pending = b""
        while True:
            # check the client side EVERY iteration (not just idle slices):
            # a mid-stream cancel or disconnect must land even while chunks
            # are flowing back-to-back.  Once the client pipelines its next
            # opcode ('q'/'r'), STOP reading — the following bytes are that
            # request's frame, owned by _handle after this stream's final
            # frame (a disconnect is still caught by the send path below).
            if not pending:
                status = self._poll_client(conn, recv_pool)
                if status == "dead":
                    if self.cancel_on_disconnect:
                        self.engine.cancel(h)
                    return False, b""
                if isinstance(status, bytes):
                    pending = status
            chunk, done = h.next_chunk(timeout=self.poll_s)
            if not done and not len(chunk):
                waited += self.poll_s
                now = time.perf_counter()
                stalled = (now > h.deadline + grace
                           if h.deadline is not None
                           else waited >= self.stream_timeout_s)
                if stalled:
                    # the engine should have retired this request by now —
                    # it is wedged or dead; unblock the client with a typed
                    # error frame instead of holding the handler thread
                    with self._hlock:
                        self._handles.pop(h.id, None)
                        self._owner.pop(h.id, None)
                    try:
                        networking.send_data(
                            conn, {"id": h.id, "ok": False, "done": True,
                                   "tokens": np.zeros(0, np.int32),
                                   "finish": "error", "kind": "stall",
                                   "error": f"no progress on request "
                                            f"{h.id} (engine stalled)"},
                            pool=send_pool)
                    except (ConnectionError, OSError):
                        return False, b""
                    return True, pending
                continue
            waited = 0.0
            reply: Dict[str, Any] = {"id": h.id, "tokens": chunk,
                                     "done": done}
            if done:
                reply["finish"] = h.finish
                if h.error is not None:
                    reply["ok"] = False
                    reply["kind"] = "engine_dead"
                    reply["error"] = str(h.error)
                else:
                    reply["row"] = h.result()
            try:
                networking.send_data(conn, reply, pool=send_pool)
            except (ConnectionError, OSError):
                if self.cancel_on_disconnect:
                    self.engine.cancel(h)
                return False, b""
            if done:
                with self._hlock:
                    self._handles.pop(h.id, None)
                    self._owner.pop(h.id, None)
                return True, pending

    def _poll_client(self, conn: socket.socket,
                     recv_pool: "networking.BufferPool"
                     ) -> Union[str, bytes]:
        """Non-blocking client-socket check between stream chunks:
        ``"idle"`` (nothing to read — the normal case), ``"dead"``
        (EOF/RST/garbage — the disconnect-reclamation trigger), ``"ok"``
        after consuming a mid-stream ``'x'`` cancel (any id; unacked —
        the stream's final frame is the acknowledgement), or the opcode
        byte itself when the client pipelined its next ``'q'``/``'r'``
        request while this stream is still relaying (stashed by
        ``_stream``, processed after the final frame — pipelining is not
        a protocol violation)."""
        try:
            readable, _, _ = select.select([conn], [], [], 0)
            if not readable:
                return "idle"
            op = conn.recv(1)
            if op == OP_CANCEL:
                # the cancel payload may trail the opcode across packets:
                # bound the recv so a torn/stalled cancel frame cannot pin
                # the stream relay (timeout → OSError → "dead")
                conn.settimeout(1.0)
                try:
                    msg = networking.recv_data(conn, pool=recv_pool)
                finally:
                    conn.settimeout(None)
                with self._hlock:
                    target = self._handles.get(int(msg["id"]))
                if target is not None:
                    self.engine.cancel(target)
                return "ok"
            if op in (OP_ENQUEUE, OP_STREAM, OP_KVBLOCKS):
                return op  # pipelined next request, not a dead client
        except (ConnectionError, OSError, ValueError):
            return "dead"
        # EOF (b"") or mid-stream protocol violation: the client is gone
        return "dead"

    # -- the event core ------------------------------------------------------
    # One selector I/O thread ("dkt-serving-io") multiplexes every client
    # connection: accept, parse, dispatch, stream-relay, and flush all run
    # as EventLoop callbacks, so 64 concurrent wire streams cost 64
    # registered fds instead of 64 handler threads.  Token frames reach
    # the loop through RequestHandle.set_listener → call_soon (the
    # socketpair waker), and every method below runs ON the loop thread —
    # _econns and _ServingConn state need no lock.  Semantics (typed
    # rejections, mid-stream 'x', pipelining, stall bounds, disconnect
    # reclamation, counters) mirror the threaded handler above, clause
    # for clause.

    def _ev_accept(self, mask: int) -> None:
        while True:
            try:
                sock, _ = self._server.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if not self._running:
                try:
                    sock.close()
                except OSError:
                    pass
                return
            try:
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            conn = _ServingConn(sock)
            self._econns[sock] = conn
            with self._lock:
                self._conns.append(sock)
            self._loop.add(sock, lambda m, c=conn: self._ev_io(c, m))

    def _ev_io(self, conn: _ServingConn, mask: int) -> None:
        if conn.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._ev_flush(conn)
        if conn.closed or conn.paused:
            return
        if mask & selectors.EVENT_READ:
            self._ev_read(conn)

    def _ev_read(self, conn: _ServingConn) -> None:
        # drain ops already parsed first (a mid-batch backpressure pause
        # abandons the messages() walk; the resume path re-enters here
        # with no new bytes owed by the socket)
        if self._ev_drain_parsed(conn):
            return
        while not conn.closed and not conn.paused:
            # direct-fill continuation for a frame torn across recvs,
            # else land the bytes in the pooled scratch and decode
            # zero-copy views over it (the PS event core's read path)
            target = conn.parser.writable()
            fed_scratch = target is None
            if fed_scratch:
                target = memoryview(conn.recv_pool.get(_EV_RECV_CHUNK))
            try:
                n = conn.sock.recv_into(target)
            except (BlockingIOError, InterruptedError):
                return
            except (ConnectionError, OSError):
                self._ev_conn_lost(conn, fault=conn.parser.midframe)
                return
            if not n:
                # EOF: clean at a frame boundary (no counter — the
                # threaded recv_opcode contract), a torn frame otherwise
                self._ev_conn_lost(conn, fault=conn.parser.midframe)
                return
            if fed_scratch:
                conn.parser.feed(target[:n])
            else:
                conn.parser.advance(n)
            if self._ev_drain_parsed(conn):
                return  # dispatched >= 1 op: yield the loop (fairness);
                # the level-triggered selector re-arms for the rest

    def _ev_drain_parsed(self, conn: _ServingConn) -> bool:
        """Dispatch every op the parser has buffered.  Returns True when
        at least one op was dispatched or the connection died (the read
        loop yields), False when more bytes are needed."""
        got = False
        try:
            for op, msg in conn.parser.messages():
                got = True
                self._ev_dispatch(conn, op, msg)
                if conn.closed or conn.paused:
                    return True
        except ValueError:
            if conn.stream is not None:
                # mid-stream garbage/torn frame: the threaded core's
                # _poll_client "dead" verdict — cancel + shed, no counter
                self._ev_conn_lost(conn, fault=False)
            else:
                self.protocol_errors += 1  # corrupt frame: shed silently
                self._ev_close(conn)
            return True
        except Exception:
            logger.exception(
                "serving event dispatch failed; shedding the connection "
                "(threaded-core parity: its handler thread died with it)")
            self._ev_close(conn)
            return True
        return got

    def _ev_dispatch(self, conn: _ServingConn, op: Optional[bytes],
                     msg) -> None:
        if conn.stream is not None:
            # mid-stream: the threaded core's _poll_client contract
            if op == OP_CANCEL:
                with self._hlock:
                    target = self._handles.get(int(msg["id"]))
                if target is not None:
                    self.engine.cancel(target)
                return  # unacked: the stream's final frame acknowledges
            if op in (OP_ENQUEUE, OP_STREAM, OP_KVBLOCKS):
                # pipelined next request: deferred past the final frame,
                # deep-copied out of the recv scratch its views die with
                conn.deferred.append((op, _deepcopy_wire_msg(msg)))
                return
            self._ev_conn_lost(conn, fault=False)  # protocol violation
            return
        if msg is None:
            if op == OP_STATS:
                # load probe, answered inline on the loop (no request
                # body): the engine's lock-free snapshot, piggybacked on
                # whatever flush this wake already owes the connection
                self._ev_queue(conn, {"ok": True,
                                      "load": self.engine.load()})
            else:
                self._ev_close(conn)  # protocol violation: drop silently
            return
        if op in (OP_ENQUEUE, OP_KVBLOCKS):
            self._ev_submit(conn, op, msg)
        elif op == OP_STREAM:
            rid = int(msg["id"])
            with self._hlock:
                h = self._handles.get(rid)
                if h is not None:
                    self._owner[rid] = conn.sock  # stream claims it
            if h is None:
                self._ev_queue(conn, {"ok": False, "done": True,
                                      "kind": "unknown_id",
                                      "error": f"unknown id {rid}"})
                return
            self._ev_start_stream(conn, h)
        elif op == OP_CANCEL:
            with self._hlock:
                h = self._handles.get(int(msg["id"]))
            ok = h is not None and self.engine.cancel(h)
            self._ev_queue(conn, {"ok": True, "cancelled": bool(ok)})

    def _ev_submit(self, conn: _ServingConn, op: bytes, msg) -> None:
        """``'q'``/``'k'`` admission with the threaded core's exact typed
        rejection chain.  A ``ProtocolError`` (hostile KV payload)
        re-raises past the bad_request catch so the connection is shed
        and counted as a protocol error, with no engine call made."""
        try:
            if op == OP_KVBLOCKS:
                kvb = msg.get("blocks")
                if isinstance(kvb, _EvPoisoned):
                    raise networking.ProtocolError(kvb.error)
                if not isinstance(kvb, networking.KVBlocks):
                    raise networking.ProtocolError(
                        "kv-block frame carries no KVBlocks payload")
                kvb = kvb.validate().decoded()
                h = self.engine.submit_prefilled(
                    kvb, np.array(msg["prompt"], np.int32, copy=True),
                    int(msg["first_token"]), int(msg["num_steps"]),
                    temperature=float(msg.get("temperature", 0.0)),
                    top_k=msg.get("top_k"), top_p=msg.get("top_p"),
                    eos_id=msg.get("eos_id"), pad_id=msg.get("pad_id"),
                    deadline_s=msg.get("deadline_s"),
                    tenant=msg.get("tenant"),
                    priority=int(msg.get("priority", 0)), block=False)
            else:
                h = self.engine.submit(
                    np.array(msg["prompt"], np.int32, copy=True),
                    int(msg["num_steps"]),
                    temperature=float(msg.get("temperature", 0.0)),
                    top_k=msg.get("top_k"), top_p=msg.get("top_p"),
                    eos_id=msg.get("eos_id"), pad_id=msg.get("pad_id"),
                    seed=int(msg.get("seed", 0)),
                    deadline_s=msg.get("deadline_s"),
                    tenant=msg.get("tenant"),
                    priority=int(msg.get("priority", 0)), block=False)
        except QuotaExceeded as e:
            self._ev_queue(conn, {"ok": False, "error": str(e),
                                  "kind": "quota"})
            return
        except QueueFull:
            self._ev_queue(conn, {"ok": False, "error": "queue full",
                                  "kind": "backpressure"})
            return
        except Draining as e:
            self._ev_queue(conn, {"ok": False, "error": str(e),
                                  "kind": "draining"})
            return
        except EngineDead as e:
            self._ev_queue(conn, {"ok": False, "error": str(e),
                                  "kind": "engine_dead"})
            return
        except networking.ProtocolError:
            raise  # transport-boundary rejection: shed, don't reply
        except ValueError as e:
            self._ev_queue(conn, {"ok": False, "error": str(e),
                                  "kind": "bad_request"})
            return
        with self._hlock:
            self._handles[h.id] = h
            self._owner[h.id] = conn.sock
        self._ev_queue(conn, {"ok": True, "id": h.id})

    # -- event-core stream relay --------------------------------------------
    def _ev_start_stream(self, conn: _ServingConn,
                         h: RequestHandle) -> None:
        conn.stream = h
        conn.last_progress = time.perf_counter()
        loop = self._loop

        def poke(c=conn, hh=h):
            loop.call_soon(lambda: self._ev_pump(c, hh))

        h.set_listener(poke)  # fires once now if progress predates it
        self._ev_schedule_stall(conn, h)
        self._ev_pump(conn, h)

    def _ev_pump(self, conn: _ServingConn, h: RequestHandle) -> None:
        """Relay every token chunk ``h`` has ready onto ``conn``'s write
        queue — the event twin of ``_stream``'s relay body.  Invoked via
        the handle's listener on every engine push (duplicate wakes are
        cheap no-ops) and from the backpressure resume path."""
        if conn.closed or conn.stream is not h or conn.paused:
            return
        while True:
            chunk, done = h.next_chunk(timeout=0)
            if not done and not len(chunk):
                return
            conn.last_progress = time.perf_counter()
            reply: Dict[str, Any] = {"id": h.id, "tokens": chunk,
                                     "done": done}
            if done:
                reply["finish"] = h.finish
                if h.error is not None:
                    reply["ok"] = False
                    reply["kind"] = "engine_dead"
                    reply["error"] = str(h.error)
                else:
                    reply["row"] = h.result()
            self._ev_queue(conn, reply)
            if conn.closed:
                return  # the flush tore the connection down mid-relay
            if done:
                self._ev_end_stream(conn, h)
                return
            if conn.paused:
                return  # backpressure: the flush path resumes the pump

    def _ev_end_stream(self, conn: _ServingConn,
                       h: RequestHandle) -> None:
        with self._hlock:
            self._handles.pop(h.id, None)
            self._owner.pop(h.id, None)
        h.set_listener(None)
        conn.stream = None
        self._ev_drain_deferred(conn)

    def _ev_drain_deferred(self, conn: _ServingConn) -> None:
        """Dispatch ops the client pipelined during a stream (the
        threaded core's ``pending_op``, processed after the final
        frame).  A deferred ``'r'`` re-enters streaming; anything still
        queued behind it stays deferred, in order, for that stream's
        end."""
        while (conn.deferred and not conn.closed and not conn.paused
                and conn.stream is None):
            op, msg = conn.deferred.pop(0)
            try:
                self._ev_dispatch(conn, op, msg)
            except ValueError:
                if conn.stream is not None:
                    self._ev_conn_lost(conn, fault=False)
                else:
                    self.protocol_errors += 1
                    self._ev_close(conn)
                return
            except Exception:
                logger.exception("serving event dispatch failed; "
                                 "shedding the connection")
                self._ev_close(conn)
                return

    def _ev_schedule_stall(self, conn: _ServingConn,
                           h: RequestHandle) -> None:
        grace = max(1.0, 4 * self.poll_s)
        now = time.perf_counter()
        if h.deadline is not None:
            delay = h.deadline + grace - now
        else:
            delay = conn.last_progress + self.stream_timeout_s - now
        self._loop.call_later(max(self.poll_s, delay),
                              lambda: self._ev_check_stall(conn, h))

    def _ev_check_stall(self, conn: _ServingConn,
                        h: RequestHandle) -> None:
        """Stall watchdog: a stream with no progress past the request
        deadline (+ grace) or ``stream_timeout_s`` gets the typed
        ``"stall"`` error frame instead of pinning the relay — the
        threaded core's bounded-wait contract, on a timer instead of a
        poll loop.  Stale timers (stream already retired) no-op."""
        if conn.closed or conn.stream is not h:
            return
        grace = max(1.0, 4 * self.poll_s)
        now = time.perf_counter()
        if h.deadline is not None:
            # one empty poll slice of silence required, like the threaded
            # loop which only diagnoses a stall from an empty slice
            stalled = (now > h.deadline + grace
                       and now - conn.last_progress >= self.poll_s)
        else:
            stalled = now - conn.last_progress >= self.stream_timeout_s
        if not stalled:
            self._ev_schedule_stall(conn, h)
            return
        with self._hlock:
            self._handles.pop(h.id, None)
            self._owner.pop(h.id, None)
        self._ev_queue(conn, {"id": h.id, "ok": False, "done": True,
                              "tokens": np.zeros(0, np.int32),
                              "finish": "error", "kind": "stall",
                              "error": f"no progress on request {h.id} "
                                       f"(engine stalled)"})
        if conn.closed:
            return
        h.set_listener(None)
        conn.stream = None
        self._ev_drain_deferred(conn)

    # -- event-core write path ----------------------------------------------
    def _ev_queue(self, conn: _ServingConn, obj) -> None:
        if conn.closed:
            return
        if conn.out:
            # the pooled buffer still backs an in-flight frame: encode
            # into fresh bytes (the PS _queue_reply discipline)
            data = memoryview(networking.encode_message(obj))
        else:
            data = memoryview(networking.encode_message_into(
                obj, conn.send_pool))
        conn.out.append(data)
        conn.out_bytes += len(data)
        self._ev_flush(conn)

    def _ev_flush(self, conn: _ServingConn) -> None:
        if conn.closed:
            return
        was_paused = conn.paused
        while conn.out:
            try:
                if len(conn.out) > 1:
                    # write batching: every frame owed to this connection
                    # in ONE syscall — token chunks queued by successive
                    # pumps coalesce per loop wake
                    sent = conn.sock.sendmsg(conn.out[:_EV_SENDMSG_BATCH])
                else:
                    sent = conn.sock.send(conn.out[0])
            except (BlockingIOError, InterruptedError):
                break
            except (ConnectionError, OSError):
                self._ev_conn_lost(conn, fault=True)
                return
            conn.out_bytes -= sent
            while conn.out and sent >= len(conn.out[0]):
                sent -= len(conn.out[0])
                conn.out.pop(0)
            if sent:
                conn.out[0] = conn.out[0][sent:]
                break  # partial write: the kernel buffer is full
        self._ev_update_mask(conn)
        if was_paused and not conn.paused and not conn.closed:
            self._loop.call_soon(lambda: self._ev_resume(conn))

    def _ev_update_mask(self, conn: _ServingConn) -> None:
        if conn.closed:
            return
        if conn.paused:
            if conn.out_bytes <= self.max_conn_buffer // 2:
                conn.paused = False  # drained: resume reads + pump
        elif conn.out_bytes > self.max_conn_buffer:
            conn.paused = True  # never-reading client: stop reading too
        want = bool(conn.out)
        conn.want_write = want
        mask = ((0 if conn.paused else selectors.EVENT_READ)
                | (selectors.EVENT_WRITE if want else 0))
        if not mask:  # unreachable (paused implies pending writes), but
            mask = selectors.EVENT_READ  # a 0 mask would be an error
        self._loop.set_mask(conn.sock, mask)

    def _ev_resume(self, conn: _ServingConn) -> None:
        """Backpressure release: re-pump the stream (tokens queued while
        paused sit in the handle — bounded by its ``num_steps``), then
        re-drain parsed/deferred ops before going back to the socket."""
        if conn.closed or conn.paused:
            return
        if conn.stream is not None:
            self._ev_pump(conn, conn.stream)
        if conn.closed or conn.paused:
            return
        if conn.stream is None:
            self._ev_drain_deferred(conn)
        if not conn.closed and not conn.paused:
            self._ev_read(conn)

    # -- event-core teardown -------------------------------------------------
    def _ev_conn_lost(self, conn: _ServingConn, fault: bool) -> None:
        """Transport-level death.  Counting mirrors the threaded core:
        mid-stream death is ``_poll_client``'s "dead" verdict (cancel the
        streamed request, no counter); outside a stream a torn frame or
        send fault counts ``disconnects``; a clean EOF counts nothing."""
        if conn.closed:
            return
        h = conn.stream
        if h is not None:
            if self.cancel_on_disconnect:
                self.engine.cancel(h)
        elif fault:
            self.disconnects += 1
        self._ev_close(conn)

    def _ev_close(self, conn: _ServingConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        h = conn.stream
        conn.stream = None
        if h is not None:
            h.set_listener(None)
        if self._loop is not None:
            self._loop.remove(conn.sock)
        self._econns.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass
        with self._lock:
            if conn.sock in self._conns:
                self._conns.remove(conn.sock)
        del conn.out[:]
        conn.out_bytes = 0
        del conn.deferred[:]
        self._release_owned(conn.sock)

    def _ev_shutdown(self) -> None:
        """Loop-exit hook (runs ON the loop thread, before the selector
        and waker close): flush pending writes bounded-best-effort, close
        every registered connection, reclaim their owned requests, close
        the listener.  ``stop(join_timeout)`` drains through here — zero
        leaked fds (tests/test_torch_serving_event.py)."""
        conns = list(self._econns.values())
        self._econns.clear()
        with self._lock:
            self._conns.clear()
        for conn in conns:
            if conn.out:
                try:
                    conn.sock.setblocking(True)
                    conn.sock.settimeout(0.5)
                    for buf in conn.out:
                        conn.sock.sendall(buf)
                except (ConnectionError, OSError, socket.timeout):
                    pass
            h = conn.stream
            conn.stream = None
            if h is not None:
                h.set_listener(None)
            conn.closed = True
            try:
                conn.sock.close()
            except OSError:
                pass
            self._release_owned(conn.sock)
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass


def _raise_typed(kind: Optional[str], err: str):
    """Map a typed error reply back to the exception the engine raised."""
    if kind == "quota":  # before backpressure: QuotaExceeded IS a QueueFull
        raise QuotaExceeded(err)
    if kind == "backpressure" or "queue full" in err:
        raise QueueFull(err)
    if kind == "draining":
        raise Draining(err)
    if kind in ("engine_dead", "stall"):
        raise EngineDead(err)
    raise ValueError(err)


class ServingClient:
    """Minimal client for :class:`ServingServer` — one socket, the shared
    frame codec, pooled receives.  ``generate`` is the one-call form whose
    returned row matches offline ``generate`` for the same request; with a
    ``retry_policy`` (``resilience.RetryPolicy``) it re-dials and
    resubmits across engine deaths and connection resets — requests are
    deterministic in their seed, so the retry is idempotent."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self.sock = networking.connect(self.host, self.port)
        self._pool = networking.BufferPool()
        self._send_pool = networking.BufferPool()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _redial(self) -> None:
        self.close()
        self.sock = networking.connect(self.host, self.port)

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, prompt, num_steps: int, **kw) -> int:
        """Enqueue a request; returns the server-assigned id.  Raises the
        typed rejection: :class:`QueueFull` (backpressure),
        :class:`Draining`, :class:`EngineDead`, or ``ValueError``."""
        req = {"prompt": np.asarray(prompt, np.int32),
               "num_steps": int(num_steps), **kw}
        networking.send_opcode(self.sock, OP_ENQUEUE)
        networking.send_data(self.sock, req, pool=self._send_pool)
        ack = networking.recv_data(self.sock, pool=self._pool)
        if not ack.get("ok"):
            _raise_typed(ack.get("kind"), str(ack.get("error", "rejected")))
        return int(ack["id"])

    def submit_prefilled(self, blocks, prompt, first_token: int,
                         num_steps: int, **kw) -> int:
        """Ship a prefilled request's KV blocks to a decode-role server
        (``SERVING_OP_KVBLOCKS``) — the wire half of the disaggregated
        hand-off.  ``blocks`` is a :class:`networking.KVBlocks`; the block
        payloads ride the frame codec's zero-copy buffer path.  Returns
        the server-assigned id; raises the same typed rejections as
        :meth:`submit`."""
        req = {"blocks": blocks,
               "prompt": np.asarray(prompt, np.int32),
               "first_token": int(first_token),
               "num_steps": int(num_steps), **kw}
        networking.send_opcode(self.sock, OP_KVBLOCKS)
        networking.send_data(self.sock, req, pool=self._send_pool)
        ack = networking.recv_data(self.sock, pool=self._pool)
        if not ack.get("ok"):
            _raise_typed(ack.get("kind"), str(ack.get("error", "rejected")))
        return int(ack["id"])

    def cancel(self, rid: int, await_ack: bool = True) -> bool:
        """Cancel request ``rid``.  With ``await_ack=False`` the cancel is
        fire-and-forget — the form to use from another thread while THIS
        socket is mid-stream (the ack would interleave with chunk frames;
        the stream's final ``finish="cancel"`` frame is the
        acknowledgement there)."""
        networking.send_opcode(self.sock, OP_CANCEL)
        networking.send_data(self.sock, {"id": int(rid)},
                             pool=self._send_pool)
        if not await_ack:
            return True
        ack = networking.recv_data(self.sock, pool=self._pool)
        return bool(ack.get("cancelled"))

    def load(self) -> Dict[str, Any]:
        """Probe the server's engine load (``SERVING_OP_STATS``): the
        lock-free :meth:`ServingEngine.load` snapshot — queue depth, free
        slots, trie-cached block count, draining/dead flags.  Cheap enough
        for a router to poll per dispatch."""
        networking.send_opcode(self.sock, OP_STATS)
        reply = networking.recv_data(self.sock, pool=self._pool)
        if not reply.get("ok"):
            _raise_typed(reply.get("kind"),
                         str(reply.get("error", "stats probe rejected")))
        return dict(reply["load"])

    def stream(self, rid: int):
        """Yield ``(tokens, done_reply)`` chunk by chunk; ``done_reply`` is
        None until the final frame (which carries ``finish`` —
        eos/length/deadline/cancel — and the padded ``row``).  Typed error
        frames raise: :class:`EngineDead` for ``engine_dead``/``stall``,
        ``ValueError`` otherwise."""
        networking.send_opcode(self.sock, OP_STREAM)
        networking.send_data(self.sock, {"id": int(rid)},
                             pool=self._send_pool)
        while True:
            reply = networking.recv_data(self.sock, pool=self._pool)
            if reply.get("error"):
                _raise_typed(reply.get("kind"), str(reply["error"]))
            tokens = np.array(reply["tokens"], np.int32, copy=True)
            if reply["done"]:
                yield tokens, {"finish": reply["finish"],
                               "row": np.array(reply["row"], np.int32,
                                               copy=True)}
                return
            yield tokens, None

    def generate(self, prompt, num_steps: int, retry_policy=None,
                 **kw) -> np.ndarray:
        """Submit + stream to completion; returns the full padded row
        (prompt + tokens), exactly ``generate``-shaped.  ``retry_policy``
        (a ``resilience.RetryPolicy``) retries the whole submit+stream on
        :class:`EngineDead` or a transport fault, re-dialing first — the
        client-side half of the supervised-restart story."""
        def attempt() -> np.ndarray:
            rid = self.submit(prompt, num_steps, **kw)
            for _, done in self.stream(rid):
                if done is not None:
                    return done["row"]
            raise ConnectionError("stream ended without a done frame")

        if retry_policy is None:
            return attempt()
        return retry_policy.call_reconnecting(
            attempt, self._redial,
            retry_on=(EngineDead, ConnectionError, OSError))


# ---------------------------------------------------------------------------
# disaggregated prefill/decode
# ---------------------------------------------------------------------------

class _DisaggRequest:
    """One in-flight request's routing record inside a :class:`DisaggPair`:
    the client-facing proxy handle, the current upstream handle it mirrors
    (prefill first, decode after the hand-off), and a cancel relay that
    always points at whichever engine owns the upstream right now."""

    __slots__ = ("proxy", "upstream", "cancel_fn", "cancelled", "thread",
                 "kw", "attempts")

    def __init__(self, proxy: RequestHandle, kw: Optional[Dict[str, Any]]
                 = None):
        self.proxy = proxy
        self.upstream: Optional[RequestHandle] = None
        self.cancel_fn = None
        self.cancelled = False
        self.thread: Optional[threading.Thread] = None
        self.kw: Dict[str, Any] = dict(kw or {})
        self.attempts = 1  # prefill admissions so far (re-route budget)


class DisaggPair:
    """Disaggregated serving: N ``role="prefill"`` engines feeding ONE
    ``role="decode"`` engine, behind the unified engine's client surface
    (``submit`` → :class:`RequestHandle` → ``next_chunk``/``result``).

    Admissions route to a prefill engine (round-robin); when its half
    retires (``finish="prefilled"``), the request's filled KV blocks ship
    to the decode engine — in-process via ``submit_prefilled`` when
    ``decode`` is an engine, or over the serving wire
    (``SERVING_OP_KVBLOCKS`` through :class:`ServingClient`) when
    ``decode_addr`` names a remote decode-role :class:`ServingServer`.
    The client-visible stream is unchanged: tokens relay into the proxy
    handle as the decode engine emits them, and greedy output is
    token-identical to a unified engine (the decode engine resumes from
    bit-exact shipped KV at the shipped position with the same RNG key).

    Failure matrix (docs/serving.md):

     - **prefill death** mid-prefill or mid-transfer re-routes: the
       request resubmits to the next live prefill engine with its
       ORIGINAL rng key (deterministic, so the retry is idempotent),
       bounded by one attempt per engine; blocks the dead engine held are
       reclaimed by its own death path, and the decode pool never saw the
       torn transfer (``kv_blocks_in_use == 0`` on both sides).
     - **decode death** is terminal: the proxy fails with the typed
       :class:`EngineDead` (no silent re-route — the decode engine owns
       all live KV state, exactly the supervised-restart seam
       the pair supervisor of ROADMAP queue A item 4 covers).
     - **cancel/deadline** land on whichever engine currently owns the
       request; the proxy mirrors the upstream finish reason.
    """

    def __init__(self, prefills, decode: Optional[ServingEngine] = None,
                 decode_addr: Optional[Tuple[str, int]] = None,
                 poll_s: float = 0.02):
        if isinstance(prefills, ServingEngine):
            prefills = [prefills]
        if not prefills:
            raise ValueError("DisaggPair needs at least one prefill engine")
        for e in prefills:
            if e.role != "prefill":
                raise ValueError(f"prefill engines must be role='prefill', "
                                 f"got role={e.role!r}")
        if (decode is None) == (decode_addr is None):
            raise ValueError("pass exactly one of decode= (in-process "
                             "engine) or decode_addr= (remote server)")
        if decode is not None and decode.role != "decode":
            raise ValueError(f"decode engine must be role='decode', got "
                             f"role={decode.role!r}")
        self._prefills: List[ServingEngine] = list(prefills)
        self._decode = decode
        self._decode_addr = decode_addr
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        self._live: Dict[int, _DisaggRequest] = {}
        self._next_id = 0
        self._rr = 0  # round-robin cursor over prefill engines
        #: shared event relay: ONE loop watches every in-flight
        #: request across both halves — prefill completion, the KV
        #: hand-off, and the decode token relay — instead of a routing
        #: thread per request.  Lazily started on first submit.
        self._relay_loop: Optional[networking.EventLoop] = None
        # the pair's OWN terminal accounting: engine counters double-count
        # a re-routed request (every attempt is a submission somewhere), so
        # client-facing totals live here
        self.counters: Dict[str, int] = {
            "requests_submitted": 0, "requests_completed": 0,
            "requests_failed": 0, "requests_rejected": 0,
            "requests_cancelled": 0, "requests_expired": 0,
            "prefill_reroutes": 0,
        }

    # ------------------------------------------------------------ lifecycle
    def warmup(self) -> "DisaggPair":
        """Compile every engine's role-specific programs (prefill buckets
        + gather on the prefill side, decode step + ingest on the decode
        side) before traffic — the pair-level twin of
        ``ServingEngine.warmup``."""
        for e in self.engines:
            e.warmup()
        return self

    def start(self) -> "DisaggPair":
        for e in self.engines:  # prefill engines first, then decode
            e.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        for e in self.engines:
            e.stop(join_timeout=join_timeout)
        self._ev_wait_idle(join_timeout)
        with self._lock:
            loop, self._relay_loop = self._relay_loop, None
        if loop is not None:
            loop.stop(join_timeout=join_timeout)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain, prefill side first (no new hand-offs) then the
        decode engine; the event relay pumps the final laps out so every
        proxy reaches a terminal state before this returns."""
        with self._lock:
            pres, dec = list(self._prefills), self._decode
        clean = all([e.drain(timeout=timeout) for e in pres])
        if dec is not None:
            clean = dec.drain(timeout=timeout) and clean
        self._ev_wait_idle(5.0)
        return clean

    def __enter__(self) -> "DisaggPair":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ admission
    def submit(self, prompt, num_steps: int, **kw) -> RequestHandle:
        """Unified-engine ``submit`` surface.  Returns a proxy handle whose
        stream spans both halves: TTFT is the prefill engine's first
        token, every later token is the decode engine's."""
        prompt = np.asarray(prompt, np.int32)
        ph, eng = self._submit_prefill(prompt, num_steps, kw, first=True)
        if num_steps == 0:
            # the prefill engine completed it in place ("empty"): nothing
            # to hand off, and the engine's own counters saw it — mirror
            # into the pair's
            with self._lock:
                self.counters["requests_submitted"] += 1
                self.counters["requests_completed"] += 1
            return ph
        with self._lock:
            self._next_id += 1
            proxy = RequestHandle(
                self._next_id, prompt, num_steps,
                float(kw.get("temperature", 0.0)), kw.get("top_k"),
                kw.get("top_p"), kw.get("eos_id"), kw.get("pad_id"),
                ph.key, deadline_s=kw.get("deadline_s"))
            rec = _DisaggRequest(proxy, kw)
            rec.upstream = ph
            rec.cancel_fn = (lambda e=eng, h=ph: e.cancel(h))
            self._live[proxy.id] = rec
            self.counters["requests_submitted"] += 1
        self._ev_watch_prefill(rec, ph)
        return proxy

    def _submit_prefill(self, prompt, num_steps, kw, first: bool,
                        rng=None):
        """Round-robin submit over LIVE prefill engines; on the first
        admission typed backpressure propagates to the caller after every
        engine refused, on a re-route the caller handles it."""
        last: Optional[BaseException] = None
        with self._lock:
            attempts_budget = len(self._prefills)
        for _ in range(attempts_budget):
            with self._lock:
                eng = self._prefills[self._rr % len(self._prefills)]
                self._rr += 1
            try:
                sub = dict(kw)
                # pair admission is non-blocking by construction: a full
                # prefill queue tries the next engine instead of parking
                sub.pop("block", None)
                sub.pop("timeout", None)
                if rng is not None:
                    sub.pop("seed", None)
                    sub["rng"] = rng
                return eng.submit(prompt, num_steps, block=False,
                                  **sub), eng
            except (EngineDead, QueueFull, Draining) as e:
                last = e
        if first:
            with self._lock:
                self.counters["requests_rejected"] += 1
        raise last if last is not None else EngineDead(
            "no live prefill engine")

    # -------------------------------------------------------------- routing
    #
    # The whole request lifecycle rides the pair's shared event loop:
    # the prefill handle's listener wakes the loop when its half
    # retires, the KV hand-off runs as a loop callback (non-blocking
    # decode admission, with a ``call_later`` retry while the decode
    # queue is full), and the decode half relays listener-driven — no
    # per-request routing thread anywhere on the path.

    def _ev_loop(self) -> "networking.EventLoop":
        with self._lock:
            loop = self._relay_loop
            if loop is None or not loop.alive:
                loop = networking.EventLoop(name="dkt-disagg-relay")
                loop.start()
                self._relay_loop = loop
            return loop

    def _ev_watch_prefill(self, rec: _DisaggRequest,
                          ph: RequestHandle) -> None:
        loop = self._ev_loop()
        ph.set_listener(lambda: loop.call_soon(
            lambda: self._ev_prefill_done(rec, ph)))
        loop.call_soon(lambda: self._ev_prefill_done(rec, ph))

    def _ev_prefill_done(self, rec: _DisaggRequest,
                         ph: RequestHandle) -> None:
        """Loop-side prefill watcher: when the prefill half retires, hand
        off (``finish="prefilled"``), re-route a death with the ORIGINAL
        key (bit-identical retry, bounded by one attempt per engine), or
        mirror a cancel/deadline/drain finish."""
        proxy = rec.proxy
        if rec.upstream is not ph or not ph.done:
            return  # stale wake, or woken by a token push mid-prefill
        ph.set_listener(None)
        rec.upstream = None  # claim the transition exactly once
        if ph.finish == "prefilled":
            kvb = ph.kvblocks
            first_token = int(ph.tokens[0])
            with self._lock:
                dec = self._decode  # in-flight hand-offs keep their engine
            if dec is not None:
                self._ev_handoff_local(rec, kvb, first_token, dec)
            else:
                self._ev_handoff_wire(rec, kvb, first_token)
            return
        if ph.error is not None:
            # prefill engine died with the request in flight: re-route
            # with the ORIGINAL key so the retry is bit-identical
            with self._lock:
                budget = len(self._prefills) + 1
            if rec.attempts >= budget:
                self._retire(rec, error=EngineDead(
                    f"request {proxy.id}: every prefill re-route "
                    f"failed ({ph.error})"))
                return
            with self._lock:
                self.counters["prefill_reroutes"] += 1
                cancelled = rec.cancelled
            if cancelled:
                self._retire(rec, finish="cancel")
                return
            try:
                nph, eng = self._submit_prefill(
                    proxy.prompt, proxy.num_steps, rec.kw, first=False,
                    rng=proxy.key)
            except (EngineDead, QueueFull, Draining) as e:
                self._retire(rec, error=e)
                return
            with self._lock:
                rec.upstream = nph
                rec.cancel_fn = (lambda e=eng, h=nph: e.cancel(h))
                if rec.cancelled:
                    rec.cancel_fn()
            rec.attempts += 1
            self._ev_watch_prefill(rec, nph)
            return
        # cancel / deadline / drain on the prefill half: mirror it
        self._retire(rec, finish=ph.finish)

    def _ev_handoff_local(self, rec: _DisaggRequest, kvb,
                          first_token: int, dec: ServingEngine) -> None:
        """In-process hand-off on the loop: non-blocking decode admission,
        re-armed via ``call_later`` while the decode queue is full (the
        event-core analogue of the old thread's ``block=True`` park)."""
        proxy = rec.proxy
        if rec.cancelled:
            self._retire(rec, finish="cancel")
            return
        try:
            dh = dec.submit_prefilled(
                kvb, proxy.prompt, first_token, proxy.num_steps,
                temperature=proxy.temperature, top_k=proxy.top_k,
                top_p=proxy.top_p, eos_id=proxy.eos_id,
                pad_id=proxy.pad_id, deadline_s=rec.kw.get("deadline_s"),
                block=False)
        except QueueFull:
            self._relay_loop.call_later(
                self.poll_s, lambda: self._ev_handoff_local(
                    rec, kvb, first_token, dec))
            return
        except (EngineDead, Draining) as e:
            # decode death is terminal (typed), never silently re-routed:
            # the decode engine owns all live KV state
            self._retire(rec, error=e)
            return
        except ValueError as e:
            self._retire(rec, error=e)
            return
        with self._lock:
            rec.upstream = dh
            rec.cancel_fn = (lambda e=dec, h=dh: e.cancel(h))
            if rec.cancelled:
                rec.cancel_fn()
        loop = self._relay_loop
        dh.set_listener(lambda: loop.call_soon(
            lambda: self._ev_pump_decode(rec, dh)))
        self._ev_pump_decode(rec, dh)

    def _ev_pump_decode(self, rec: _DisaggRequest,
                        dh: RequestHandle) -> None:
        """Loop-side decode relay: drain ready chunks into the proxy."""
        if rec.upstream is not dh:
            return  # stale wake
        proxy = rec.proxy
        while True:
            chunk, done = dh.next_chunk(timeout=0)
            for t in chunk:
                proxy._push(int(t))
            if done:
                dh.set_listener(None)
                rec.upstream = None
                if dh.error is not None:
                    self._retire(rec, error=dh.error)
                else:
                    self._retire(rec, finish=dh.finish)
                return
            if not len(chunk):
                return  # drained; the listener wakes us on more

    def _ev_handoff_wire(self, rec: _DisaggRequest, kvb,
                         first_token: int) -> None:
        """Wire hand-off on the loop: ship the block set to the remote
        decode server (``SERVING_OP_KVBLOCKS``), then relay its reply
        stream non-blocking off a bare-frame parser."""
        proxy = rec.proxy
        client = ServingClient(*self._decode_addr)
        try:
            rid = client.submit_prefilled(
                kvb, proxy.prompt, first_token, proxy.num_steps,
                temperature=proxy.temperature, top_k=proxy.top_k,
                top_p=proxy.top_p, eos_id=proxy.eos_id,
                pad_id=proxy.pad_id, deadline_s=rec.kw.get("deadline_s"))
            networking.send_opcode(client.sock, OP_STREAM)
            networking.send_data(client.sock, {"id": int(rid)},
                                 pool=client._send_pool)
            client.sock.setblocking(False)
        except (EngineDead, ConnectionError, OSError) as e:
            client.close()
            self._retire(rec, error=e if isinstance(e, EngineDead)
                         else EngineDead(f"decode engine unreachable: "
                                         f"{e!r}"))
            return
        except ValueError as e:
            client.close()
            self._retire(rec, error=e)
            return
        with self._lock:
            rec.cancel_fn = (lambda c=client, r=rid:
                             c.cancel(r, await_ack=False))
            if rec.cancelled:
                try:
                    rec.cancel_fn()
                except (ConnectionError, OSError):
                    pass
        parser = networking.FrameParser(frame_ops=None)
        scratch = networking.BufferPool()
        loop = self._relay_loop
        if loop is None:
            client.close()
            return
        loop.add(client.sock,
                 lambda mask: self._ev_wire_read(rec, client, parser,
                                                 scratch))

    def _ev_wire_read(self, rec: _DisaggRequest, client, parser,
                      scratch) -> None:
        sock = client.sock
        while True:
            target = parser.writable()
            fed_scratch = target is None
            if fed_scratch:
                target = memoryview(scratch.get(_EV_RECV_CHUNK))
            try:
                n = sock.recv_into(target)
            except (BlockingIOError, InterruptedError):
                return
            except (ConnectionError, OSError) as e:
                self._ev_wire_lost(rec, client, e)
                return
            if not n:
                self._ev_wire_lost(rec, client,
                                   ConnectionError("stream ended without "
                                                   "a done frame"))
                return
            if fed_scratch:
                parser.feed(target[:n])
            else:
                parser.advance(n)
            try:
                for _op, msg in parser.messages():
                    if self._ev_wire_frame(rec, client, msg):
                        return  # stream finished / typed failure
            except ValueError as e:
                self._ev_wire_lost(rec, client, e)
                return

    def _ev_wire_frame(self, rec: _DisaggRequest, client, msg) -> bool:
        """One decode-server reply frame.  Returns True when the stream
        detached (done or failed) — decode death is terminal, typed."""
        if msg.get("error"):
            kind = msg.get("kind")
            err = str(msg["error"])
            self._ev_wire_detach(rec, client)
            if kind in ("engine_dead", "stall"):
                self._retire(rec, error=EngineDead(err))
            else:
                self._retire(rec, error=ValueError(err))
            return True
        for t in msg["tokens"]:
            rec.proxy._push(int(t))
        if msg["done"]:
            self._ev_wire_detach(rec, client)
            self._retire(rec, finish=msg["finish"])
            return True
        return False

    def _ev_wire_detach(self, rec: _DisaggRequest, client) -> None:
        loop = self._relay_loop
        if loop is not None:
            loop.remove(client.sock)
        client.close()

    def _ev_wire_lost(self, rec: _DisaggRequest, client,
                      err: BaseException) -> None:
        self._ev_wire_detach(rec, client)
        self._retire(rec, error=err if isinstance(err, EngineDead)
                     else EngineDead(f"decode engine unreachable: "
                                     f"{err!r}"))

    def _ev_wait_idle(self, timeout: float) -> None:
        """Bounded wait for the loop to retire the in-flight requests —
        stopping/draining the engines makes their handles terminal, and
        the loop pumps those final laps out asynchronously."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                busy = bool(self._live)
            if not busy or time.monotonic() >= deadline:
                return
            time.sleep(0.005)

    def _retire(self, rec: _DisaggRequest, finish: Optional[str] = None,
                error: Optional[BaseException] = None) -> None:
        """Make the proxy terminal exactly once and book the pair-level
        counter for its reason."""
        proxy = rec.proxy
        if error is not None:
            exc = (error if isinstance(error, EngineDead)
                   else EngineDead(str(error)))
            counted = proxy._fail(exc)
            key = "requests_failed"
        else:
            counted = proxy._finish(finish)
            key = {"cancel": "requests_cancelled",
                   "deadline": "requests_expired"}.get(
                       finish, "requests_completed")
        with self._lock:
            if counted:
                self.counters[key] += 1
            self._live.pop(proxy.id, None)

    # ------------------------------------------------------------- controls
    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a proxy handle wherever its request currently lives
        (queued/prefilling, mid-transfer, or decoding).  Returns False if
        it already finished."""
        with handle._cond:
            if handle.finish is not None:
                return False
        with self._lock:
            rec = self._live.get(handle.id)
            if rec is None or rec.proxy is not handle:
                return False
            rec.cancelled = True
            fn = rec.cancel_fn
        if fn is not None:
            try:
                fn()
            except (ConnectionError, OSError):
                pass  # upstream gone: its death path retires the proxy
        return True

    def replace_engine(self, old: ServingEngine,
                       new: ServingEngine) -> None:
        """Swap a respawned engine into the pair (the pair supervisor's
        restart seam, ROADMAP queue A item 4).  In-flight requests on the
        old engine fail through its death path and re-route."""
        with self._lock:
            for i, e in enumerate(self._prefills):
                if e is old:
                    self._prefills[i] = new
                    return
            if self._decode is old:
                self._decode = new
                return
        raise ValueError("engine to replace is not part of this pair")

    # ------------------------------------------------------------ telemetry
    @property
    def engines(self) -> List[ServingEngine]:
        with self._lock:
            return self._prefills + ([self._decode]
                                     if self._decode is not None else [])

    @property
    def stats(self) -> Dict[str, Any]:
        """Merged engine stats (numeric counters summed, sample lists
        concatenated) with the request-level terminal counters OVERRIDDEN
        by the pair's own: a re-routed request is one client request, not
        one per attempt."""
        merged: Dict[str, Any] = {}
        for e in self.engines:
            for k, v in e.stats.items():
                if isinstance(v, bool) or not isinstance(
                        v, (int, float, list)):
                    merged.setdefault(k, v)
                elif isinstance(v, list):
                    merged.setdefault(k, [])
                    merged[k] = merged[k] + list(v)
                else:
                    merged[k] = merged.get(k, 0) + v
        with self._lock:
            merged.update(self.counters)
        return merged

    @property
    def kv_blocks_in_use(self) -> Optional[int]:
        """Sum across BOTH sides — the zero-leak assertion surface."""
        vals = [e.kv_blocks_in_use for e in self.engines]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    @property
    def slot_occupancy(self) -> Optional[float]:
        """The DECODE engine's occupancy (None for wire-mode pairs): the
        continuous-batching health metric disaggregation exists to
        protect."""
        with self._lock:
            dec = self._decode
        return dec.slot_occupancy if dec is not None else None

    @property
    def max_len(self) -> int:
        return min(e.max_len for e in self.engines)

    @property
    def queue_depth(self) -> int:
        return sum(e.queue_depth for e in self.engines)

    @property
    def dead(self) -> Optional[BaseException]:
        """The first dead engine's error, or None while every engine in
        the pair is live."""
        for e in self.engines:
            if e.dead is not None:
                return e.dead
        return None
