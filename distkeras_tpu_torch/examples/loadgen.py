"""Load generator for the port's continuous-batching serving engine.

The port of ``examples/loadgen.py``: drives a
:class:`distkeras_tpu_torch.serving.ServingEngine` (or a ``DisaggPair``,
or a ``ServingRouter`` fleet) with a FIXED, seeded request trace
(deterministic prompt contents, lengths, and continuation lengths) in two
modes:

 - **closed loop** (``run_closed_loop``): N concurrent "users", each
   submitting its next request the moment the previous one completes —
   the canonical serving-bench harness (offered load == capacity at the
   given concurrency).
 - **open loop / offered QPS** (``run_open_loop``): requests arrive on a
   fixed schedule at a target rate regardless of completion, so latency
   degradation under overload (and queue backpressure shedding) is
   visible.  ``main`` sweeps a list of offered-QPS points and prints one
   JSON line per point.

``sequential_baseline`` runs the SAME trace through offline per-request
``generate`` — one request at a time, no batching — the comparison that
continuous batching is measured against.

The trace (:func:`make_trace`) and the tenant policies
(:func:`qos_policies`) are the JAX module's, draw for draw: the same
arguments give the same requests in both packages.  The ``build_*``
functions take ``device=`` (``None`` is the CUDA card) and draw the
random weights from a ``torch.Generator`` seeded by ``seed``, so one seed
gives other weights than the JAX ones; ``build_engine(weights=)`` loads a
flat weight list in the JAX package's order instead
(``core.model.load_jax_weights``).
A sampled request of the sequential baseline draws with the port's
counter-based rule (``core.decode.random_bits``) from its ``seed``, as the
engine does.

Run:  python -m distkeras_tpu_torch.examples.loadgen [--requests 24]
          [--slots 4] [--concurrency 8] [--qps-sweep 20,50,100]
          [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from distkeras_tpu_torch.core.model import FittedModel, load_jax_weights
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import transformer_lm
from distkeras_tpu_torch.router import ServingRouter
from distkeras_tpu_torch.serving import (DisaggPair, QueueFull,
                                         ServingClient, ServingEngine,
                                         ServingServer, TenantPolicy)
from distkeras_tpu_torch.trainers import SingleTrainer

#: prompt lengths are drawn from a SMALL set so the per-length prefill /
#: sequential-generate shapes stay few (the JAX package compiles one
#: program a shape, and both packages draw the same trace); continuation
#: length is fixed per trace for the same reason
PROMPT_LENGTHS = (4, 6, 8)


def make_trace(num_requests: int, seed: int = 0, vocab: int = 16,
               num_steps: int = 16, temperature: float = 0.0,
               sampled_fraction: float = 0.5,
               prompt_lengths: Sequence[int] = PROMPT_LENGTHS,
               pattern: str = "random",
               prefix_groups: Optional[int] = None,
               prefix_len: int = 0,
               long_fraction: float = 0.25,
               tenants: int = 0,
               tier_mix: float = 0.25) -> List[Dict[str, Any]]:
    """A deterministic request trace: seeded prompt contents + lengths, a
    ``sampled_fraction`` of requests sampling at ``temperature`` (per-
    request seeds), the rest greedy — so the slot batch always mixes
    sampling configs, exercising the per-slot sampler.  ``prompt_lengths``
    overrides the drawn length set (the long-prompt TTFT legs use lengths
    past the engine's ``prefill_chunk`` to exercise chunked prefill).

    ``pattern="arith"`` draws each prompt as a seeded-start x+1 (mod
    vocab) run instead of iid tokens — in-distribution for the
    ``build_spec_engine`` trained pair, the way real serving prompts are
    in-distribution for a production draft (speculation's accept rate,
    and therefore its win, is a property of the traffic).

    ``pattern="bimodal"`` is the disaggregation interference trace
    (DistServe/Splitwise): a ``long_fraction`` of requests are
    prefill-heavy (the LONGEST length in ``prompt_lengths``, few decode
    steps) and the rest decode-heavy (the shortest length, the full
    ``num_steps``) — on a unified engine the long-prompt bursts inflate
    decode-token latency; a ``DisaggPair`` isolates them.  Only the two
    extreme lengths are drawn, so the bounded shape budget holds.

    ``prefix_groups``/``prefix_len``: the SHARED-PREFIX trace the paged
    engine's radix index exists for — requests split round-robin across
    ``prefix_groups`` seeded common prefixes of ``prefix_len`` tokens
    (the system prompt / few-shot header / per-tenant template shape),
    each followed by the request's own drawn suffix.  With a paged
    engine every admission after a group's first is a prefix hit that
    prefills only the suffix; a dense engine prefills ``prefix_len +
    suffix`` every time — the TTFT comparison the JAX ``bench.py``'s
    ``serving_prefix_ttft_p99_ms`` leg measures.

    ``tenants``/``tier_mix``: the MIXED-TENANT QoS trace — with
    ``tenants >= 2``, a ``tier_mix`` fraction of requests carry
    ``tenant="interactive"`` and the rest spread over ``tenants - 1``
    batch tenants (``"batch0"``, ``"batch1"``, ...), matching the
    policies :func:`qos_policies` builds.  The draw is seeded, so the
    tier of request *i* is a pure function of ``(seed, i)``."""
    rng = np.random.default_rng(seed)
    prefixes = None
    if prefix_groups is not None:
        if int(prefix_groups) < 1 or int(prefix_len) < 1:
            raise ValueError("prefix_groups needs prefix_groups >= 1 and "
                             "prefix_len >= 1")
        prefixes = [rng.integers(0, vocab, int(prefix_len)).astype(np.int32)
                    for _ in range(int(prefix_groups))]
    trace = []
    for i in range(int(num_requests)):
        steps = int(num_steps)
        if pattern == "bimodal":
            if rng.random() < float(long_fraction):
                p_len = int(max(prompt_lengths))   # prefill-heavy
                steps = max(1, int(num_steps) // 4)
            else:
                p_len = int(min(prompt_lengths))   # decode-heavy
        else:
            p_len = int(prompt_lengths[rng.integers(0, len(prompt_lengths))])
        if pattern == "arith":
            start = int(rng.integers(0, vocab))
            prompt = ((start + np.arange(p_len)) % vocab).astype(np.int32)
        else:
            prompt = rng.integers(0, vocab, p_len).astype(np.int32)
        if prefixes is not None:
            prompt = np.concatenate(
                [prefixes[i % len(prefixes)], prompt]).astype(np.int32)
        req: Dict[str, Any] = {
            "prompt": prompt,
            "num_steps": steps,
            "seed": int(seed * 10_000 + i),
        }
        if temperature > 0.0 and rng.random() < sampled_fraction:
            req["temperature"] = float(temperature)
        if int(tenants) >= 2:
            if rng.random() < float(tier_mix):
                req["tenant"] = "interactive"
            else:
                req["tenant"] = f"batch{int(rng.integers(tenants - 1))}"
        trace.append(req)
    return trace


def qos_policies(tenants: int = 2, interactive_weight: float = 4.0,
                 interactive_rate: Optional[float] = None,
                 interactive_deadline_s: Optional[float] = None):
    """The :class:`distkeras_tpu_torch.serving.TenantPolicy` set matching
    :func:`make_trace`'s tenant names: one ``"interactive"`` tenant
    (interactive tier, ``interactive_weight``× admission weight, optional
    token-bucket ``rate`` and tier deadline) plus ``tenants - 1``
    weight-1 batch tenants."""
    pols = [TenantPolicy("interactive", tier="interactive",
                         weight=interactive_weight,
                         rate=interactive_rate,
                         deadline_s=interactive_deadline_s)]
    for i in range(max(int(tenants) - 1, 1)):
        pols.append(TenantPolicy(f"batch{i}", tier="batch", weight=1.0))
    return pols


def run_overload(engine, trace: Sequence[Dict[str, Any]], qps: float,
                 timeout_s: float = 300.0) -> Dict[str, Any]:
    """The QoS overload leg: open-loop arrivals at an offered ``qps``
    past capacity over a mixed-tenant trace.  The acceptance shape
    (the JAX bench's fields ``serving_interactive_p99_ms_under_overload`` /
    ``serving_batch_completion_rate`` / ``serving_preempt_resume_ms``):
    the interactive tier holds its latency band — weighted-fair
    admission pops it first and starvation preempts batch-tier slots —
    while the batch tier absorbs ALL the queueing, shedding, and
    preemption."""
    engine.start()
    handles = []
    shed = {"interactive": 0, "batch": 0}
    t0 = time.perf_counter()
    for i, req in enumerate(trace):
        due = t0 + i / float(qps)
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        tier = ("interactive" if req.get("tenant") == "interactive"
                else "batch")
        try:
            # QuotaExceeded IS a QueueFull: quota refusals count as sheds
            handles.append((tier, engine.submit(block=False, **req)))
        except QueueFull:
            shed[tier] += 1
    lat = {"interactive": [], "batch": []}
    done = {"interactive": 0, "batch": 0}
    total = dict(shed)
    for tier, h in handles:
        total[tier] += 1
        h.wait(timeout=timeout_s)
        if h.finish in ("eos", "length", "empty"):
            done[tier] += 1
            lat[tier].append(h.latency_s)
    wall = time.perf_counter() - t0
    s = engine.stats
    return {
        "offered_qps": float(qps),
        "wall_s": round(wall, 3),
        "interactive_p50_ms": _percentile_ms(lat["interactive"], 50),
        "interactive_p99_ms": _percentile_ms(lat["interactive"], 99),
        "batch_p99_ms": _percentile_ms(lat["batch"], 99),
        "interactive_completion_rate": round(
            done["interactive"] / max(total["interactive"], 1), 4),
        "batch_completion_rate": round(
            done["batch"] / max(total["batch"], 1), 4),
        "shed_interactive": shed["interactive"],
        "shed_batch": shed["batch"],
        "preemptions": s["preemptions"],
        "resumes": s["resumes"],
        "preempt_swap_ms": (round(float(np.mean(s["preempt_swap_ms"])), 3)
                            if s["preempt_swap_ms"] else None),
        "preempt_resume_ms": (round(float(
            np.mean(s["preempt_resume_ms"])), 3)
            if s["preempt_resume_ms"] else None),
        "kv_blocks_swapped_out": s["kv_blocks_swapped_out"],
        "quota_refused": s["quota_refused"],
        "tenants": {t: dict(v) for t, v in s["tenants"].items()},
    }


def _percentile_ms(latencies_s: Sequence[float], q: float) -> Optional[float]:
    if not latencies_s:
        return None
    return round(float(np.percentile(np.asarray(latencies_s), q)) * 1e3, 2)


def _metrics(engine, latencies: List[float], wall_s: float,
             tokens: int, completed: int, shed: int = 0,
             killed: int = 0, ttfts: Optional[List[float]] = None,
             prefill_tokens: int = 0) -> Dict[str, Any]:
    s = engine.stats
    submitted = max(s["requests_submitted"], 1)
    return {
        "completed": completed,
        "shed": shed,
        "killed": killed,
        "tokens": tokens,
        "wall_s": round(wall_s, 3),
        "tokens_per_sec": round(tokens / wall_s, 1) if wall_s > 0 else None,
        "p50_ms": _percentile_ms(latencies, 50),
        "p99_ms": _percentile_ms(latencies, 99),
        # time-to-first-token, separately from end-to-end latency: the
        # prefill path's own observable (queueing + prefill, no decode)
        "ttft_p50_ms": _percentile_ms(ttfts or [], 50),
        "ttft_p99_ms": _percentile_ms(ttfts or [], 99),
        "prefill_tokens_per_sec": (round(prefill_tokens / wall_s, 1)
                                   if wall_s > 0 else None),
        "slot_occupancy": (round(engine.slot_occupancy, 3)
                           if engine.slot_occupancy is not None else None),
        # failure-semantics observables (engine-lifetime rates: loadgen
        # engines are built fresh per run)
        "shed_rate": round(s["requests_rejected"] / submitted, 4),
        "deadline_miss_rate": round(s["requests_expired"] / submitted, 4),
        "slot_reclaim_ms": (round(float(np.mean(s["slot_reclaim_ms"])), 3)
                            if s["slot_reclaim_ms"] else None),
        # speculative-decoding observables (None unless spec_draft is on):
        # accept rate = accepted draft tokens / drafted, the knob that
        # decides whether spec_len is paying for itself
        "spec_accept_rate": (round(s["accepted"] / s["drafted"], 4)
                             if s["drafted"] else None),
        "spec_verify_calls": s["verify_calls"] or None,
        # paged-pool observables (zero unless paged=True): hit_rate is the
        # fraction of demanded prompt tokens served from the radix index
        # instead of prefilled — the byte-accounted proof of block reuse
        "prefix_hits": s["prefix_hits"],
        "prefix_hit_tokens": s["prefix_hit_tokens"],
        "prefix_hit_rate": (
            round(s["prefix_hit_tokens"]
                  / (s["prefix_hit_tokens"] + s["prefill_tokens"]), 4)
            if s["prefix_hit_tokens"] + s["prefill_tokens"] else None),
        "blocks_allocated": s["blocks_allocated"],
        "blocks_reused": s["blocks_reused"],
        "cow_copies": s["cow_copies"],
        "kv_pool_bytes": s["kv_pool_bytes"],
    }


def run_closed_loop(engine, trace: Sequence[Dict[str, Any]],
                    concurrency: int = 8, timeout_s: float = 300.0,
                    chaos_kill: float = 0.0, chaos_seed: int = 0,
                    deadline_s: Optional[float] = None) -> Dict[str, Any]:
    """``concurrency`` users, each submitting its next trace request when
    its previous one finishes.  Returns throughput/latency/occupancy
    metrics; the engine runs on its background thread for the duration.

    ``chaos_kill`` > 0 turns on the seeded client-kill schedule (the
    ``--chaos`` soak): each request is independently "killed" with that
    probability — its user reads a seeded number of tokens, cancels the
    request (the in-process analog of a client hard-disconnect, which the
    wire server converts to exactly this cancel), and moves on without
    waiting.  ``deadline_s`` stamps every request with a per-request
    deadline.  Killed/expired requests are excluded from the latency
    percentiles; the kill schedule is a pure function of
    ``(chaos_seed, request index)``."""
    it = iter(enumerate(trace))
    lock = threading.Lock()
    latencies: List[float] = []
    ttfts: List[float] = []
    errors: List[BaseException] = []
    killed: List[Any] = []
    kill_rng = np.random.default_rng(int(chaos_seed) + (1 << 20))
    kill_plan = {i: (float(kill_rng.random()) < chaos_kill,
                     int(kill_rng.integers(1, 8)))
                 for i in range(len(trace))} if chaos_kill > 0 else {}
    tokens0 = engine.stats["tokens_generated"]
    completed0 = engine.stats["requests_completed"]
    prefill0 = engine.stats["prefill_tokens"]

    def user():
        while True:
            with lock:
                i, req = next(it, (None, None))
            if req is None:
                return
            kill, after = kill_plan.get(i, (False, 0))
            try:
                kw = dict(req)
                if deadline_s is not None:
                    kw["deadline_s"] = deadline_s
                h = engine.submit(block=True, timeout=timeout_s, **kw)
                if kill:
                    # killed client: consume a few tokens, then vanish
                    deadline = time.perf_counter() + timeout_s
                    while (len(h.tokens) < after and not h.done
                           and time.perf_counter() < deadline):
                        time.sleep(0.001)
                    engine.cancel(h)
                    with lock:
                        killed.append(h)
                    continue
                if not h.wait(timeout=timeout_s):
                    raise TimeoutError(f"request {h.id} incomplete")
            except BaseException as e:  # noqa: BLE001 - surfaced below
                with lock:
                    errors.append(e)
                return
            with lock:
                if h.finish in ("eos", "length", "empty"):
                    latencies.append(h.latency_s)
                    if h.ttft_s is not None:
                        ttfts.append(h.ttft_s)

    engine.start()
    threads = [threading.Thread(target=user, name=f"loadgen-user-{i}")
               for i in range(int(concurrency))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    # killed users cancel and move on without waiting for the retirement,
    # so the scheduler may be one iteration away from reaping the last
    # cancel — let terminal accounting settle (bounded) before reading it
    # routers/pairs book cancels and expiries in their own terminal
    # counters, NOT in requests_completed (a bare engine books them in
    # both — adding them there would double-count half-reaped kills)
    own_counters = hasattr(engine, "counters")

    def _terminal(s):
        t = (s["requests_completed"] + s["requests_failed"]
             + s["requests_rejected"])
        if own_counters:
            t += s.get("requests_cancelled", 0) + s.get(
                "requests_expired", 0)
        return t

    s = engine.stats
    settle_deadline = time.perf_counter() + 10.0
    while (s["requests_submitted"] > _terminal(s)
           and time.perf_counter() < settle_deadline):
        time.sleep(0.005)
        s = engine.stats
    return _metrics(engine, latencies, wall,
                    engine.stats["tokens_generated"] - tokens0,
                    engine.stats["requests_completed"] - completed0,
                    killed=len(killed), ttfts=ttfts,
                    prefill_tokens=engine.stats["prefill_tokens"] - prefill0)


def run_open_loop(engine, trace: Sequence[Dict[str, Any]], qps: float,
                  timeout_s: float = 300.0) -> Dict[str, Any]:
    """Offered-QPS arrivals: submit request i at ``i / qps`` seconds after
    start, whatever the engine's progress.  Backpressured submissions
    (bounded queue full) are SHED and counted — overload degrades by
    shedding, not by unbounded buffering."""
    engine.start()
    handles = []
    shed = 0
    tokens0 = engine.stats["tokens_generated"]
    completed0 = engine.stats["requests_completed"]
    prefill0 = engine.stats["prefill_tokens"]
    t0 = time.perf_counter()
    for i, req in enumerate(trace):
        due = t0 + i / float(qps)
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        try:
            handles.append(engine.submit(block=False, **req))
        except QueueFull:
            shed += 1
    latencies = []
    ttfts = []
    for h in handles:
        if not h.wait(timeout=timeout_s):
            raise TimeoutError(f"request {h.id} incomplete")
        latencies.append(h.latency_s)
        if h.ttft_s is not None:
            ttfts.append(h.ttft_s)
    wall = time.perf_counter() - t0
    out = _metrics(engine, latencies, wall,
                   engine.stats["tokens_generated"] - tokens0,
                   engine.stats["requests_completed"] - completed0,
                   shed=shed, ttfts=ttfts,
                   prefill_tokens=engine.stats["prefill_tokens"] - prefill0)
    out["offered_qps"] = float(qps)
    return out


def run_wire_closed_loop(addr, trace: Sequence[Dict[str, Any]],
                         concurrency: int = 8,
                         timeout_s: float = 300.0) -> Dict[str, Any]:
    """``concurrency`` WIRE clients — one TCP connection each — against a
    :class:`distkeras_tpu_torch.serving.ServingServer` address, each submitting
    its next trace request the moment its previous one completes: the
    closed loop of :func:`run_closed_loop` moved onto real sockets, so
    what it measures is the server's transport core, not just the engine.
    At 64 clients the thread-per-connection core holds 64 server-side
    relay threads while the event core holds ONE selector thread —
    ``server_conn_threads_peak`` samples that difference mid-flight (the
    O(1)-vs-O(N) observable the JAX ``bench.py``'s
    ``serving_connection_scaling`` field records alongside tokens/sec per
    core × client count)."""
    it = iter(trace)
    lock = threading.Lock()
    latencies: List[float] = []
    errors: List[BaseException] = []
    tokens = [0]

    def user():
        try:
            with ServingClient(*addr) as c:
                while True:
                    with lock:
                        req = next(it, None)
                    if req is None:
                        return
                    kw = dict(req)
                    prompt = kw.pop("prompt")
                    steps = kw.pop("num_steps")
                    r0 = time.perf_counter()
                    rid = c.submit(prompt, steps, **kw)
                    got = 0
                    for toks, done in c.stream(rid):
                        got += len(toks)
                        if done is not None:
                            break
                    with lock:
                        tokens[0] += got
                        latencies.append(time.perf_counter() - r0)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=user, name=f"loadgen-wire-{i}")
               for i in range(int(concurrency))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    # sample the server's per-connection thread count while streams are
    # live (threads named dkt-serving-conn*: the threaded core's O(N))
    peak_conn_threads = 0
    deadline = t0 + timeout_s
    while any(t.is_alive() for t in threads):
        n = sum(1 for t in threading.enumerate()
                if t.name.startswith("dkt-serving-conn"))
        peak_conn_threads = max(peak_conn_threads, n)
        if time.perf_counter() > deadline:
            break
        time.sleep(0.005)
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()) + 1.0)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return {
        "clients": int(concurrency),
        "completed": len(latencies),
        "tokens": tokens[0],
        "wall_s": round(wall, 3),
        "tokens_per_sec": (round(tokens[0] / wall, 1)
                           if wall > 0 else None),
        "p50_ms": _percentile_ms(latencies, 50),
        "p99_ms": _percentile_ms(latencies, 99),
        "server_conn_threads_peak": peak_conn_threads,
    }


def sequential_baseline(fitted, trace: Sequence[Dict[str, Any]],
                        max_len: int) -> Dict[str, Any]:
    """The same trace, one request at a time through offline ``generate``
    (the pre-engine serving story): per-request latency IS the service
    time, and tokens/sec has no batching to lean on.  A sampled request
    draws from its ``seed`` (an int ``rng``: the port's counter-based
    rule, the engine's draws for the same seed)."""
    latencies: List[float] = []
    tokens = 0
    t0 = time.perf_counter()
    for req in trace:
        r0 = time.perf_counter()
        out = fitted.generate(
            req["prompt"][None], req["num_steps"],
            temperature=req.get("temperature", 0.0),
            rng=int(req["seed"]) if req.get("temperature") else None,
            max_len=max_len)
        out.cpu()  # materialize before stopping the clock
        latencies.append(time.perf_counter() - r0)
        tokens += int(req["num_steps"])
    wall = time.perf_counter() - t0
    return {
        "completed": len(trace),
        "tokens": tokens,
        "wall_s": round(wall, 3),
        "tokens_per_sec": round(tokens / wall, 1) if wall > 0 else None,
        "p50_ms": _percentile_ms(latencies, 50),
        "p99_ms": _percentile_ms(latencies, 99),
    }


def _lm(vocab: int, max_len: int, layers: int, seed: int, device,
        weights: Optional[Sequence[np.ndarray]] = None) -> FittedModel:
    """The loadgen LM (d_model 32, 4 heads, mlp 64, f32) of ``layers``
    layers on ``device``: random weights drawn from a generator seeded by
    ``seed``, or ``weights`` (a flat list in the JAX package's order)."""
    model = transformer_lm(vocab_size=vocab, seq_len=max_len, d_model=32,
                           num_heads=4, num_layers=layers, mlp_dim=64,
                           compute_dtype="float32", device=device,
                           generator=torch.Generator().manual_seed(seed))
    if weights is not None:
        load_jax_weights(model, weights)
    return FittedModel(model)


def _pool_kw(prefill_mode: str, prefill_chunk: Optional[int], paged: bool,
             block_size: Optional[int],
             kv_blocks: Optional[int]) -> Dict[str, Any]:
    kw: Dict[str, Any] = {"prefill_mode": prefill_mode}
    if prefill_chunk is not None:
        kw["prefill_chunk"] = int(prefill_chunk)
    if paged:
        kw["paged"] = True
        if block_size is not None:
            kw["block_size"] = int(block_size)
        if kv_blocks is not None:
            kw["kv_blocks"] = int(kv_blocks)
    return kw


def build_engine(num_slots: int = 4, max_len: int = 32, vocab: int = 16,
                 queue_capacity: int = 64, seed: int = 0,
                 prefill_mode: str = "bucketed",
                 prefill_chunk: Optional[int] = None,
                 prefills_per_step: Optional[int] = None,
                 spec_draft: Optional[str] = None,
                 spec_len: Optional[int] = None,
                 quantize: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 paged: bool = False,
                 block_size: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 disaggregate: bool = False,
                 prefill_engines: int = 1,
                 device=None,
                 weights: Optional[Sequence[np.ndarray]] = None):
    """A small random-weight LM + engine on ``device`` (throughput benches
    measure scheduling and batching, not model quality) — one place so
    tests, the chip smoke run and the CLI agree on the workload shape.
    ``prefill_mode``/``prefill_chunk``/``prefills_per_step`` pass through
    to the engine (the TTFT comparison legs run the same trace through
    ``"bucketed"`` and ``"eager"``).  ``weights`` replaces the seeded
    draw of the target (a flat list in the JAX package's order).

    ``spec_draft``: ``"self"`` uses the target as its own draft (high
    accept rate — the round-collapsing win is real because the whole
    draft+verify round is ONE dispatch), or an int layer count for a
    separate random-weight draft drawn from ``seed + 1`` (near-floor
    accept rate — the worst case).  ``spec_len``/``quantize``/``kv_dtype``
    pass through.

    ``disaggregate=True`` returns a ``DisaggPair`` instead of one
    engine: ``prefill_engines`` role="prefill" engines feeding one
    role="decode" engine over the in-process hand-off (paged is forced —
    KV-block transfer is a paged-arena operation; ``spec_draft`` is
    incompatible with role engines and rejected by the constructor)."""
    fitted = _lm(vocab, max_len, 2, seed, device, weights)
    kw = _pool_kw(prefill_mode, prefill_chunk, paged or disaggregate,
                  block_size, kv_blocks)
    if prefills_per_step is not None:
        kw["prefills_per_step"] = int(prefills_per_step)
    if spec_draft is not None:
        if str(spec_draft) == "self":
            kw["spec_draft"] = fitted
        else:
            kw["spec_draft"] = _lm(vocab, max_len, int(spec_draft),
                                   seed + 1, device)
    if spec_len is not None:
        kw["spec_len"] = int(spec_len)
    if quantize is not None:
        kw["quantize"] = quantize
    if kv_dtype is not None:
        kw["kv_dtype"] = kv_dtype
    if disaggregate:
        mk = lambda role: ServingEngine(  # noqa: E731
            fitted, num_slots=num_slots, max_len=max_len,
            queue_capacity=queue_capacity, role=role, **kw)
        engine = DisaggPair([mk("prefill")
                             for _ in range(int(prefill_engines))],
                            decode=mk("decode"))
        return fitted, engine
    engine = ServingEngine(fitted, num_slots=num_slots, max_len=max_len,
                           queue_capacity=queue_capacity, **kw)
    return fitted, engine


def build_fleet(replicas: int = 2, affinity: str = "prefix",
                num_slots: int = 4, max_len: int = 32, vocab: int = 16,
                queue_capacity: int = 64, seed: int = 0,
                prefill_mode: str = "bucketed",
                prefill_chunk: Optional[int] = None,
                paged: bool = False,
                block_size: Optional[int] = None,
                kv_blocks: Optional[int] = None,
                router_seed: int = 0,
                tenants=None,
                device=None):
    """``replicas`` identical engines serving the SAME weights behind a
    :class:`distkeras_tpu_torch.router.ServingRouter` — the fleet analog
    of ``build_engine`` (one model build, N engines, so what the bench
    measures is routing + replication, not N different models).  The
    router gets an ``engine_factory`` too, so ``autoscale_tick`` /
    ``scale_up`` work out of the box on the returned fleet."""
    fitted = _lm(vocab, max_len, 2, seed, device)
    kw = _pool_kw(prefill_mode, prefill_chunk, paged, block_size, kv_blocks)
    mk = lambda: ServingEngine(  # noqa: E731
        fitted, num_slots=num_slots, max_len=max_len,
        queue_capacity=queue_capacity, **kw)
    router = ServingRouter([mk() for _ in range(int(replicas))],
                           affinity=affinity, seed=router_seed,
                           engine_factory=mk,
                           max_replicas=max(int(replicas) * 2, 2),
                           tenants=tenants)
    return fitted, router


def fleet_report(router, closed: Dict[str, Any]) -> Dict[str, Any]:
    """The per-replica occupancy-skew report: how evenly (or, under
    prefix affinity, how DELIBERATELY unevenly) the trace landed across
    the fleet.  ``routed_skew`` is max/mean routed requests per live
    replica — 1.0 is a perfectly balanced fleet; prefix affinity trades
    some skew for the warm-trie ``prefix_hit_rate``."""
    snap = router.fleet_snapshot()
    per_replica = [{
        "uid": rep["uid"], "kind": rep["kind"],
        "generation": rep["generation"], "routed": rep["routed"],
        "tokens_generated": rep["load"].get("tokens_generated", 0),
        "queue_depth": rep["load"].get("queue_depth", 0),
        "trie_blocks": rep["load"].get("trie_blocks", 0),
    } for rep in snap]
    routed = [p["routed"] for p in per_replica]
    mean = sum(routed) / max(len(routed), 1)
    return {
        "mode": "fleet",
        "replicas": len(per_replica),
        "affinity": router.affinity,
        "per_replica": per_replica,
        "routed_skew": round(max(routed) / mean, 3) if mean else None,
        "prefix_hit_rate": closed.get("prefix_hit_rate"),
        "affinity_routed": router.counters["affinity_routed"],
        "affinity_spills": router.counters["affinity_spills"],
        "resubmissions": router.counters["resubmissions"],
        "requests_failed": router.counters["requests_failed"],
    }


#: build_spec_engine's x+1 task: rows of SPEC_SEQ tokens, batch SPEC_BATCH
SPEC_ROWS, SPEC_SEQ, SPEC_BATCH = 256, 12, 32
#: build_spec_engine's target and draft depths
SPEC_TARGET_LAYERS, SPEC_DRAFT_LAYERS = 2, 1


def build_spec_engine(num_slots: int = 4, max_len: int = 32,
                      vocab: int = 16, queue_capacity: int = 64,
                      spec_len: int = 4, num_epoch: int = 25,
                      seed: int = 0, device=None, **engine_kw):
    """A TRAINED (2-layer target, 1-layer draft) pair on the
    deterministic x+1 token task + a speculative engine over them — the
    honest speculative configuration: the draft is roughly half the
    target's compute yet proposes what the target would emit, so a round
    commits ~``spec_len`` tokens for less than ``spec_len + 1``
    target-step-equivalents of compute ON TOP of collapsing the round to
    one dispatch.  Both train with ``SingleTrainer`` on ``device`` (on a
    card each training step runs the flash-attention kernels once a
    layer: f32 at head dim 8 takes their SIMT variants), each from
    weights drawn from a generator seeded by ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (SPEC_ROWS, SPEC_SEQ)).astype(np.int32)
    y = (x + 1) % vocab

    def train(layers):
        model = _lm(vocab, max_len, layers, seed, device).model
        t = SingleTrainer(
            model, batch_size=SPEC_BATCH, num_epoch=num_epoch,
            loss="sparse_categorical_crossentropy_from_logits",
            worker_optimizer="adam", learning_rate=3e-3, device=device)
        return t.train(Dataset({"features": x, "label": y}))

    target = train(SPEC_TARGET_LAYERS)
    draft = train(SPEC_DRAFT_LAYERS)
    engine = ServingEngine(target, num_slots=num_slots, max_len=max_len,
                           queue_capacity=queue_capacity,
                           spec_draft=draft, spec_len=spec_len,
                           **engine_kw)
    return target, draft, engine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--qps-sweep", type=str, default="",
                    help="comma-separated offered-QPS points (open loop)")
    ap.add_argument("--chaos", type=float, default=0.0,
                    help="seeded client-kill probability per request "
                         "(closed loop): killed users read a few tokens, "
                         "cancel, and vanish — the disconnect-reclamation "
                         "soak")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline_s stamped on every request")
    ap.add_argument("--prefill-mode", choices=("bucketed", "eager"),
                    default="bucketed",
                    help="engine prefill path: the bucketed fast path "
                         "(default) or the eager reference")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill threshold/size (tokens); prompts "
                         "longer than this interleave with decode steps")
    ap.add_argument("--ttft", action="store_true",
                    help="print a dedicated time-to-first-token percentile "
                         "line (p50/p99 + prefill counters) for the "
                         "closed loop")
    ap.add_argument("--spec-draft", type=str, default=None,
                    help="speculative decoding: 'self' (target drafts for "
                         "itself — high accept) or an int layer count for "
                         "a separate random-weight draft model")
    ap.add_argument("--spec-len", type=int, default=None,
                    help="draft tokens per speculative round "
                         "(rows commit 1..spec_len+1 tokens per round)")
    ap.add_argument("--quantize", choices=("int8", "bf16"), default=None,
                    help="weight quantization applied at engine build "
                         "(and to every hot-reload pull)")
    ap.add_argument("--kv-dtype", choices=("int8",), default=None,
                    help="int8 KV slot pool (codes + per-entry scales, "
                         "~half the slot bytes)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool: block-granular arena + "
                         "per-request block tables + radix prefix "
                         "sharing (see --block-size / --prefix-groups)")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged pool block size in tokens (default 16)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged pool arena size in blocks (default: the "
                         "dense pool's capacity)")
    ap.add_argument("--prefix-groups", type=int, default=None,
                    help="shared-prefix trace: requests split round-robin "
                         "across this many seeded common prefixes")
    ap.add_argument("--prefix-len", type=int, default=16,
                    help="shared-prefix length in tokens "
                         "(with --prefix-groups)")
    ap.add_argument("--max-len", type=int, default=32,
                    help="engine max_len (raise for long shared prefixes)")
    ap.add_argument("--pattern", choices=("random", "arith", "bimodal"),
                    default="random",
                    help="trace shape: iid prompts, x+1 runs, or the "
                         "bimodal long-prompt + decode-heavy interference "
                         "mix (the disaggregation scenario)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="serve through a DisaggPair: role='prefill' "
                         "engines fill KV blocks and ship them to one "
                         "role='decode' engine owning the token loop "
                         "(implies --paged)")
    ap.add_argument("--prefill-engines", type=int, default=1,
                    help="prefill engines feeding the decode engine "
                         "(with --disaggregate)")
    ap.add_argument("--router", action="store_true",
                    help="serve through a ServingRouter fronting "
                         "--replicas identical engines (same weights); "
                         "prints a per-replica occupancy-skew report — "
                         "the multi-tenant fleet trace is --router "
                         "--paged --affinity prefix --prefix-groups G")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet size behind --router")
    ap.add_argument("--affinity", choices=("prefix", "least-loaded",
                                           "random"), default="prefix",
                    help="router dispatch policy: prefix-affinity "
                         "(cache-aware, the default), pure least-loaded, "
                         "or seeded random (the control arm)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="mixed-tenant QoS trace: one interactive tenant "
                         "plus N-1 batch tenants, with matching "
                         "TenantPolicy registrations on the engine/fleet "
                         "(needs >= 2)")
    ap.add_argument("--tier-mix", type=float, default=0.25,
                    help="fraction of requests on the interactive tenant "
                         "(with --tenants)")
    ap.add_argument("--server-core", choices=("threaded", "event"),
                    default=None,
                    help="run the trace over REAL sockets: wrap the "
                         "engine in a ServingServer with this transport "
                         "core and drive it with --concurrency wire "
                         "clients (closed loop); prints tokens/sec plus "
                         "the mid-flight per-connection server thread "
                         "count — the O(1)-vs-O(N) transport comparison")
    ap.add_argument("--overload", type=float, default=None,
                    help="run the QoS overload leg instead of the closed "
                         "loop: open-loop arrivals at this offered QPS "
                         "over the mixed-tenant trace, printing per-tier "
                         "latency/completion + preemption counters")
    ap.add_argument("--device", default="cuda",
                    help="the device that holds the model and its KV "
                         "pools (cuda by default; cpu runs without a "
                         "card)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)

    if args.router and (args.disaggregate or args.spec_draft is not None):
        ap.error("--router replicates unified engines; it composes with "
                 "--disaggregate or --spec-draft only behind a "
                 "ServingServer address, not in-process")
    if args.overload is not None and args.tenants < 2:
        ap.error("--overload is the mixed-tenant QoS leg; pass "
                 "--tenants >= 2")
    if args.tenants and args.disaggregate:
        ap.error("--tenants registers policies on unified engines or a "
                 "router fleet; DisaggPair does not take tenant policies")
    policies = qos_policies(args.tenants) if args.tenants >= 2 else None
    fleet_kw = dict(replicas=args.replicas, affinity=args.affinity,
                    num_slots=args.slots, max_len=args.max_len,
                    prefill_mode=args.prefill_mode,
                    prefill_chunk=args.prefill_chunk, paged=args.paged,
                    block_size=args.block_size, kv_blocks=args.kv_blocks,
                    device=args.device)
    engine_kw = dict(num_slots=args.slots, max_len=args.max_len,
                     prefill_mode=args.prefill_mode,
                     prefill_chunk=args.prefill_chunk,
                     spec_draft=args.spec_draft, spec_len=args.spec_len,
                     quantize=args.quantize, kv_dtype=args.kv_dtype,
                     paged=args.paged, block_size=args.block_size,
                     kv_blocks=args.kv_blocks,
                     disaggregate=args.disaggregate,
                     prefill_engines=args.prefill_engines,
                     device=args.device)

    if args.router:
        fitted, engine = build_fleet(tenants=policies, **fleet_kw)
    else:
        fitted, engine = build_engine(**engine_kw)
    if policies is not None and not args.router:
        for p in policies:
            engine.register_tenant(p)
    trace = make_trace(args.requests, num_steps=args.steps,
                       temperature=args.temperature,
                       pattern=args.pattern,
                       prefix_groups=args.prefix_groups,
                       prefix_len=args.prefix_len,
                       tenants=args.tenants, tier_mix=args.tier_mix)
    try:
        if args.server_core is not None:
            srv = ServingServer(engine, server_core=args.server_core,
                                poll_s=0.01).start()
            try:
                wire = run_wire_closed_loop(srv.addr, trace,
                                            concurrency=args.concurrency)
            finally:
                srv.stop()
            print(json.dumps({"mode": "wire_closed_loop",
                              "server_core": args.server_core, **wire}))
            return
        if args.overload is not None:
            point = run_overload(engine, trace, qps=args.overload)
            print(json.dumps({"mode": "qos_overload",
                              "tenants": args.tenants,
                              "tier_mix": args.tier_mix, **point}))
            return
        closed = run_closed_loop(engine, trace,
                                 concurrency=args.concurrency,
                                 chaos_kill=args.chaos,
                                 chaos_seed=args.chaos_seed,
                                 deadline_s=args.deadline)
        print(json.dumps({"mode": "closed_loop",
                          "concurrency": args.concurrency, **closed}))
        if args.spec_draft is not None:
            print(json.dumps({
                "mode": "spec", "spec_draft": args.spec_draft,
                "accept_rate": closed["spec_accept_rate"],
                "drafted": engine.stats["drafted"],
                "accepted": engine.stats["accepted"],
                "verify_calls": engine.stats["verify_calls"]}))
        if args.disaggregate:
            s = engine.stats
            print(json.dumps({
                "mode": "disagg",
                "prefill_engines": args.prefill_engines,
                "kv_blocks_shipped": s["kv_blocks_shipped"],
                "kv_block_bytes_shipped": s["kv_block_bytes_shipped"],
                "transfer_ms_mean": (round(float(np.mean(
                    s["transfer_ms"])), 3) if s["transfer_ms"] else None),
                "prefill_reroutes": s["prefill_reroutes"]}))
        if args.router:
            print(json.dumps(fleet_report(engine, closed)))
        if args.paged:
            paged_eng = (engine.engines[0]
                         if (args.disaggregate or args.router)
                         else engine)
            print(json.dumps({
                "mode": "paged",
                "block_size": paged_eng.block_size,
                "kv_blocks": paged_eng.kv_blocks,
                "prefix_hits": closed["prefix_hits"],
                "prefix_hit_tokens": closed["prefix_hit_tokens"],
                "prefix_hit_rate": closed["prefix_hit_rate"],
                "blocks_allocated": closed["blocks_allocated"],
                "blocks_reused": closed["blocks_reused"],
                "cow_copies": closed["cow_copies"],
                "kv_pool_bytes": closed["kv_pool_bytes"]}))
        if args.ttft:
            print(json.dumps({
                "mode": "ttft", "prefill_mode": args.prefill_mode,
                "p50_ms": closed["ttft_p50_ms"],
                "p99_ms": closed["ttft_p99_ms"],
                "prefill_tokens_per_sec":
                    closed["prefill_tokens_per_sec"],
                "prefill_chunks": engine.stats["prefill_chunks"],
                "prefill_batch_size_mean":
                    engine.stats["prefill_batch_size_mean"]}))
        seq = sequential_baseline(fitted, trace, max_len=engine.max_len)
        print(json.dumps({"mode": "sequential", **seq}))
        if closed["tokens_per_sec"] and seq["tokens_per_sec"]:
            print(json.dumps({"mode": "speedup", "continuous_vs_sequential":
                              round(closed["tokens_per_sec"]
                                    / seq["tokens_per_sec"], 2)}))
        for qps in filter(None, args.qps_sweep.split(",")):
            if args.router:
                _, engine = build_fleet(**fleet_kw)
            else:
                _, engine = build_engine(**engine_kw)
            point = run_open_loop(engine, trace, qps=float(qps))
            engine.stop()
            print(json.dumps({"mode": "open_loop", **point}))
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
