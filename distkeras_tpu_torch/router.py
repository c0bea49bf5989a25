"""Replicated serving fleet behind one router, a copy of
``distkeras_tpu/router.py`` over the port's engines, servers and clients.

A :class:`ServingRouter` fronts N engine replicas — in-process
:class:`serving.ServingEngine` instances or remote
:class:`serving.ServingServer` addresses over the serving wire (the JAX
package's wire byte for byte, so a remote replica may be either
package's server) — behind the unchanged client surface: ``submit``
returns a :class:`serving.RequestHandle` proxy that streams
(``next_chunk``) and resolves (``result``) exactly like a bare engine's
handle.  The router is host code: it holds no device of its own, and its
relay loop, failover threads and load probes touch only handles, token
lists and load snapshots.  Its in-process replicas run on the device
they were built for (the CUDA card unless built with ``device="cpu"``);
a resubmission only queues on the target engine, whose own thread runs
the prefill.

**Dispatch.**  The baseline policy is least-loaded: every replica
publishes a lock-free load snapshot (:meth:`serving.ServingEngine.load`
in-process, the ``SERVING_OP_STATS`` probe over the wire) and the router
picks the replica minimizing ``queue_depth + active``.  On top of it,
``affinity="prefix"`` (the default) adds cache-aware routing: the
prompt's leading paged blocks — the SAME block_size/boundary rule the
paged pool's radix trie matches on, full ``block_size``-token chunks
capped below the prompt length — hash to a replica by rendezvous
(highest-random-weight) hashing over their int32 little-endian bytes and
the replica uid (``zlib.crc32``, the JAX router's hash, so both routers
pick the same replica), so shared-prefix tenants consistently land on the
replica whose trie is already warm and fleet membership changes only
remap the groups that lost their replica.  A saturated affine replica (no
free slot AND a queue more than one slot-pool deeper than the
least-loaded's) spills to least-loaded — affinity is a preference, not a
hostage situation.

**Zero-loss failover.**  A replica killed mid-stream fails its requests
with the typed :class:`serving.EngineDead`; the router resubmits them to
another live replica under ``retry_policy`` (one
:class:`resilience.RetryPolicy`, the same machinery
``ServingClient.generate`` re-dials with — no second retry
implementation) with the request's ORIGINAL seed, and the replay skips
the tokens the client already saw: seeded sampling makes the resubmitted
stream bit-identical (one counter-based draw per (key, position)), so an
accepted request loses nothing — not even its already-streamed prefix.
Nothing routes to a CPU engine in place of a dead card replica: the
candidates are the fleet's own replicas.

**Elasticity + blue/green.**  ``scale_up``/``scale_down`` grow and drain
the in-process fleet through the same ``respawn``/``drain`` machinery the
supervisors use (``autoscale_tick`` drives them from queue depth);
``rolling_swap`` runs the engine's atomic generation swap
(``respawn_clone``, ``warmup``, ``start``, ``replace_engine``, drain)
one replica at a time under live traffic, so some replica is always
serving and every response is attributable to exactly one ``(replica,
generation)``.  On a card a clone's ``warmup`` captures its decode graph
while the other replicas keep launching from their own threads.
``resilience.FleetSupervisor`` watches the in-process replicas through
the router's ``replace_engine`` seam.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import networking
from . import resilience
from .serving import (Draining, EngineDead, QueueFull, RequestHandle,
                      ServingClient, ServingEngine, TenantPolicy)

__all__ = ["ServingRouter", "DEFAULT_RESUBMIT_POLICY"]


#: router→replica resubmission default: keep trying for a supervisor's
#: detection + restart window (the same shape as
#: ``resilience.DEFAULT_RECOVERY_POLICY``, tighter backoff — replicas are
#: local or LAN, and a queued resubmission holds a client stream open).
DEFAULT_RESUBMIT_POLICY = resilience.RetryPolicy(
    attempts=None, backoff=0.01, max_backoff=0.25, deadline=15.0)

#: faults that mean "this replica lost the request": typed engine death
#: (crash/wedge/drain-timeout) or the wire to it breaking.  The request
#: is resubmittable — seeded determinism makes the retry idempotent.
_REPLICA_LOST = (EngineDead, ConnectionError, OSError)

#: everything a resubmission attempt may transiently hit: a lost replica
#: again, or every OTHER replica momentarily full/draining.
_RESUBMIT_RETRY_ON = _REPLICA_LOST + (QueueFull, Draining)

#: event-relay scratch recv size: token-stream reply frames are small —
#: 64 KiB amortizes syscalls without hoarding per-stream buffers.
_RELAY_RECV_CHUNK = 1 << 16


def _host_prompt(prompt) -> np.ndarray:
    """A request's prompt as a host int32 array, whatever it arrived as
    (a list, a numpy array, a torch tensor, on the card too: one read per
    submission, never one per dispatch); the affinity hash and every
    replica see these tokens."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt, np.int32)


class _EngineReplica:
    """One in-process replica: a unified :class:`ServingEngine` plus the
    router-side identity (uid, generation, draining flag) dispatch and
    attribution hang off.  Mutable fields are written only under the
    router's lock; relay threads read them without it (a stale read costs
    one wasted attempt, never correctness — attachment is re-checked by
    the submit itself)."""

    kind = "engine"

    def __init__(self, uid: int, engine: ServingEngine):
        self.uid = uid
        self.engine = engine
        self.generation = 0
        self.draining = False
        self.routed = 0

    def load(self) -> Dict[str, Any]:
        return self.engine.load()

    def close(self) -> None:
        pass


class _WireReplica:
    """One remote replica: a ``(host, port)`` :class:`serving.ServingServer`
    address.  Request traffic borrows streaming clients from the router's
    :class:`networking.ClientPool`; load probes ride a dedicated client
    (serialized under a probe lock — submitting threads race here) and
    cache for ``load_ttl`` so a dispatch burst costs one round-trip, not
    one per request.  An unreachable server answers probes with a
    synthetic ``dead`` snapshot and self-heals on the next successful
    dial."""

    kind = "wire"

    def __init__(self, uid: int, addr: Tuple[str, int],
                 load_ttl: float = 0.02):
        self.uid = uid
        self.addr = (str(addr[0]), int(addr[1]))
        self.load_ttl = float(load_ttl)
        self.generation = 0
        self.draining = False
        self.routed = 0
        self._probe: Optional[ServingClient] = None
        self._plock = threading.Lock()
        self._cached: Optional[Dict[str, Any]] = None
        self._cached_at = 0.0

    def load(self) -> Dict[str, Any]:
        with self._plock:
            now = time.monotonic()
            if (self._cached is not None
                    and now - self._cached_at < self.load_ttl):
                return dict(self._cached)
            try:
                if self._probe is None:
                    self._probe = ServingClient(*self.addr)
                snap = self._probe.load()
            except (ConnectionError, OSError):
                if self._probe is not None:
                    self._probe.close()
                    self._probe = None
                snap = {"queue_depth": 0, "slots_free": 0,
                        "slots_total": 0, "active": 0, "trie_blocks": 0,
                        "dead": True, "draining": False,
                        "unreachable": True}
            self._cached, self._cached_at = snap, now
            return dict(snap)

    def close(self) -> None:
        with self._plock:
            if self._probe is not None:
                self._probe.close()
                self._probe = None
            self._cached = None


class _RouterRequest:
    """One in-flight request's routing record: the client-facing proxy,
    the current attachment (replica + upstream handle in-process, or
    pooled client + server id over the wire), a cancel relay pointing at
    whichever replica owns the request right now, and the replay cursor
    (``relayed`` — tokens already pushed into the proxy, skipped when a
    resubmitted stream replays from token zero)."""

    __slots__ = ("proxy", "kw", "replica", "upstream", "client", "rid",
                 "cancel_fn", "cancelled", "relayed", "attached",
                 "resubmits", "thread")

    def __init__(self, proxy: RequestHandle, kw: Dict[str, Any]):
        self.proxy = proxy
        self.kw = kw
        self.replica = None
        self.upstream: Optional[RequestHandle] = None
        self.client: Optional[ServingClient] = None
        self.rid: Optional[int] = None
        self.cancel_fn: Optional[Callable[[], Any]] = None
        self.cancelled = False
        self.relayed = 0
        self.attached: Optional[Tuple[int, int]] = None
        self.resubmits = 0
        self.thread: Optional[threading.Thread] = None


class ServingRouter:
    """Route requests across a fleet of serving replicas (see the module
    docstring for the policy/failover/elasticity story).

    ``replicas`` are in-process unified :class:`serving.ServingEngine`
    instances; ``addrs`` are ``(host, port)`` remote
    :class:`serving.ServingServer` addresses.  Either may be empty, not
    both.  ``affinity`` is ``"prefix"`` (default), ``"least-loaded"``, or
    ``"random"`` (seeded — the control arm benchmarks compare against).
    ``block_size`` must match the replicas' paged block size for the
    affinity hash to align with their tries; by default it is read off
    the first in-process paged engine (16 otherwise).

    ``engine_factory`` (a zero-arg callable returning an UNSTARTED
    engine) enables ``scale_up``/``autoscale_tick``; without it the fleet
    is fixed-size.  ``retry_policy`` bounds failover resubmission.
    """

    def __init__(self, replicas: Optional[Sequence[ServingEngine]] = None,
                 addrs: Optional[Sequence[Tuple[str, int]]] = None, *,
                 affinity: str = "prefix", affinity_blocks: int = 2,
                 block_size: Optional[int] = None,
                 retry_policy: Optional[resilience.RetryPolicy] = None,
                 seed: int = 0, poll_s: float = 0.02,
                 load_ttl: float = 0.02,
                 engine_factory: Optional[Callable[[], ServingEngine]]
                 = None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 scale_up_queue: int = 4,
                 max_idle_clients: int = 4,
                 tenants: Optional[Sequence[TenantPolicy]] = None):
        replicas = list(replicas or [])
        addrs = list(addrs or [])
        if not replicas and not addrs:
            raise ValueError("ServingRouter needs at least one replica: "
                             "pass replicas= (in-process engines) and/or "
                             "addrs= (remote ServingServer addresses)")
        if affinity not in ("prefix", "least-loaded", "random"):
            raise ValueError(f"unknown affinity policy {affinity!r}")
        for e in replicas:
            if e.role != "unified":
                raise ValueError(
                    "router replicas must be unified engines; got "
                    f"role={e.role!r} — front role-split engines with a "
                    "DisaggPair and serve THAT behind a ServingServer")
        self.affinity = affinity
        self.affinity_blocks = int(affinity_blocks)
        if block_size is None:
            paged = [e for e in replicas if e.paged]
            block_size = paged[0].block_size if paged else 16
        self.block_size = int(block_size)
        self.retry_policy = (DEFAULT_RESUBMIT_POLICY if retry_policy is None
                             else retry_policy)
        self.seed = int(seed)
        self.poll_s = float(poll_s)
        self.engine_factory = engine_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_queue = int(scale_up_queue)
        self._pool = networking.ClientPool(
            lambda addr: ServingClient(*addr),
            max_idle_per_addr=max_idle_clients)
        self._lock = threading.Lock()
        self._next_uid = 0
        self._replicas: List[Any] = []
        for e in replicas:
            self._replicas.append(_EngineReplica(self._next_uid, e))
            self._next_uid += 1
        for a in addrs:
            self._replicas.append(
                _WireReplica(self._next_uid, a, load_ttl=load_ttl))
            self._next_uid += 1
        #: fleet-level QoS: the policies are the dispatch's tier
        #: map AND are cloned onto every in-process replica (fresh
        #: per-replica token buckets — a quota ``rate`` is therefore
        #: per-replica, so the fleet-wide rate scales with live replicas;
        #: as in the JAX package).  Tenant-aware dispatch composes with
        #: prefix affinity: a batch-tier submission spills off an affine
        #: replica whose snapshot shows interactive requests waiting.
        self._tenants: Dict[str, TenantPolicy] = {}
        for p in (tenants or []):
            if not isinstance(p, TenantPolicy):
                raise ValueError(f"tenants= entries must be TenantPolicy, "
                                 f"got {type(p).__name__}")
            self._tenants[p.name] = p
        for rep in self._replicas:
            if rep.kind == "engine":
                for p in self._tenants.values():
                    rep.engine.register_tenant(p.clone())
        #: the "random" control arm's picks: a host-side routing choice,
        #: not a tensor draw, so it stays numpy's PCG64 from ``seed`` —
        #: the JAX router's generator, hence its pick sequence
        self._rng = np.random.default_rng(self.seed)
        self._live: Dict[int, _RouterRequest] = {}
        #: shared event relay: ONE selector loop pumps every
        #: in-flight stream — engine attachments via handle listeners,
        #: wire attachments via non-blocking reads over the bare-frame
        #: parser.  Threads are spent on failover recovery only, so the
        #: router's thread count is O(concurrent failures), not
        #: O(in-flight requests).  Lazily started on first submit.
        self._relay_loop: Optional[networking.EventLoop] = None
        self._attributions: Dict[int, Tuple[int, int]] = {}
        self._next_id = 0
        self._started = False
        self._draining = False
        #: router-level terminal accounting (replica counters double-count
        #: a resubmitted request — every attempt is a submission
        #: somewhere, but it is ONE client request) plus routing/fleet
        #: observables
        self.counters: Dict[str, int] = {
            "requests_submitted": 0, "requests_completed": 0,
            "requests_failed": 0, "requests_rejected": 0,
            "requests_cancelled": 0, "requests_expired": 0,
            "resubmissions": 0, "affinity_routed": 0,
            "affinity_spills": 0, "tenant_spills": 0,
            "generation_swaps": 0,
            "scale_ups": 0, "scale_downs": 0,
        }

    # ------------------------------------------------------------ lifecycle
    def warmup(self) -> "ServingRouter":
        for rep in self._engine_replicas():
            rep.engine.warmup()
        return self

    def start(self) -> "ServingRouter":
        with self._lock:
            self._started = True
        for rep in self._engine_replicas():
            rep.engine.start()
        return self

    def stop(self, join_timeout: float = 10.0) -> None:
        with self._lock:
            self._started = False
            threads = [r.thread for r in self._live.values()]
            reps = list(self._replicas)
        for rep in reps:
            if rep.kind == "engine":
                rep.engine.stop(join_timeout=join_timeout)
        deadline = time.monotonic() + join_timeout  # shared bound: N parked
        for t in threads:                           # relays cost one timeout,
            if t is not None:                       # not N of them
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._ev_wait_idle(max(0.0, deadline - time.monotonic()))
        for rep in reps:
            rep.close()
        with self._lock:
            loop, self._relay_loop = self._relay_loop, None
        if loop is not None:
            loop.stop(join_timeout=max(0.5, deadline - time.monotonic()))
        self._pool.close()

    def _ev_wait_idle(self, timeout: float) -> None:
        """Bounded wait for loop-owned relays (in-flight requests with no
        failover thread to join) to retire: stopping/draining the engines
        makes their upstream handles terminal, and the shared loop pumps
        those final laps out asynchronously."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                busy = any(r.thread is None for r in self._live.values())
            if not busy or time.monotonic() >= deadline:
                return
            time.sleep(0.005)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful fleet drain: stop admission at the router, drain every
        in-process replica (queued + running requests finish; a drain
        timeout fails the stragglers typed, which the relays then
        resubmit nowhere — admission is closed — so they fail to the
        client typed too), then join the relay threads.  Wire replicas
        belong to another process and are not drained here."""
        with self._lock:
            self._draining = True
            reps = [r for r in self._replicas if r.kind == "engine"]
        clean = all([rep.engine.drain(timeout=timeout) for rep in reps])
        with self._lock:
            threads = [r.thread for r in self._live.values()]
        for t in threads:
            if t is not None:
                t.join(timeout=5.0)
        self._ev_wait_idle(5.0)
        return clean

    def __enter__(self) -> "ServingRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _engine_replicas(self) -> List[_EngineReplica]:
        with self._lock:
            return [r for r in self._replicas if r.kind == "engine"]

    # ------------------------------------------------------------- routing
    def _route_key(self, prompt: np.ndarray) -> Optional[bytes]:
        """The affinity hash input: the prompt's leading FULL paged blocks
        (at most ``affinity_blocks`` of them), under the trie's own
        boundary rule — matchable tokens are capped at ``p_len - 1``, so
        a prompt that cannot share even one full block routes by load
        instead of pinning a cold hash."""
        bs = self.block_size
        n = min(self.affinity_blocks, (len(prompt) - 1) // bs)
        if n <= 0:
            return None
        return np.asarray(prompt[:n * bs], "<i4").tobytes()

    @staticmethod
    def _score(load: Dict[str, Any]) -> int:
        return int(load.get("queue_depth", 0)) + int(load.get("active", 0))

    @staticmethod
    def _should_spill(affine: Dict[str, Any],
                      least: Dict[str, Any]) -> bool:
        """The affinity escape hatch: spill when the affine replica has no
        free slot AND its queue runs more than one full slot pool deeper
        than the least-loaded replica's — mild skew stays affine (that is
        the point of the warm trie), saturation does not."""
        return (int(affine.get("slots_free", 0)) == 0
                and int(affine.get("queue_depth", 0))
                > int(least.get("queue_depth", 0))
                + int(affine.get("slots_total", 1)))

    def _candidates(self) -> List[Tuple[Any, Dict[str, Any]]]:
        """Live routable replicas with their current load snapshots —
        draining/dead/unreachable ones are excluded (load probes run
        OUTSIDE the router lock; they may block on a wire round-trip)."""
        with self._lock:
            reps = [r for r in self._replicas if not r.draining]
        out = []
        for rep in reps:
            load = rep.load()
            if load.get("dead") or load.get("draining"):
                continue
            out.append((rep, load))
        return out

    def _tier_of(self, tenant: Optional[str]) -> str:
        pol = self._tenants.get("default" if tenant is None
                                else str(tenant))
        return "batch" if pol is None else pol.tier

    def _dispatch_order(self, prompt: np.ndarray,
                        tenant: Optional[str] = None
                        ) -> List[Tuple[Any, Dict[str, Any]]]:
        """Replicas in preference order for one admission attempt: the
        policy's pick first, the rest by ascending load (the fallback
        chain a full/refusing replica hands over to).  Tenant-aware QoS
        rides on top of prefix affinity: a BATCH-tier submission spills
        off an affine replica whose snapshot shows interactive requests
        queued — warm-trie reuse is not worth feeding the replica more
        preemption victims while its interactive tier is backlogged
        (interactive submissions keep their affinity; they are what the
        backlog drains into)."""
        cands = self._candidates()
        if not cands:
            raise EngineDead("no live serving replica in the fleet")
        by_load = sorted(cands, key=lambda rl: self._score(rl[1]))
        if self.affinity == "random":
            with self._lock:  # Generator state is not thread-safe
                i = int(self._rng.integers(len(cands)))
            pick = cands[i]
            rest = [rl for rl in by_load if rl[0] is not pick[0]]
            return [pick] + rest
        if self.affinity == "prefix":
            key = self._route_key(prompt)
            if key is not None:
                # rendezvous hashing: stable per (key, replica uid), so
                # membership changes only remap groups whose replica left
                pick = max(cands, key=lambda rl: zlib.crc32(
                    key + rl[0].uid.to_bytes(4, "little")))
                least = by_load[0]
                spill = None
                if (pick[0] is not least[0]
                        and self._should_spill(pick[1], least[1])):
                    spill = "affinity_spills"
                elif (pick[0] is not least[0]
                      and self._tier_of(tenant) == "batch"
                      and int(pick[1].get("queued_interactive", 0)) > 0):
                    spill = "tenant_spills"
                if spill is not None:
                    with self._lock:
                        self.counters[spill] += 1
                else:
                    with self._lock:
                        self.counters["affinity_routed"] += 1
                    rest = [rl for rl in by_load if rl[0] is not pick[0]]
                    return [pick] + rest
        return by_load

    # ----------------------------------------------------------- admission
    def submit(self, prompt, num_steps: int, block: bool = True,
               timeout: Optional[float] = None, **kw) -> RequestHandle:
        """Unified-engine ``submit`` surface over the fleet: route, admit
        on the chosen replica (falling back across refusals), and return
        a proxy handle whose stream relays the replica's tokens.  Typed
        rejections propagate exactly like a bare engine's: with every
        replica full, ``block=True`` keeps retrying admission until
        ``timeout`` then raises :class:`QueueFull`; ``block=False``
        raises immediately."""
        prompt = _host_prompt(prompt)
        with self._lock:
            if self._draining:
                self.counters["requests_rejected"] += 1
                raise Draining("serving router is draining; admission "
                               "stopped")
            self._next_id += 1
            rid = self._next_id
        proxy = RequestHandle(
            rid, prompt, int(num_steps),
            float(kw.get("temperature", 0.0)), kw.get("top_k"),
            kw.get("top_p"), kw.get("eos_id"), kw.get("pad_id"),
            None, deadline_s=kw.get("deadline_s"))
        rec = _RouterRequest(proxy, dict(kw))
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            try:
                self._admit_once(rec)
                break
            except QueueFull:
                with self._lock:
                    draining = self._draining
                if (not block or draining
                        or (deadline is not None
                            and time.monotonic() >= deadline)):
                    with self._lock:
                        self.counters["requests_rejected"] += 1
                    raise
                time.sleep(self.poll_s)
            except (Draining, EngineDead, ValueError):
                with self._lock:
                    self.counters["requests_rejected"] += 1
                raise
        with self._lock:
            self._live[proxy.id] = rec
            self.counters["requests_submitted"] += 1
        self._ev_watch(rec)
        return proxy

    def _admit_once(self, rec: _RouterRequest) -> None:
        """One admission attempt: walk the dispatch order until a replica
        accepts.  Raises the LAST typed refusal when every replica
        refused (so a fleet-wide backpressure surfaces as
        :class:`QueueFull`, a fleet-wide drain as :class:`Draining`)."""
        proxy = rec.proxy
        last: Optional[BaseException] = None
        for rep, _load in self._dispatch_order(proxy.prompt,
                                               rec.kw.get("tenant")):
            try:
                self._attach(rec, rep)
                return
            except (QueueFull, Draining, EngineDead) as e:
                last = e
        raise last if last is not None else EngineDead(
            "no live serving replica in the fleet")

    def _attach(self, rec: _RouterRequest, rep) -> None:
        """Admit ``rec`` on ``rep`` (non-blocking — a full replica refuses
        and the dispatch order moves on) and point the attachment +
        cancel relay at it.  The request keeps its ORIGINAL sampling
        seed on every attach: that is what makes a resubmitted stream
        bit-identical."""
        proxy = rec.proxy
        sub = dict(rec.kw)
        sub.pop("block", None)
        sub.pop("timeout", None)
        if rep.kind == "engine":
            h = rep.engine.submit(proxy.prompt, proxy.num_steps,
                                  block=False, **sub)
            with self._lock:
                rec.replica, rec.upstream = rep, h
                rec.client = rec.rid = None
                rec.attached = (rep.uid, rep.generation)
                rec.cancel_fn = (lambda e=rep.engine, hh=h: e.cancel(hh))
                rep.routed += 1
                if rec.cancelled:
                    rec.cancel_fn()
            return
        client = self._pool.acquire(rep.addr)
        try:
            rid = client.submit(proxy.prompt, proxy.num_steps, **sub)
        except (ConnectionError, OSError) as e:
            self._pool.discard(client)
            raise EngineDead(f"replica {rep.uid} at {rep.addr} "
                             f"unreachable: {e!r}") from e
        except (QueueFull, Draining, EngineDead, ValueError):
            self._pool.release(rep.addr, client)  # typed refusal: the
            raise                                 # transport is intact
        with self._lock:
            rec.replica, rec.client, rec.rid = rep, client, rid
            rec.upstream = None
            rec.attached = (rep.uid, rep.generation)
            rec.cancel_fn = (lambda c=client, r=rid:
                             c.cancel(r, await_ack=False))
            rep.routed += 1
            if rec.cancelled:
                rec.cancel_fn()

    # -------------------------------------------------------------- relays
    #
    # Steady state rides the shared event loop: an engine attachment's
    # handle listener wakes the loop per progress transition and the loop
    # pumps ``next_chunk(timeout=0)`` into the proxy; a wire attachment's
    # socket goes non-blocking and the loop decodes reply frames off a
    # bare-frame parser.  Only a LOST attachment spends a thread: the
    # failover thread re-runs the blocking resubmit+stream path under
    # ``retry_policy`` — the exact recovery contract the per-request
    # relay threads implemented, at O(failures) threads instead of
    # O(requests).

    def _ev_loop(self) -> networking.EventLoop:
        with self._lock:
            loop = self._relay_loop
            if loop is None or not loop.alive:
                loop = networking.EventLoop(name="dkt-router-relay")
                loop.start()
                self._relay_loop = loop
            return loop

    def _ev_watch(self, rec: _RouterRequest) -> None:
        """Hook a freshly-admitted request onto the shared relay."""
        loop = self._ev_loop()
        if rec.upstream is not None:
            h = rec.upstream
            h.set_listener(lambda: loop.call_soon(
                lambda: self._ev_pump_engine(rec, h)))
            # catch-up pump: progress that predates the listener
            loop.call_soon(lambda: self._ev_pump_engine(rec, h))
        else:
            loop.call_soon(lambda: self._ev_wire_begin(rec))

    def _ev_pump_engine(self, rec: _RouterRequest, h) -> None:
        """Loop-side engine relay: drain whatever the upstream handle has
        ready (never blocks), replaying nothing — this path only ever
        runs on a request's FIRST attachment, so the proxy is exactly
        ``rec.relayed`` tokens behind the upstream."""
        if rec.upstream is not h:
            return  # stale wake: the request failed over elsewhere
        while True:
            chunk, done = h.next_chunk(timeout=0)
            for t in chunk:
                rec.proxy._push(int(t))
                rec.relayed += 1
            if done:
                h.set_listener(None)
                rec.upstream = None  # claim the terminal transition: a
                # second queued pump (the listener fires per transition)
                # must not fail the same request over twice
                err = h.error
                if err is None:
                    self._retire(rec, finish=h.finish)
                elif isinstance(err, _REPLICA_LOST):
                    self._ev_failover(rec)  # EngineDead → resubmit
                elif isinstance(err, ValueError):
                    self._retire(rec, error=err)
                else:
                    self._retire(rec, error=EngineDead(str(err)))
                return
            if not len(chunk):
                return  # drained; the listener wakes us on more

    def _ev_wire_begin(self, rec: _RouterRequest) -> None:
        """Loop-side wire relay start: send the stream request, flip the
        pooled client's socket non-blocking, and register it — reply
        frames (no opcode byte) decode off a bare-frame parser."""
        client = rec.client
        try:
            networking.send_opcode(client.sock,
                                   networking.SERVING_OP_STREAM)
            networking.send_data(client.sock, {"id": int(rec.rid)},
                                 pool=client._send_pool)
            client.sock.setblocking(False)
        except (ConnectionError, OSError):
            self._pool.discard(client)
            self._ev_failover(rec)
            return
        with self._lock:
            loop = self._relay_loop
        if loop is None:  # stop() raced the registration
            self._pool.discard(client)
            return
        parser = networking.FrameParser(frame_ops=None)
        scratch = networking.BufferPool()
        loop.add(client.sock,
                 lambda mask: self._ev_wire_read(rec, parser, scratch))

    def _ev_wire_read(self, rec: _RouterRequest, parser, scratch) -> None:
        sock = rec.client.sock
        while True:
            target = parser.writable()
            fed_scratch = target is None
            if fed_scratch:
                target = memoryview(scratch.get(_RELAY_RECV_CHUNK))
            try:
                n = sock.recv_into(target)
            except (BlockingIOError, InterruptedError):
                return
            except (ConnectionError, OSError):
                self._ev_wire_lost(rec)
                return
            if not n:
                self._ev_wire_lost(rec)  # EOF mid-stream = lost replica
                return
            if fed_scratch:
                parser.feed(target[:n])
            else:
                parser.advance(n)
            try:
                for _op, msg in parser.messages():
                    if self._ev_wire_frame(rec, msg):
                        return  # stream detached (done / typed / lost)
            except ValueError:
                self._ev_wire_lost(rec)  # garbage frame = broken wire
                return

    def _ev_wire_frame(self, rec: _RouterRequest, msg) -> bool:
        """One reply frame, mirroring ``ServingClient.stream`` +
        ``_stream_wire``'s verdicts.  Returns True when the socket left
        the loop (stream over, typed death, or protocol error)."""
        if msg.get("error"):
            kind = msg.get("kind")
            if kind in ("engine_dead", "stall"):
                # typed death: the transport is intact, the engine
                # behind it is not — keep the connection, fail over
                self._ev_wire_detach(rec, keep=True)
                self._ev_failover(rec)
            else:
                self._ev_wire_detach(rec, keep=False)
                self._retire(rec, error=ValueError(str(msg["error"])))
            return True
        for t in msg["tokens"]:
            rec.proxy._push(int(t))
            rec.relayed += 1
        if msg["done"]:
            self._ev_wire_detach(rec, keep=True)
            self._retire(rec, finish=msg["finish"])
            return True
        return False

    def _ev_wire_detach(self, rec: _RouterRequest, keep: bool) -> None:
        """Unregister the wire attachment's socket; ``keep`` re-parks the
        client for reuse (socket back to blocking), else it is torn
        down."""
        client, rep = rec.client, rec.replica
        with self._lock:
            loop = self._relay_loop
        if loop is not None:
            loop.remove(client.sock)
        if keep:
            try:
                client.sock.setblocking(True)
            except OSError:
                keep = False
        if keep:
            self._pool.release(rep.addr, client)
        else:
            self._pool.discard(client)

    def _ev_wire_lost(self, rec: _RouterRequest) -> None:
        self._ev_wire_detach(rec, keep=False)
        self._ev_failover(rec)

    def _ev_failover(self, rec: _RouterRequest) -> None:
        """The attachment is gone (typed death or broken wire).  Retire a
        cancelled request; otherwise hand recovery to a transient thread
        — resubmission blocks (admission retries, backoff, a full
        re-stream with replay-skip), which must not stall the loop the
        OTHER N-1 streams are riding."""
        if rec.cancelled:
            self._retire(rec, finish="cancel")
            return
        t = threading.Thread(
            target=self._failover_relay, args=(rec,), daemon=True,
            name=f"dkt-router-failover-{rec.proxy.id}")
        with self._lock:
            rec.thread = t  # stop()/drain() join it like the old relays
        t.start()

    def _failover_relay(self, rec: _RouterRequest) -> None:
        """Failover thread: resubmit elsewhere under ``retry_policy`` —
        the ONE retry machinery ``ServingClient.generate`` also runs on —
        replaying the already-delivered prefix silently."""
        try:
            self.retry_policy.call(lambda: self._resubmit_once(rec),
                                   retry_on=_RESUBMIT_RETRY_ON)
        except _RESUBMIT_RETRY_ON as e:
            self._retire(rec, error=e if isinstance(e, EngineDead)
                         else EngineDead(f"request {rec.proxy.id}: every "
                                         f"resubmission failed ({e!r})"))
        except ValueError as e:
            self._retire(rec, error=e)

    def _resubmit_once(self, rec: _RouterRequest) -> None:
        """One failover attempt: re-route (the dead replica's load
        snapshot excludes it), re-admit with the original seed, and
        stream — skipping the ``rec.relayed`` tokens the client already
        has."""
        if rec.cancelled:
            self._retire(rec, finish="cancel")
            return
        self._admit_once(rec)
        with self._lock:
            self.counters["resubmissions"] += 1
        rec.resubmits += 1
        self._stream_once(rec)

    def _stream_once(self, rec: _RouterRequest) -> None:
        if rec.upstream is not None:
            self._stream_engine(rec)
        else:
            self._stream_wire(rec)

    def _stream_engine(self, rec: _RouterRequest) -> None:
        proxy, h = rec.proxy, rec.upstream
        skip = rec.relayed
        while True:
            chunk, done = h.next_chunk(timeout=self.poll_s)
            for t in chunk:
                if skip > 0:
                    skip -= 1
                    continue
                proxy._push(int(t))
                rec.relayed += 1
            if done:
                if h.error is not None:
                    raise h.error  # EngineDead → failover upstream
                self._retire(rec, finish=h.finish)
                return

    def _stream_wire(self, rec: _RouterRequest) -> None:
        proxy, rep = rec.proxy, rec.replica
        client, rid = rec.client, rec.rid
        skip = rec.relayed
        try:
            for tokens, done in client.stream(rid):
                for t in tokens:
                    if skip > 0:
                        skip -= 1
                        continue
                    proxy._push(int(t))
                    rec.relayed += 1
                if done is not None:
                    self._pool.release(rep.addr, client)
                    self._retire(rec, finish=done["finish"])
                    return
            raise ConnectionError("stream ended without a done frame")
        except EngineDead:
            # typed death frame: the transport is intact, the engine
            # behind it is not — keep the connection, fail over
            self._pool.release(rep.addr, client)
            raise
        except (ConnectionError, OSError):
            self._pool.discard(client)
            raise

    def _retire(self, rec: _RouterRequest, finish: Optional[str] = None,
                error: Optional[BaseException] = None) -> None:
        """Make the proxy terminal exactly once, book the router-level
        counter for its reason, and record the final ``(replica uid,
        generation)`` attribution."""
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
            if rec.attached is not None:
                self._attributions[proxy.id] = rec.attached
            self._live.pop(proxy.id, None)

    # ------------------------------------------------------------- controls
    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a proxy handle wherever its request currently lives.
        Returns False if it already finished."""
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
                pass  # replica gone: its death path retires the proxy
        return True

    def replace_engine(self, old: ServingEngine,
                       new: ServingEngine) -> None:
        """Swap a respawned engine into the fleet and bump the replica's
        generation (the ``resilience.FleetSupervisor`` restart seam and
        ``rolling_swap``'s per-replica move).  In-flight requests on the
        old engine fail through its death/drain path and resubmit."""
        with self._lock:
            for rep in self._replicas:
                if rep.kind == "engine" and rep.engine is old:
                    rep.engine = new
                    rep.generation += 1
                    self.counters["generation_swaps"] += 1
                    return
        raise ValueError("engine to replace is not part of this fleet")

    def rolling_swap(self, drain_timeout: Optional[float] = 10.0) -> int:
        """Fleet-wide blue/green under live traffic: per in-process
        replica, build its successor (``respawn_clone``, the atomic
        generation-swap recipe), warm it (on a card: capture its decode
        graph while the other replicas serve), start it, swap it in (new
        admissions land on the successor from that instant), then drain
        the predecessor so its in-flight requests finish on the
        generation that accepted them.  One replica at a time — N−1
        replicas serve throughout.  Returns the number of replicas
        swapped; dead replicas are skipped (the supervisor owns those)."""
        swapped = 0
        for rep in self._engine_replicas():
            old = rep.engine
            if old.dead is not None:
                continue
            new = old.respawn_clone()
            new.warmup()
            with self._lock:
                started = self._started
            if started:
                new.start()
            self.replace_engine(old, new)
            old.drain(timeout=drain_timeout)
            swapped += 1
        return swapped

    # ----------------------------------------------------------- elasticity
    def scale_up(self) -> int:
        """Add one in-process replica through ``engine_factory`` (warmed,
        and started if the router is running).  Returns its uid."""
        if self.engine_factory is None:
            raise ValueError("scale_up needs engine_factory=")
        eng = self.engine_factory()
        for p in self._tenants.values():  # fleet QoS reaches new capacity
            eng.register_tenant(p.clone())
        eng.warmup()
        with self._lock:
            started = self._started
        if started:
            eng.start()
        with self._lock:
            rep = _EngineReplica(self._next_uid, eng)
            self._next_uid += 1
            self._replicas.append(rep)
            self.counters["scale_ups"] += 1
        return rep.uid

    def scale_down(self, uid: Optional[int] = None,
                   timeout: Optional[float] = 10.0) -> Optional[int]:
        """Drain one in-process replica out of the fleet: mark it
        draining (routing excludes it immediately), ``drain()`` it so
        queued + running requests finish — a drain timeout fails the
        stragglers typed and the relays resubmit them to the surviving
        replicas — then remove it.  ``uid=None`` picks the least-loaded
        replica.  Refuses (returns None) at ``min_replicas`` or when no
        in-process replica matches."""
        with self._lock:
            cands = [r for r in self._replicas
                     if r.kind == "engine" and not r.draining]
            if len([r for r in self._replicas if not r.draining]) \
                    <= self.min_replicas:
                return None
            if uid is not None:
                cands = [r for r in cands if r.uid == uid]
            if not cands:
                return None
            rep = min(cands, key=lambda r: self._score(r.engine.load()))
            rep.draining = True
        rep.engine.drain(timeout=timeout)
        with self._lock:
            if rep in self._replicas:
                self._replicas.remove(rep)
            self.counters["scale_downs"] += 1
        return rep.uid

    def autoscale_tick(self) -> Optional[str]:
        """One queue-depth-driven elasticity decision: mean queue depth
        across live replicas above ``scale_up_queue`` grows the fleet
        (bounded by ``max_replicas``); an entirely idle fleet (zero
        queued, zero active anywhere) shrinks it (bounded by
        ``min_replicas``).  Returns ``"up"``/``"down"``/None.  Call it
        from whatever cadence owns capacity — a loadgen loop, a cron, a
        supervisor thread."""
        cands = self._candidates()
        if not cands:
            return None
        loads = [l for _, l in cands]
        total_q = sum(int(l.get("queue_depth", 0)) for l in loads)
        total_active = sum(int(l.get("active", 0)) for l in loads)
        n = len(loads)
        if (total_q / n > self.scale_up_queue and n < self.max_replicas
                and self.engine_factory is not None):
            self.scale_up()
            return "up"
        if (total_q == 0 and total_active == 0 and n > self.min_replicas
                and any(r.kind == "engine" for r, _ in cands)):
            if self.scale_down(timeout=10.0) is not None:
                return "down"
        return None

    # ------------------------------------------------------------ telemetry
    def generation_of(self, handle: RequestHandle
                      ) -> Optional[Tuple[int, int]]:
        """The ``(replica uid, generation)`` that produced (or currently
        owns) this request — every response is attributable to exactly
        one generation (the blue/green audit surface)."""
        with self._lock:
            rec = self._live.get(handle.id)
            if rec is not None and rec.proxy is handle:
                return rec.attached
            return self._attributions.get(handle.id)

    def fleet_snapshot(self) -> List[Dict[str, Any]]:
        """One dict per replica: identity (uid/kind/generation/draining),
        the routed-request count, and the current load snapshot — the
        observability surface loadgen's per-replica skew report reads."""
        with self._lock:
            reps = list(self._replicas)
        out = []
        for rep in reps:
            load = rep.load()
            with self._lock:
                out.append({"uid": rep.uid, "kind": rep.kind,
                            "generation": rep.generation,
                            "draining": rep.draining,
                            "routed": rep.routed, "load": load})
        return out

    @property
    def engines(self) -> List[ServingEngine]:
        """The in-process replica engines (the ``FleetSupervisor`` and
        swap surface; wire replicas' engines live elsewhere)."""
        with self._lock:
            return [r.engine for r in self._replicas
                    if r.kind == "engine"]

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len([r for r in self._replicas if not r.draining])

    @property
    def stats(self) -> Dict[str, Any]:
        """Merged IN-PROCESS engine stats (numeric counters summed,
        sample lists concatenated — wire replicas report to their own
        process) with the request-level terminal counters OVERRIDDEN by
        the router's own: a resubmitted request is one client request,
        not one per attempt.  A number that one replica has not produced
        yet (``None``, e.g. ``prefill_batch_size_mean`` before its first
        batched prefill) counts as absent: the JAX router's sum raises
        ``TypeError`` when such a replica comes first."""
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
                    prev = merged.get(k)
                    merged[k] = v if prev is None else prev + v
        with self._lock:
            merged.update(self.counters)
        return merged

    @property
    def kv_blocks_in_use(self) -> Optional[int]:
        """Summed across in-process replicas — the fleet-level zero-leak
        assertion surface."""
        vals = [e.kv_blocks_in_use for e in self.engines]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    @property
    def slot_occupancy(self) -> Optional[float]:
        """Mean occupancy across in-process replicas (None until any
        replica has decoded)."""
        vals = [e.slot_occupancy for e in self.engines]
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None

    @property
    def queue_depth(self) -> int:
        return sum(e.queue_depth for e in self.engines)

    @property
    def max_len(self) -> int:
        lens = [e.max_len for e in self.engines]
        with self._lock:
            wire = [r for r in self._replicas if r.kind == "wire"]
        for rep in wire:
            ml = rep.load().get("max_len")
            if ml:
                lens.append(int(ml))
        return min(lens) if lens else 0

    @property
    def dead(self) -> Optional[BaseException]:
        """None while ANY replica is routable; the first dead replica's
        error once the whole fleet is gone (a single dead replica is a
        failover event, not a router death)."""
        first: Optional[BaseException] = None
        for e in self.engines:
            if e.dead is None:
                return None
            first = first or e.dead
        with self._lock:
            has_wire = any(r.kind == "wire" for r in self._replicas)
        if has_wire:
            return None  # remote liveness is the probe's to report
        return first
