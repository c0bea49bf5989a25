"""Retry policy and the serving supervisors, copied from
``distkeras_tpu/resilience.py`` and kept in the port so that it imports
nothing of the JAX package.

Copied: ``RetryPolicy`` with ``DEFAULT_CONNECT_POLICY`` and
``DEFAULT_RECOVERY_POLICY``; the serving-engine supervisor
``EngineSupervisor``, the ``_PairSlot`` swap seam, ``PairSupervisor``
(every engine of a ``serving.DisaggPair``) and ``FleetSupervisor`` (every
in-process replica of a ``router.ServingRouter``).  ``serving.py`` builds
its ``DEFAULT_RELOAD_POLICY`` from ``RetryPolicy`` at import, as the JAX
package's does.  The supervisors are host code over the engines' failure
surface (``dead``, ``last_beat``, ``declare_dead``, ``respawn_clone``,
``warmup``, ``start``); a restarted clone is warmed, which on a CUDA card
captures its decode graph, before it goes live.

Copied for the host parameter server: ``RETRYABLE_CONNECT``, ``dial``
(the workers' connect under a ``RetryPolicy``), ``wire_heartbeat`` (one
``'h'`` probe of a PS address; the port's ``wire_probe`` under it also
returns the server's generation and clock) and ``Partitioned``; the survivable
servers' ``ShardJournal`` (atomic per-shard npz snapshots through the
port's ``checkpoint.Checkpointer``, in the JAX journal's layout:
``shard_<jjj>/ckpt_<n>.npz`` with the same meta keys, so a snapshot
written by either package restores in the other) and ``ShardSupervisor``
(heartbeat liveness through the apply lock, same-address respawn from
the last snapshot with the generation bumped); and the elastic workers'
``Lease``, ``LeaseLedger`` (window-aligned leases, EWMA deadlines,
exactly-once completion: call for call the JAX ledger) and
``WorkerSupervisor`` (death and wedge detection, respawn under fresh
ids; its death and respawn rules, ``_RespawnRules``, are shared with
the process supervisor below).  Copied for the cross-process engine
(``execution="process_ps"``): the lease rail, ``LeaseServer`` (the
ledger behind the framed dict protocol over the port's ``networking``
codec; acquire and renew stamp each worker's wire heartbeat) and
``LeaseClient`` (the ledger's worker surface over the wire, so
``workers.PSWorker.train_leases`` drives it unchanged: a blocking
``acquire``, re-dials under ``DEFAULT_RECOVERY_POLICY``), and
``ProcessSupervisor`` (waitpid deaths and heartbeat freezes of worker
processes, their leases revoked and a replacement spawned under a fresh
id through the ``job_deployment.Job`` rail; PS shard processes probed
and respawned at the same address within a grace window).  The frames
are the JAX package's, so a port client works against a JAX lease
server and back.  All of it is host code: numpy and the standard
library.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import shutil
import socket
import tempfile
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple)

import numpy as np

from . import networking

logger = logging.getLogger("distkeras_tpu_torch.resilience")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """One retry contract for every connect/reconnect path.

    ``attempts`` tries with exponential backoff (``backoff * 2**i`` capped at
    ``max_backoff``), each delay stretched by a uniform random factor in
    ``[1, 1+jitter]`` so a fleet of workers re-dialing a restarted shard
    doesn't arrive in lockstep.  ``attempts=None`` retries until ``deadline``
    (total wall-clock seconds) expires; at least one of the two bounds must
    be set.  ``seed`` pins the jitter stream for deterministic tests; the
    default ``None`` gives every instance its own stream — exactly what
    de-synchronizes the herd.
    """

    attempts: Optional[int] = 10
    backoff: float = 0.05
    max_backoff: float = 2.0
    jitter: float = 0.5
    deadline: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.attempts is None and self.deadline is None:
            raise ValueError(
                "RetryPolicy needs at least one bound: attempts or deadline")
        if self.attempts is not None and int(self.attempts) < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")

    def replace(self, **kw) -> "RetryPolicy":
        return dataclasses.replace(self, **kw)

    def delays(self) -> Iterator[float]:
        """The jittered backoff sequence (one delay per retry)."""
        rng = random.Random(self.seed)
        i = 0
        while self.attempts is None or i < int(self.attempts):
            d = min(self.backoff * (2.0 ** i), self.max_backoff)
            if self.jitter:
                d *= 1.0 + self.jitter * rng.random()
            yield d
            i += 1

    def call(self, fn: Callable[[], Any], retry_on: tuple) -> Any:
        """Run ``fn`` under this policy; re-raises the last exception once
        both bounds (attempts and deadline) are exhausted."""
        t0 = time.monotonic()
        last: Optional[BaseException] = None
        for d in self.delays():
            try:
                return fn()
            except retry_on as e:
                last = e
                if (self.deadline is not None
                        and time.monotonic() - t0 + d > self.deadline):
                    break
                time.sleep(d)
        raise last  # type: ignore[misc]

    def call_reconnecting(self, fn: Callable[[], Any],
                          reconnect: Callable[[], None],
                          retry_on: tuple,
                          reconnect_on: tuple = (ConnectionError,
                                                 OSError)) -> Any:
        """:meth:`call`, with a transport-repair step between attempts:
        when ``fn`` raises one of ``reconnect_on``, ``reconnect()`` runs
        best-effort (its own ``OSError`` is swallowed — the endpoint may
        still be down, and the policy's backoff covers the wait) before
        the failure re-enters the retry loop.  Idempotent only because
        serving requests are deterministic in their seed, so callers must
        not use it for non-seeded effects."""
        def attempt() -> Any:
            try:
                return fn()
            except reconnect_on:
                try:
                    reconnect()
                except OSError:
                    pass  # endpoint still down: keep backing off
                raise
        return self.call(attempt, retry_on=retry_on)

    def describe(self) -> str:
        if self.attempts is not None:
            return str(int(self.attempts))
        return f"{self.deadline:g}s of"


#: connect() default — 10 tries, ~9 s worst case, with jitter
#: (herd-avoidance: sleeps only get longer by <= 50%, and no caller
#: depends on exact sleep lengths).
DEFAULT_CONNECT_POLICY = RetryPolicy(attempts=10, backoff=0.05)

#: reconnect-resume default: retry for up to the recovery deadline — a
#: supervisor needs detection (~1 heartbeat deadline) + restore + rebind
#: before the address answers again.
DEFAULT_RECOVERY_POLICY = RetryPolicy(attempts=None, backoff=0.05,
                                      max_backoff=0.5, deadline=15.0)


#: transport faults a (re)dial retries: nothing listening yet, a reset
#: from a PS mid-start, or a stalled handshake
RETRYABLE_CONNECT = (ConnectionRefusedError, ConnectionResetError,
                     socket.timeout)


def dial(host: str, port: int, policy: RetryPolicy) -> socket.socket:
    """Dial under ``policy``; raises the last transport fault when the
    policy is exhausted (callers wrap it in their own error type)."""
    return policy.call(lambda: networking.connect(host, port),
                       RETRYABLE_CONNECT)


def wire_probe(host: str, port: int, timeout: float = 1.0
               ) -> Optional[Tuple[int, int]]:
    """One ``'h'`` probe against a PS address: its (generation, clock), or
    None unless it answers with a clock within ``timeout``.  Any transport
    fault, stall, or garbage reply is a failed probe.  The heartbeat
    handler runs through the server's apply lock, so a server wedged
    inside an apply fails this even though its process is alive."""
    try:
        sock = networking.connect(host, port, timeout=timeout)
    except (ConnectionError, OSError, socket.timeout):
        return None
    try:
        sock.settimeout(timeout)
        networking.send_opcode(sock, b"h")
        msg = networking.recv_data(sock)
        networking.send_opcode(sock, b"q")
        if not (isinstance(msg, dict) and "clock" in msg):
            return None
        return int(msg.get("gen") or 0), int(msg["clock"])
    except (ConnectionError, OSError, ValueError, socket.timeout):
        return None
    finally:
        try:
            sock.close()
        except OSError:
            pass


def wire_heartbeat(host: str, port: int, timeout: float = 1.0) -> bool:
    """True iff one :func:`wire_probe` of the address answers in time."""
    return wire_probe(host, port, timeout) is not None


class Partitioned(ConnectionError):
    """A worker's PS link is network-partitioned past its tolerance.

    Typed apart from ``ps_sharding.PSShardDown``: a partition means the
    *path* to a (probably healthy) PS is gone — the worker buffered
    ``pending_windows`` windows of committed mass locally and exhausted its
    heal budget — whereas ``PSShardDown`` means the endpoint itself is
    unrecovered.  Supervisors treat the two differently: a partitioned
    worker's PS must NOT be respawned (its state is fine; respawning it
    would drop post-snapshot windows for nothing)."""

    def __init__(self, addr=None, detail: str = "",
                 pending_windows: int = 0):
        self.addr = tuple(addr) if addr is not None else None
        self.pending_windows = int(pending_windows)
        where = f" to {addr[0]}:{addr[1]}" if addr else ""
        msg = f"PS link{where} partitioned"
        if pending_windows:
            msg += f" with {pending_windows} pending window(s) buffered"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


# ---------------------------------------------------------------------------
# per-shard snapshot journal
# ---------------------------------------------------------------------------

class ShardJournal:
    """Atomic per-shard snapshots of (center slice, update clock).

    One ``Checkpointer`` directory per shard (``shard_<j>/ckpt_<n>.npz`` —
    tempfile + ``os.replace``, so a crash mid-write never corrupts the last
    good snapshot), with retention.  The snapshot *is* the recovery contract:
    a respawned shard resumes from exactly this state and every window
    committed after it is dropped.
    """

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = directory
        self.max_to_keep = int(max_to_keep)
        os.makedirs(directory, exist_ok=True)
        self._ckpts: Dict[int, Any] = {}

    def _ckpt(self, shard_id: int):
        ck = self._ckpts.get(shard_id)
        if ck is None:
            from .checkpoint import Checkpointer
            ck = Checkpointer(
                os.path.join(self.directory, f"shard_{int(shard_id):03d}"),
                max_to_keep=self.max_to_keep)
            self._ckpts[shard_id] = ck
        return ck

    def save(self, shard_id: int, snap_id: int,
             center: List[np.ndarray], clock: int, generation: int) -> str:
        center = [np.asarray(w, np.float32) for w in center]
        state = {"center": center, "clock": np.int64(clock)}
        meta = {"shard": int(shard_id), "generation": int(generation),
                "clock": int(clock),
                "shapes": [list(w.shape) for w in center]}
        return self._ckpt(shard_id).save(int(snap_id), state, meta=meta)

    def latest(self, shard_id: int) -> Optional[Dict[str, Any]]:
        """The newest snapshot for ``shard_id`` as
        ``{"center", "clock", "generation", "snap_id"}``, or None."""
        ck = self._ckpt(shard_id)
        step = ck.latest_step()
        if step is None:
            return None
        meta = ck.read_meta(step)
        target = {"center": [np.zeros(tuple(s), np.float32)
                             for s in meta["shapes"]],
                  "clock": np.int64(0)}
        restored = ck.restore(target, step)
        return {"center": [np.asarray(w, np.float32)
                           for w in restored["center"]],
                "clock": int(restored["clock"]),
                "generation": int(meta.get("generation", 0)),
                "snap_id": step}


# ---------------------------------------------------------------------------
# the shard supervisor
# ---------------------------------------------------------------------------

class ShardSupervisor:
    """Detect-and-respawn loop over a ``ShardedServerGroup``.

    Liveness has two layers: the accept thread must be running (a crashed
    shard fails this instantly), and a ``'h'`` heartbeat must answer within
    ``liveness_deadline`` — the heartbeat handler takes the shard's **apply
    lock**, so a shard wedged inside an apply (deadlocked rule, stuck numpy
    op) fails the probe even though its process is "alive".

    On detection the shard is respawned **on the same address** with the
    last journal snapshot restored and ``generation`` bumped; reconnecting
    workers learn the new generation from their first reply, and the shard
    rejects any in-flight commit still stamped with the old generation
    (``parameter_servers.SocketParameterServer`` — the epoch/generation
    handshake).  ``recoveries`` records one entry per respawn for
    observability (tests + ``bench.py``'s ``host_ps_recovery_ms``).
    """

    def __init__(self, group, algorithm: str, num_workers: int,
                 snapshot_dir: Optional[str] = None,
                 heartbeat_interval: float = 0.2,
                 liveness_deadline: float = 1.0,
                 snapshot_interval: float = 0.25,
                 max_restarts: int = 20):
        self.group = group
        self.algorithm = algorithm
        self.num_workers = int(num_workers)
        self.heartbeat_interval = float(heartbeat_interval)
        self.liveness_deadline = float(liveness_deadline)
        self.snapshot_interval = float(snapshot_interval)
        self.max_restarts = int(max_restarts)
        self._own_dir = snapshot_dir is None
        if snapshot_dir is None:
            snapshot_dir = tempfile.mkdtemp(prefix="dkt_ps_journal_")
        self.journal = ShardJournal(snapshot_dir)
        n = group.num_shards
        self._snap_ids = [0] * n
        self.restarts = [0] * n
        #: one dict per respawn: shard, generation, restored_clock,
        #: dropped_updates (in-memory clock minus restored clock — the
        #: bounded loss this restart cost), respawn_ms
        self.recoveries: List[Dict[str, Any]] = []
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # guards: recoveries (and serializes respawn_shard bodies vs. chaos hooks)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Snapshot every shard once (a kill before the first periodic tick
        must restore *initial* state, not nothing), then start the loop."""
        for j in range(self.group.num_shards):
            self.snapshot_shard(j)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dkt-ps-supervisor")
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._own_dir:
            shutil.rmtree(self.journal.directory, ignore_errors=True)

    # -- snapshots -----------------------------------------------------------
    def snapshot_shard(self, j: int,
                       lock_timeout: Optional[float] = None) -> bool:
        """Journal shard ``j``'s (center slice, clock) under its apply lock.

        The lock is taken with a TIMEOUT (default: the liveness deadline):
        a *wedged* shard holds its apply lock forever, and a supervisor
        that blocked here could never reach the detection that cures the
        wedge.  A timed-out snapshot returns False and leaves the previous
        snapshot as the recovery point — consistent with the bounded-loss
        contract either way."""
        s = self.group.servers[j]
        timeout = (self.liveness_deadline if lock_timeout is None
                   else float(lock_timeout))
        if not s.ps._lock.acquire(timeout=timeout):
            return False  # wedged: heartbeat detection owns this case
        try:
            center = [w.copy() for w in s.ps.center]
            clock = s.ps.num_updates
        finally:
            s.ps._lock.release()
        self._snap_ids[j] += 1
        self.journal.save(j, self._snap_ids[j], center, clock, s.generation)
        return True

    # -- liveness ------------------------------------------------------------
    def heartbeat(self, j: int, timeout: Optional[float] = None) -> bool:
        """One ``'h'`` probe against shard ``j``: True iff it answers with a
        clock within ``timeout``.  Any transport fault, stall, or garbage
        reply is a failed probe."""
        timeout = self.liveness_deadline if timeout is None else timeout
        s = self.group.servers[j]
        return wire_heartbeat(s.host, s.port, timeout=timeout)

    def kill_shard(self, j: int):
        """Chaos/bench hook: crash-stop shard ``j`` (no graceful shutdown,
        in-memory state abandoned) — the signature of a SIGKILLed shard
        process.  The supervisor loop detects and respawns it."""
        self.group.servers[j].crash()

    # -- respawn -------------------------------------------------------------
    def respawn_shard(self, j: int) -> Dict[str, Any]:
        """Stop whatever is left of shard ``j``, restore its last snapshot,
        and re-listen on the same address with ``generation + 1``.  The
        replacement is a ``respawn_clone`` of the dead server, so the PS
        core (event/threaded) and its coalescing/apply-kernel knobs survive
        the restart."""
        from .parameter_servers import allocate_parameter_server
        with self._lock:
            t0 = time.monotonic()
            old = self.group.servers[j]
            # in-memory clock at death (best effort) — the observable for
            # the bounded-loss contract: dropped = died_at - restored
            died_at = int(old.ps.num_updates)
            old.stop(join_timeout=0.5)  # leaked wedged threads are logged
            snap = self.journal.latest(j)
            if snap is None:  # start() always journals one; belt-and-braces
                raise RuntimeError(f"no snapshot for shard {j}")
            ps = allocate_parameter_server(
                self.algorithm,
                {"model": self.group.model_blob["model"],
                 "weights": snap["center"]},
                self.num_workers,
                apply_kernel=getattr(old.ps, "apply_kernel", None))
            ps.num_updates = int(snap["clock"])
            new = old.respawn_clone(ps)
            last: Optional[BaseException] = None
            for d in (0.05, 0.1, 0.2, 0.4, 0.8):
                try:
                    new.start()
                    last = None
                    break
                except OSError as e:  # port not released yet
                    last = e
                    time.sleep(d)
            if last is not None:
                new.start()  # final attempt: a persistent bind error is loud
            self.group.servers[j] = new
            rec = {"shard": j, "generation": new.generation,
                   "restored_clock": int(snap["clock"]),
                   "dropped_updates": max(died_at - int(snap["clock"]), 0),
                   "respawn_ms": round((time.monotonic() - t0) * 1e3, 1)}
            self.recoveries.append(rec)
            logger.warning(
                "PS shard %d respawned at %s:%d (generation %d, restored "
                "clock %d, %d post-snapshot updates dropped)", j, new.host,
                new.port, new.generation, rec["restored_clock"],
                rec["dropped_updates"])
            return rec

    # -- the loop ------------------------------------------------------------
    def _loop(self):
        last_snap = time.monotonic()
        while self._running:
            time.sleep(self.heartbeat_interval)
            if not self._running:
                return
            for j in range(self.group.num_shards):
                if not self._running:
                    return
                s = self.group.servers[j]
                dead = not (s._running and s._accept_thread is not None
                            and s._accept_thread.is_alive())
                if not dead:
                    dead = not self.heartbeat(j)
                if dead and self._running:
                    if self.restarts[j] >= self.max_restarts:
                        continue  # crash loop: leave it to PSShardDown
                    self.restarts[j] += 1
                    try:
                        self.respawn_shard(j)
                    except Exception:
                        logger.exception("respawn of PS shard %d failed", j)
            if (self._running
                    and time.monotonic() - last_snap >= self.snapshot_interval):
                last_snap = time.monotonic()
                for j in range(self.group.num_shards):
                    s = self.group.servers[j]
                    if not s._running:
                        continue  # dead shard: its journal must stay put
                    try:
                        self.snapshot_shard(j)
                    except Exception:
                        logger.exception("snapshot of PS shard %d failed", j)


# ---------------------------------------------------------------------------
# the serving-engine supervisor
# ---------------------------------------------------------------------------

class EngineSupervisor:
    """Detect-and-restart loop over a serving engine: a crashed OR wedged
    decode loop must fail loudly and be replaceable, not hang every
    ``handle.result()`` waiter.

    Liveness has two layers:

     - **crash** — the decode-loop thread died.  A loop that raised
       declares the engine dead itself (every in-flight handle fails with
       a typed ``EngineDead``); the supervisor's job is the restart.
     - **wedge** — the thread is alive but its heartbeat
       (``engine.last_beat``, stamped once per scheduler iteration, idle
       iterations included) is older than ``liveness_deadline``: the loop
       is stuck inside a step (a hung device transfer or launch).  The
       supervisor declares the engine dead — failing the in-flight
       handles the wedged loop never will — and restarts.

    The restart is ``engine.respawn_clone()``: same model weights and
    knobs, fresh KV slot pool, empty queue.  When supervising a
    ``ServingServer`` the server is re-pointed at the replacement
    (``server.engine = new``), so new submissions land on the fresh
    engine while ``ServingClient.generate(retry_policy=...)`` resubmits
    the failed ones (deterministic seeds make the retry idempotent).
    A restart swaps the ENGINE behind the server; live connections, the
    event loop or handler threads, and the listening socket are
    untouched.  ``recoveries`` records one entry per detection (with
    ``restarted`` and ``recovery_ms``), ``max_restarts`` bounds the
    budget.

    ``target`` is a ``ServingServer`` (its ``.engine`` attribute is
    watched and swapped) or a bare started ``ServingEngine`` (the
    replacement is reachable as ``supervisor.engine``).  Inline engines
    (never ``start()``-ed) have no loop to supervise.

    ``liveness_deadline`` must exceed the engine's worst-case single
    scheduler iteration.  Respawned clones are ``warmup()``-ed here
    before going live — on a CUDA card that captures the clone's decode
    graph and runs every prefill program once — so neither the capture
    nor a first call reads as a fresh wedge; supervise a fresh engine
    tightly only after ``engine.warmup()``.  ``recovery_ms`` includes
    that warm-up.
    """

    def __init__(self, target, heartbeat_interval: float = 0.1,
                 liveness_deadline: float = 2.0, max_restarts: int = 3,
                 restart: bool = True):
        self.target = target
        self.heartbeat_interval = float(heartbeat_interval)
        self.liveness_deadline = float(liveness_deadline)
        self.max_restarts = int(max_restarts)
        self.restart = bool(restart)
        self.restarts = 0
        #: one dict per detection: reason ("crashed"/"wedged"),
        #: requests_failed at detection, restarted, recovery_ms
        self.recoveries: List[Dict[str, Any]] = []
        self._seen: set = set()  # id()s of engines already handled
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    @property
    def engine(self):
        return getattr(self.target, "engine", self.target)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "EngineSupervisor":
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dkt-serving-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "EngineSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- detection -----------------------------------------------------------
    def check(self) -> Optional[str]:
        """One liveness probe of the current engine: None when healthy (or
        not running a loop), else ``"crashed"`` / ``"wedged"``."""
        eng = self.engine
        if eng.dead is not None:
            return "crashed"
        thread = eng._thread
        if thread is None:
            return None  # inline or cleanly stopped: nothing to supervise
        if not thread.is_alive():
            # the loop exited without declaring death or clearing _thread:
            # a transient stop() window — re-probe next tick
            return "crashed" if eng.dead is not None else None
        if time.monotonic() - eng.last_beat > self.liveness_deadline:
            return "wedged"
        return None

    # -- recovery ------------------------------------------------------------
    def _recover(self, reason: str) -> Dict[str, Any]:
        with self._lock:
            eng = self.engine
            if id(eng) in self._seen:
                return {}
            self._seen.add(id(eng))
            t0 = time.monotonic()
            eng.declare_dead(
                f"serving engine {reason}: decode loop "
                f"{'raised' if reason == 'crashed' else 'missed its heartbeat'}"
                f" (supervised restart "
                f"{self.restarts}/{self.max_restarts})")
            rec: Dict[str, Any] = {
                "reason": reason, "restarted": False,
                "requests_failed": int(eng.stats["requests_failed"]),
            }
            if self.restart and self.restarts < self.max_restarts:
                new = eng.respawn_clone()
                new.warmup()  # capture BEFORE going live: a cold first
                new.start()   # step must not read as a fresh wedge
                if self.target is eng:
                    self.target = new
                else:
                    self.target.engine = new
                self.restarts += 1
                rec["restarted"] = True
                rec["recovery_ms"] = round(
                    (time.monotonic() - t0) * 1e3, 1)
            self.recoveries.append(rec)
            logger.warning(
                "serving engine %s; %d in-flight request(s) failed with "
                "EngineDead%s", reason, rec["requests_failed"],
                (", replacement engine started" if rec["restarted"]
                 else ", no restart (budget spent or restart=False)"))
            return rec

    # -- the loop ------------------------------------------------------------
    def _loop(self) -> None:
        while self._running:
            time.sleep(self.heartbeat_interval)
            if not self._running:
                return
            reason = self.check()
            if reason is not None:
                try:
                    self._recover(reason)
                except Exception:
                    logger.exception("serving engine restart failed")


class _PairSlot:
    """Adapter giving :class:`EngineSupervisor` its ``target.engine``
    swap seam over ONE engine inside a ``serving.DisaggPair`` (or a
    ``router.ServingRouter``): the setter routes through
    ``replace_engine`` so the owner's hand-off or routing state tracks
    the replacement atomically."""

    __slots__ = ("_pair", "_engine")

    def __init__(self, pair, engine):
        self._pair = pair
        self._engine = engine

    @property
    def engine(self):
        return self._engine

    @engine.setter
    def engine(self, new):
        self._pair.replace_engine(self._engine, new)
        self._engine = new


class _SupervisorGroup:
    """The synchronous probe/recover surface and lifecycle shared by
    :class:`PairSupervisor` and :class:`FleetSupervisor` over their
    ``supervisors`` list."""

    supervisors: List[EngineSupervisor]

    @property
    def restarts(self) -> int:
        return sum(s.restarts for s in self.supervisors)

    @property
    def recoveries(self) -> List[Dict[str, Any]]:
        return [r for s in self.supervisors for r in s.recoveries]

    def check_all(self) -> List[Optional[str]]:
        """One synchronous liveness probe per supervised engine (the
        loop-free form tests drive)."""
        return [s.check() for s in self.supervisors]

    def recover_all(self) -> List[Dict[str, Any]]:
        """Probe + recover every unhealthy engine once, synchronously."""
        out = []
        for s in self.supervisors:
            reason = s.check()
            if reason is not None:
                out.append(s._recover(reason))
        return out

    def start(self):
        for s in self.supervisors:
            s.start()
        return self

    def stop(self) -> None:
        for s in self.supervisors:
            s.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class PairSupervisor(_SupervisorGroup):
    """Supervise every engine of a disaggregated ``serving.DisaggPair`` —
    one :class:`EngineSupervisor` per prefill engine and (for in-process
    pairs) the decode engine, each restarting through ``respawn_clone``
    and swapping the replacement into the pair via ``replace_engine``.

    The division of labor mirrors the pair's failure matrix: a dead
    prefill engine's in-flight requests re-route THROUGH THE PAIR to the
    surviving prefill engines while the supervisor restores capacity in
    the background; a dead decode engine fails its requests with the
    typed ``EngineDead`` (clients resubmit — all live KV state died with
    the arena) and the supervisor brings up a fresh decode engine for
    subsequent traffic."""

    def __init__(self, pair, **supervisor_kw):
        self.pair = pair
        self.supervisors = [EngineSupervisor(_PairSlot(pair, e),
                                             **supervisor_kw)
                            for e in pair.engines]


class FleetSupervisor(_SupervisorGroup):
    """Supervise every in-process replica of a ``router.ServingRouter`` —
    one :class:`EngineSupervisor` per replica engine, each restarting
    through ``respawn_clone`` and swapping the replacement into the fleet
    via the router's ``replace_engine`` (the same ``_PairSlot`` seam the
    disaggregated pair uses: the router rebinds the replica and bumps its
    generation atomically under its own lock).

    The failure story is the router's: while a replica is down its
    in-flight requests are already being resubmitted to surviving
    replicas (typed ``EngineDead`` + seeded resubmission — zero accepted
    requests lost), so this supervisor restores CAPACITY, not
    correctness.  Wire replicas (remote addresses) are not supervised
    here — their engines live in another process behind their own
    supervisor.

    Elastic fleets change membership; call :meth:`refresh` after
    ``scale_up``/``scale_down`` so supervision tracks the current
    replica set."""

    def __init__(self, router, **supervisor_kw):
        self.router = router
        self._kw = supervisor_kw
        self._running = False
        self.supervisors = []
        self.refresh()

    def refresh(self) -> "FleetSupervisor":
        """Re-sync supervision with the router's CURRENT in-process
        replica set: new replicas gain a supervisor (started if the
        fleet supervisor is running), removed replicas' supervisors are
        stopped and dropped.  Identity is the engine object — a swapped
        replacement is already tracked via its slot's setter."""
        current = {id(s.target.engine): s for s in self.supervisors}
        keep: List[EngineSupervisor] = []
        live_ids = set()
        for eng in self.router.engines:
            live_ids.add(id(eng))
            sup = current.get(id(eng))
            if sup is None:
                sup = EngineSupervisor(_PairSlot(self.router, eng),
                                       **self._kw)
                if self._running:
                    sup.start()
            keep.append(sup)
        for sup in self.supervisors:
            if id(sup.target.engine) not in live_ids and sup not in keep:
                sup.stop()
        self.supervisors = keep
        return self

    def start(self) -> "FleetSupervisor":
        self._running = True
        return super().start()

    def stop(self) -> None:
        self._running = False
        super().stop()


# ---------------------------------------------------------------------------
# elastic workers: the lease ledger
# ---------------------------------------------------------------------------

class Lease(NamedTuple):
    """One window-aligned slice of an epoch's (already shuffled) row range.

    ``[start, stop)`` indexes the epoch's shuffled arrays; ``windows`` is the
    number of communication windows the slice shapes into (the tail window is
    wrap-padded and masked by the worker's shaping, the same zero-drop
    contract as the static shards)."""

    lease_id: int
    epoch: int
    start: int
    stop: int
    windows: int


class LeaseLedger:
    """Exactly-once lease accounting for elastic workers (one per run).

    Per epoch, ``begin_epoch`` tiles the row range into leases of
    ``lease_windows`` communication windows each (``rows_per_window`` rows
    per window; the last lease takes the remainder).  Workers ``acquire`` a
    lease, ``renew`` it once per committed window (the heartbeat — it rides
    the commit cadence, no extra RPC), and ``complete`` it; a lease whose
    deadline passes without a renewal is revoked back to the pool by
    ``revoke_expired`` for another worker to steal, and ``revoke_worker``
    returns a dead worker's holdings.

    **Exactly-once**: a lease transitions ``held → done`` at most once, and
    a ``renew``/``complete`` from a worker the lease was revoked from
    returns ``False`` (the straggler abandons; the stealer's completion is
    the one recorded).  ``assert_epoch_complete`` is the zero-data-loss
    check: every lease of the epoch completed by exactly one worker, rows
    summing to the full dataset.

    **Deadlines** adapt per worker: each renewal feeds a per-worker
    window-rate EWMA; a lease's deadline is ``slack`` × the holder's
    expected time for its remaining windows (cross-worker mean for workers
    with no history yet), floored by ``min_deadline`` — so a wedged worker
    is detected on its own measured pace, while a merely-slow worker keeps
    renewing and is never falsely revoked.

    All methods are thread-safe under one internal lock; ``clock`` is
    injectable for deterministic tests.
    """

    def __init__(self, num_rows: int, rows_per_window: int,
                 lease_windows: int = 1, min_deadline: float = 5.0,
                 slack: float = 4.0,
                 default_window_s: Optional[float] = None,
                 clock=time.monotonic):
        self.num_rows = int(num_rows)
        self.rows_per_window = max(int(rows_per_window), 1)
        self.lease_windows = max(int(lease_windows), 1)
        self.min_deadline = float(min_deadline)
        self.slack = float(slack)
        #: per-window seconds to assume before ANY renewal exists (cold
        #: start): the trainer seeds it with the measured warmup window
        #: (deliberately generous — it includes the compile — times the
        #: worker count for contention); None falls back to min_deadline
        self.default_window_s = (None if default_window_s is None
                                 else float(default_window_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._next_rows: Optional[int] = None  # resize(), applied at begin
        self.epoch: Optional[int] = None
        self.leases: List[Lease] = []
        self._state: Dict[int, Dict[str, Any]] = {}
        #: per-worker windows/sec EWMA (the straggler-detection baseline)
        self.rates: Dict[int, float] = {}
        self._last_beat: Dict[int, float] = {}
        #: epoch -> {lease_id: completing worker id} (exactly-once record)
        self.completions: Dict[int, Dict[int, int]] = {}
        #: leases revoked (expiry or holder death) and returned to the pool
        self.reassigned = 0
        #: windows completed per worker id, across epochs (diagnosability)
        self.windows_by_worker: Dict[int, int] = {}

    # -- epoch lifecycle -----------------------------------------------------
    def resize(self, num_rows: int) -> None:
        """Set the row count the NEXT ``begin_epoch`` tiles (the streaming
        horizon loop: each horizon re-leases however many rows the stream
        delivered — the tail horizon is smaller, nothing else changes).
        Takes effect at the next ``begin_epoch``; the running epoch's
        leases and its ``assert_epoch_complete`` target are untouched."""
        with self._lock:
            self._next_rows = int(num_rows)

    def begin_epoch(self, epoch: int) -> List[Lease]:
        """(Re)tile the row range into pending leases for ``epoch``."""
        with self._lock:
            if self._next_rows is not None:
                self.num_rows = self._next_rows
                self._next_rows = None
            self.epoch = int(epoch)
            rows_per_lease = self.rows_per_window * self.lease_windows
            self.leases = []
            self._state = {}
            start, lid = 0, 0
            while start < self.num_rows:
                stop = min(start + rows_per_lease, self.num_rows)
                wins = -(-(stop - start) // self.rows_per_window)
                self.leases.append(Lease(lid, self.epoch, start, stop, wins))
                self._state[lid] = {"status": "pending", "holder": None,
                                    "deadline": None, "done": 0}
                lid += 1
                start = stop
            self.completions.setdefault(self.epoch, {})
            return list(self.leases)

    def epoch_done(self) -> bool:
        with self._lock:
            return all(st["status"] == "done" for st in self._state.values())

    def pending(self) -> int:
        """Leases not yet done (pending or held)."""
        with self._lock:
            return sum(1 for st in self._state.values()
                       if st["status"] != "done")

    # -- deadline math (lock held) -------------------------------------------
    def _per_window_locked(self, worker: int) -> Optional[float]:
        rate = self.rates.get(worker)
        if rate is None and self.rates:
            rate = sum(self.rates.values()) / len(self.rates)
        if rate:
            return 1.0 / rate
        return self.default_window_s  # cold start: the warmup-seeded guess

    def _deadline_locked(self, worker: int, windows_left: int,
                         now: float) -> float:
        per = self._per_window_locked(worker)
        if per is None:
            return now + self.min_deadline
        return now + max(self.min_deadline,
                         self.slack * per * max(int(windows_left), 1))

    # -- the worker-facing protocol ------------------------------------------
    def acquire(self, worker: int) -> Optional[Lease]:
        """Claim the lowest-id pending lease, or None when nothing is left
        to hand out (held leases may still revert via revocation)."""
        worker = int(worker)
        now = self._clock()
        with self._lock:
            for lease in self.leases:
                st = self._state[lease.lease_id]
                if st["status"] == "pending":
                    st.update(status="held", holder=worker, done=0,
                              deadline=self._deadline_locked(
                                  worker, lease.windows, now))
                    self._last_beat[worker] = now
                    return lease
        return None

    def renew(self, lease_id: int, worker: int) -> bool:
        """One completed window's heartbeat.  False means the lease was
        revoked from this worker (stolen) — abandon the rest of it."""
        worker = int(worker)
        now = self._clock()
        with self._lock:
            st = self._state.get(int(lease_id))
            if st is None or st["status"] != "held" \
                    or st["holder"] != worker:
                return False
            lb = self._last_beat.get(worker)
            if lb is not None and now > lb:
                inst = 1.0 / max(now - lb, 1e-9)
                old = self.rates.get(worker)
                self.rates[worker] = (inst if old is None
                                      else 0.5 * old + 0.5 * inst)
            self._last_beat[worker] = now
            st["done"] += 1
            self.windows_by_worker[worker] = (
                self.windows_by_worker.get(worker, 0) + 1)
            lease = self.leases[int(lease_id)]
            st["deadline"] = self._deadline_locked(
                worker, lease.windows - st["done"], now)
            return True

    def complete(self, lease_id: int, worker: int) -> bool:
        """Mark a lease done.  Recorded at most once per lease per epoch;
        False if the lease was revoked from this worker meanwhile."""
        worker = int(worker)
        with self._lock:
            st = self._state.get(int(lease_id))
            if st is None or st["status"] != "held" \
                    or st["holder"] != worker:
                return False
            st.update(status="done", deadline=None)
            self.completions[self.epoch][int(lease_id)] = worker
            return True

    # -- the supervisor-facing protocol --------------------------------------
    def revoke_expired(self) -> List[Tuple[Lease, int]]:
        """Return held leases past their deadline to the pool; yields
        ``(lease, former holder)`` per revocation."""
        now = self._clock()
        out: List[Tuple[Lease, int]] = []
        with self._lock:
            for lease in self.leases:
                st = self._state[lease.lease_id]
                if (st["status"] == "held" and st["deadline"] is not None
                        and now > st["deadline"]):
                    out.append((lease, st["holder"]))
                    st.update(status="pending", holder=None, deadline=None,
                              done=0)
                    self.reassigned += 1
        return out

    def revoke_worker(self, worker: int) -> int:
        """Return every lease a (dead) worker holds to the pool."""
        worker = int(worker)
        n = 0
        with self._lock:
            for st in self._state.values():
                if st["status"] == "held" and st["holder"] == worker:
                    st.update(status="pending", holder=None, deadline=None,
                              done=0)
                    self.reassigned += 1
                    n += 1
        return n

    # -- the contract --------------------------------------------------------
    def epoch_report(self, epoch: int) -> Dict[str, Any]:
        with self._lock:
            done = dict(self.completions.get(int(epoch), {}))
            leases = [l for l in self.leases if l.epoch == int(epoch)]
            rows = sum(l.stop - l.start for l in leases
                       if l.lease_id in done)
            return {"leases": len(leases), "completed": len(done),
                    "rows_completed": rows, "by_worker": done}

    def assert_epoch_complete(self, epoch: int) -> Dict[str, Any]:
        """The zero-data-loss contract: every lease of ``epoch`` completed
        exactly once (``completions`` is keyed by lease id, so at-most-once
        holds by construction; this checks at-least-once and row coverage).
        """
        rep = self.epoch_report(epoch)
        if rep["completed"] != rep["leases"] \
                or rep["rows_completed"] != self.num_rows:
            missing = [l.lease_id for l in self.leases
                       if l.lease_id not in rep["by_worker"]]
            raise RuntimeError(
                f"epoch {epoch} lease ledger incomplete: "
                f"{rep['completed']}/{rep['leases']} leases done, "
                f"{rep['rows_completed']}/{self.num_rows} rows covered "
                f"(missing leases {missing})")
        return rep


# ---------------------------------------------------------------------------
# elastic workers: the supervisor
# ---------------------------------------------------------------------------

class _RespawnRules:
    """The death-and-respawn rules that :class:`WorkerSupervisor` (worker
    threads) and :class:`ProcessSupervisor` (worker processes) share: a
    dead worker leaves the active set, its first failure note and death
    time are kept, its leases go back to the pool, and while the epoch
    still has work a replacement starts under a fresh id (at most
    ``max_respawns`` in all), with its recovery time recorded.  A
    subclass says how a worker starts (``_spawn``)."""

    #: how the log names a worker
    _KIND = "elastic worker"

    def _spawn(self, wid: int) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _note_death(self, wid: int, note: str) -> None:
        """First cause wins (a worker's own unwind may race the
        supervisor's diagnosis)."""
        self.failures.setdefault(wid, note)
        self.death_times.setdefault(wid, time.monotonic())

    def _death_time(self, wid: int) -> Optional[float]:
        return self.death_times.get(wid)

    def _respawn(self, died: int, reason: str) -> Optional[int]:
        if self.respawns >= self.max_respawns:
            return None
        nid = self._next_id
        self._next_id += 1
        self._spawn(nid)
        self.active.add(nid)
        self.respawns += 1
        t_death = self._death_time(died)
        rec = {"died": died, "replacement": nid, "reason": reason,
               "recovery_ms": (round((time.monotonic() - t_death) * 1e3, 1)
                               if t_death is not None else None)}
        self.respawn_records.append(rec)
        self.events.append({"kind": "respawn", **rec})
        logger.warning("%s %d %s; respawned as worker %d", self._KIND,
                       died, reason, nid)
        return nid

    def _declare_dead(self, wid: int, note: str, reason: str) -> None:
        self.active.discard(wid)
        self._note_death(wid, note)
        self.ledger.revoke_worker(wid)
        self.events.append({"kind": "death", "worker": wid,
                            "reason": reason})
        if not self.ledger.epoch_done():
            self._respawn(wid, reason)


class WorkerSupervisor(_RespawnRules):
    """Detect-and-respawn loop over elastic worker threads.

    ``factory(worker_id)`` builds a worker object; ``run_fn(worker_id,
    worker)`` runs its lease loop (``workers.PSWorker.train_leases``) and
    returns its result dict.  Per epoch the supervisor starts one thread per
    active worker id and polls until the ledger's epoch is done:

     - a thread that raised (``RuntimeError`` from an injected fault, a
       transport error, ``SystemExit`` from an 'exit' fault — any
       ``BaseException``) is a **death**: its leases are revoked and a
       replacement worker is spawned under a fresh id (``max_respawns``
       bounds the total).  ``PSShardDown`` and ``KeyboardInterrupt`` are
       not worker deaths and re-raise.
     - a lease that expires while its holder thread is still alive is a
       **wedge** (hung device, stuck commit): the lease returns to the pool
       (stolen by survivors), the holder is declared failed, and a
       replacement is spawned.  The wedged thread itself is left to unblock
       on teardown (``release_hung``).
     - if every active thread has finished but leases remain (e.g. all
       still-pending work was revoked after the pool drained), a finished
       worker is restarted — the epoch always converges or fails loudly.

    Respawned workers start from a fresh center pull (state ``None``), the
    same bounded-staleness class as any late-joining async worker.
    """

    def __init__(self, ledger: LeaseLedger, factory, run_fn,
                 num_workers: int, poll_interval: float = 0.02,
                 max_respawns: Optional[int] = None,
                 join_timeout: float = 10.0):
        self.ledger = ledger
        self.factory = factory
        self.run_fn = run_fn
        self.num_workers = int(num_workers)
        self.poll_interval = float(poll_interval)
        self.max_respawns = (2 * self.num_workers if max_respawns is None
                             else int(max_respawns))
        self.join_timeout = float(join_timeout)
        self._lock = threading.Lock()
        self.workers: Dict[int, Any] = {}
        self.states: Dict[int, Any] = {}  # worker id -> carried train state
        self._threads: Dict[int, threading.Thread] = {}
        self.active: set = set()
        self.results: Dict[int, Any] = {}
        self.errors: Dict[int, BaseException] = {}
        self.failures: Dict[int, str] = {}  # worker id -> traceback / note
        self.death_times: Dict[int, float] = {}
        self._next_id = self.num_workers
        self.respawns = 0
        #: one dict per respawn: died, replacement, reason, recovery_ms
        self.respawn_records: List[Dict[str, Any]] = []
        #: resilience event log (revocations, deaths, respawns) for metrics
        self.events: List[Dict[str, Any]] = []
        for wid in range(self.num_workers):
            self.workers[wid] = factory(wid)
            self.active.add(wid)

    # -- threads -------------------------------------------------------------
    def _thread_main(self, wid: int):
        try:
            res = self.run_fn(wid, self.workers[wid])
            with self._lock:
                self.results[wid] = res
        except BaseException as e:  # SystemExit ('exit' faults) included
            import traceback
            with self._lock:
                self.errors.setdefault(wid, e)
                # first cause wins: a wedge-declared worker's eventual
                # unwind (e.g. a released 'hang') must not overwrite the
                # supervisor's diagnosis
                self.failures.setdefault(wid, "".join(
                    traceback.format_exception(e)).strip())
                self.death_times.setdefault(wid, time.monotonic())
            self.ledger.revoke_worker(wid)

    def _start(self, wid: int):
        t = threading.Thread(target=self._thread_main, args=(wid,),
                             daemon=True, name=f"dkt-elastic-{wid}")
        self._threads[wid] = t
        t.start()

    def _alive(self, wid: int) -> bool:
        t = self._threads.get(wid)
        return t is not None and t.is_alive()

    def _spawn(self, wid: int) -> None:
        self.workers[wid] = self.factory(wid)
        self._start(wid)

    def _note_death(self, wid: int, note: str) -> None:
        with self._lock:
            # the worker's own unwind path setdefaults the same keys from
            # its thread (_thread_main)
            super()._note_death(wid, note)

    def _death_time(self, wid: int) -> Optional[float]:
        with self._lock:  # written from the worker threads too
            return super()._death_time(wid)

    # -- the per-epoch loop ----------------------------------------------------
    def run_epoch(self, epoch: int):
        """Drive one epoch of the ledger to completion (or raise)."""
        self.ledger.begin_epoch(epoch)
        for wid in sorted(self.active):
            if not self._alive(wid):
                self._start(wid)
        while not self.ledger.epoch_done():
            # wedge/straggler detection: expired leases return to the pool;
            # a holder whose thread is still alive is wedged, not dead
            for lease, holder in self.ledger.revoke_expired():
                self.events.append({"kind": "lease_revoked", "epoch": epoch,
                                    "lease": lease.lease_id,
                                    "worker": holder})
                if holder in self.active and self._alive(holder):
                    self._declare_dead(
                        holder,
                        f"wedged: lease {lease.lease_id} deadline expired "
                        f"with no renewal (epoch {epoch})",
                        reason="wedged")
            # deaths: threads that raised out of their lease loop (error and
            # note captured under the lock so a racing worker unwind cannot
            # tear the pair)
            with self._lock:
                dead = [(w, self.errors[w], self.failures[w])
                        for w in sorted(self.active) if w in self.errors]
            for wid, err, note in dead:
                if isinstance(err, KeyboardInterrupt):
                    raise err
                from .ps_sharding import PSShardDown
                if isinstance(err, PSShardDown):
                    raise err  # a lost center partition is not a worker death
                self._declare_dead(wid, note, reason="died")
            # liveness: leases remain but nobody is working on them
            if not self.ledger.epoch_done() \
                    and not any(self._alive(w) for w in self.active):
                with self._lock:
                    restartable = [w for w in sorted(self.active)
                                   if w in self.results]
                if restartable:
                    # finished workers rejoin to drain revoked leases
                    self._start(restartable[0])
                elif self._respawn(-1, "worker pool drained") is None:
                    last = None
                    with self._lock:
                        if self.errors:
                            last = list(self.errors.values())[-1]
                    raise RuntimeError(
                        f"all elastic workers failed with {self.respawns} "
                        f"respawns spent (max_respawns="
                        f"{self.max_respawns})") from last
            time.sleep(self.poll_interval)
        for wid in sorted(self.active):
            t = self._threads.get(wid)
            if t is not None:
                t.join(timeout=self.join_timeout)

    def release_hung(self):
        """Unblock workers wedged on an injected 'hang' fault (teardown)."""
        for w in self.workers.values():
            ev = getattr(w, "_hang_released", None)
            if ev is not None:
                ev.set()

    def shutdown(self):
        self.release_hung()
        for t in self._threads.values():
            t.join(timeout=1.0)


# ---------------------------------------------------------------------------
# cross-process elastic workers: the lease wire rail
# ---------------------------------------------------------------------------

class LeaseServer:
    """Wire front-end for a :class:`LeaseLedger` — the cross-process lease
    rail (``execution='process_ps'`` with ``elastic=True``).

    The in-process elastic engine hands worker threads the ledger object;
    worker *processes* (``ps_worker_main``) instead dial this server and
    speak a tiny framed dict protocol (one request frame → one reply frame
    per op on a persistent connection, same codec as the PS wire)::

        {"op": "epoch", "after": e}                 → {"running"[, "epoch"]}
        {"op": "acquire", "worker": w}              → {"done"} | {"lease"}
        {"op": "renew", "lease": l, "worker": w}    → {"ok"}
        {"op": "complete", "lease": l, "worker": w} → {"ok"}

    ``acquire``/``renew`` double as **wire heartbeats**: each stamps
    ``last_beat[worker]`` — the liveness source :class:`ProcessSupervisor`
    reads (renewals already ride the commit cadence, so a worker's PS
    traffic and its supervisor heartbeat share one clock).  A SIGSTOPped
    worker stops beating here first; waitpid still calls it alive.

    The driver owns the epoch lifecycle: ``open_epoch`` after the ledger's
    ``begin_epoch`` makes the epoch visible to polling workers,
    ``close_epoch`` parks them between epochs, ``finish`` releases them to
    exit (their ``wait_epoch`` returns None).  Exactly-once lease
    accounting stays entirely in the wrapped ledger — this class adds
    transport, never semantics.
    """

    def __init__(self, ledger: LeaseLedger, host: str = "127.0.0.1",
                 port: int = 0):
        self.ledger = ledger
        self.host = host
        self.port = int(port)
        #: worker id → monotonic time of its last acquire/renew frame
        self.last_beat: Dict[int, float] = {}
        self.requests = 0
        self._epoch: Optional[int] = None
        self._finished = False
        self._lock = threading.Lock()  # guards: last_beat, _epoch, _finished, requests
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False

    # -- driver surface ------------------------------------------------------
    def open_epoch(self, epoch: int) -> None:
        with self._lock:
            self._epoch = int(epoch)

    def close_epoch(self) -> None:
        with self._lock:
            self._epoch = None

    def finish(self) -> None:
        """End of run: workers' ``wait_epoch`` returns None and they exit."""
        with self._lock:
            self._epoch = None
            self._finished = True

    def beats(self) -> Dict[int, float]:
        with self._lock:
            return dict(self.last_beat)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "LeaseServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dkt-lease-server")
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._sock is not None:
            try:
                # wakes the accept loop's blocking accept (a close from
                # another thread alone does not, on Linux)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None

    def __enter__(self) -> "LeaseServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # stop() closed the listener
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="dkt-lease-conn").start()

    # -- the protocol --------------------------------------------------------
    def _beat(self, worker: int) -> None:
        with self._lock:
            self.last_beat[int(worker)] = time.monotonic()

    def _dispatch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        with self._lock:
            self.requests += 1
            epoch, finished = self._epoch, self._finished
        if op == "epoch":
            after = msg.get("after")
            rep: Dict[str, Any] = {"running": not finished}
            if epoch is not None and (after is None or epoch > int(after)):
                rep["epoch"] = epoch
            return rep
        if op == "acquire":
            wid = int(msg["worker"])
            self._beat(wid)
            lease = self.ledger.acquire(wid)
            if lease is not None:
                return {"lease": list(lease)}
            return {"done": epoch is None or self.ledger.epoch_done()}
        if op == "renew":
            wid = int(msg["worker"])
            self._beat(wid)
            return {"ok": self.ledger.renew(int(msg["lease"]), wid)}
        if op == "complete":
            return {"ok": self.ledger.complete(int(msg["lease"]),
                                               int(msg["worker"]))}
        return {"error": f"unknown op {op!r}"}

    def _serve(self, conn: socket.socket) -> None:
        try:
            while self._running:
                try:
                    msg = networking.recv_data(conn)
                except (ConnectionError, OSError, ValueError):
                    return  # peer gone (EOF, RST, or torn frame): drop it
                if not isinstance(msg, dict) or msg.get("op") == "quit":
                    return
                try:
                    networking.send_data(conn, self._dispatch(msg))
                except (ConnectionError, OSError):
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass


class LeaseClient:
    """Worker-process twin of the ledger's worker-facing surface —
    duck-typed ``acquire``/``renew``/``complete`` so
    ``workers.PSWorker.train_leases`` drives it unchanged.

    Two contract adaptations for the wire:

     - ``acquire`` **blocks** while the epoch is open but no lease is free:
       a revoked lease (dead/frozen holder) can return to the pool at any
       moment, and an exited process — unlike an in-process thread the
       ``WorkerSupervisor`` can restart — could never come back for it.
       It returns None only once the epoch is done (or closed).
     - transport faults re-dial and re-issue the request under ``policy``
       (default :data:`DEFAULT_RECOVERY_POLICY`).  Every op is safe to
       re-issue: renew/complete are holder-checked by the ledger, and a
       duplicated acquire merely claims a lease whose deadline returns it
       to the pool if the first reply was the one that got lost —
       exactly-once completion holds either way.
    """

    def __init__(self, host: str, port: int, poll_interval: float = 0.05,
                 policy: Optional[RetryPolicy] = None):
        self.host = str(host)
        self.port = int(port)
        self.poll_interval = float(poll_interval)
        self.policy = policy
        self._sock: Optional[socket.socket] = None
        self.resumes = 0

    # -- lifecycle -----------------------------------------------------------
    def connect(self) -> "LeaseClient":
        self._sock = dial(self.host, self.port,
                          self.policy or DEFAULT_CONNECT_POLICY)
        return self

    def close(self) -> None:
        if self._sock is not None:
            try:
                networking.send_data(self._sock, {"op": "quit"})
            except (ConnectionError, OSError):
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self) -> "LeaseClient":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- transport -----------------------------------------------------------
    def _request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        if self._sock is None:
            self.connect()

        def roundtrip() -> Dict[str, Any]:
            networking.send_data(self._sock, msg)
            return networking.recv_data(self._sock)

        try:
            return roundtrip()
        except (ConnectionError, OSError, ValueError) as fault:
            pol = self.policy or DEFAULT_RECOVERY_POLICY
            t0 = time.monotonic()
            last: BaseException = fault
            for d in pol.delays():
                try:
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    self._sock = networking.connect(self.host, self.port)
                    out = roundtrip()
                    self.resumes += 1
                    return out
                except (ConnectionError, OSError, ValueError,
                        socket.timeout) as e:
                    last = e
                    if (pol.deadline is not None
                            and time.monotonic() - t0 + d > pol.deadline):
                        break
                    time.sleep(d)
            raise ConnectionError(
                f"lease server at {self.host}:{self.port} unrecovered after "
                f"{pol.describe()} reconnect attempts") from last

    # -- the ledger surface --------------------------------------------------
    def acquire(self, worker: int) -> Optional[Lease]:
        while True:
            rep = self._request({"op": "acquire", "worker": int(worker)})
            lease = rep.get("lease")
            if lease is not None:
                return Lease(*[int(v) for v in lease])
            if rep.get("done"):
                return None
            time.sleep(self.poll_interval)

    def renew(self, lease_id: int, worker: int) -> bool:
        return bool(self._request({"op": "renew", "lease": int(lease_id),
                                   "worker": int(worker)}).get("ok"))

    def complete(self, lease_id: int, worker: int) -> bool:
        return bool(self._request({"op": "complete", "lease": int(lease_id),
                                   "worker": int(worker)}).get("ok"))

    # -- the epoch loop ------------------------------------------------------
    def wait_epoch(self, after: Optional[int] = None) -> Optional[int]:
        """Block until an epoch newer than ``after`` opens (its number) or
        the run finishes (None)."""
        while True:
            rep = self._request({"op": "epoch", "after": after})
            if "epoch" in rep:
                return int(rep["epoch"])
            if not rep.get("running", False):
                return None
            time.sleep(self.poll_interval)


# ---------------------------------------------------------------------------
# cross-process supervision
# ---------------------------------------------------------------------------

class ProcessSupervisor(_RespawnRules):
    """:class:`WorkerSupervisor`'s detect-and-respawn contract over real OS
    processes (``execution='process_ps'`` with ``elastic=True``).

    **Worker liveness** has two layers: waitpid (``Popen.poll`` — a
    SIGKILLed or crashed worker) and the wire heartbeat its lease traffic
    stamps on the :class:`LeaseServer` (a SIGSTOPped worker is alive by
    waitpid but stops beating — *frozen*).  A dead worker's leases are
    revoked and a replacement spawned through the job runner under a fresh
    id (``spawn_worker(new_id)`` — the replacement re-pulls the live center,
    the same bounded-staleness class as any late joiner).  A frozen worker
    only loses its leases (survivors steal them immediately instead of
    waiting out the lease deadline); the process is left alone — if it
    thaws (SIGCONT) its next renew returns False, it abandons the stolen
    lease, and it rejoins as a healthy member.  Exactly-once completion
    holds across freeze-vs-steal races by the ledger's holder check.

    **PS shard processes** (optional: ``ps_procs``/``ps_addrs``/
    ``respawn_ps``) are probed by waitpid plus the same wire ``'h'``
    heartbeat the in-process :class:`ShardSupervisor` uses; a dead shard is
    respawned **same-address** via ``respawn_ps(j)`` — the fresh process
    restores its :class:`ShardJournal` snapshot from the shared scratch
    directory and bumps its generation itself (``ps_shard_main``), so the
    bounded-loss + generation-handshake contract carries over verbatim.
    Freshly (re)spawned shards get a grace window before probes count
    (a cold interpreter pays its imports, and on a card its CUDA context,
    before it can answer).

    Its death and respawn rules are :class:`WorkerSupervisor`'s
    (``_RespawnRules``); only how a worker starts, and how it is seen to
    die or freeze, differ.

    The driver drives :meth:`run_epoch` per epoch, exactly like
    ``WorkerSupervisor`` — detection is polled inside the epoch wait loop,
    not a background thread, so the loop observes a consistent ledger.
    """

    _KIND = "worker process"

    def __init__(self, ledger: LeaseLedger, lease_server: LeaseServer,
                 spawn_worker: Callable[[int], Any], num_workers: int,
                 poll_interval: float = 0.05,
                 freeze_deadline: Optional[float] = None,
                 max_respawns: Optional[int] = None,
                 ps_procs: Optional[List[Any]] = None,
                 ps_addrs: Optional[List[Tuple[str, int]]] = None,
                 respawn_ps: Optional[Callable[[int], Any]] = None,
                 ps_deadline: float = 2.0, ps_probe_interval: float = 0.5,
                 ps_grace: float = 30.0, max_ps_restarts: int = 20):
        self.ledger = ledger
        self.lease_server = lease_server
        self.spawn_worker = spawn_worker
        self.num_workers = int(num_workers)
        self.poll_interval = float(poll_interval)
        self.freeze_deadline = (None if freeze_deadline is None
                                else float(freeze_deadline))
        self.max_respawns = (2 * self.num_workers if max_respawns is None
                             else int(max_respawns))
        self.procs: Dict[int, Any] = {}
        self.active: set = set()
        self.failures: Dict[int, str] = {}
        self.death_times: Dict[int, float] = {}
        self.respawns = 0
        self.respawn_records: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self._frozen: set = set()
        self._next_id = self.num_workers
        # PS shard process watch (all-or-nothing)
        self.ps_procs = list(ps_procs) if ps_procs else []
        self.ps_addrs = ([(str(h), int(p)) for h, p in ps_addrs]
                         if ps_addrs else [])
        self.respawn_ps = respawn_ps
        self.ps_deadline = float(ps_deadline)
        self.ps_probe_interval = float(ps_probe_interval)
        self.ps_grace = float(ps_grace)
        self.max_ps_restarts = int(max_ps_restarts)
        self.ps_restarts = [0] * len(self.ps_procs)
        self.ps_recoveries: List[Dict[str, Any]] = []
        self._ps_grace_until = [0.0] * len(self.ps_procs)
        self._last_ps_probe = 0.0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ProcessSupervisor":
        for wid in range(self.num_workers):
            self.procs[wid] = self.spawn_worker(wid)
            self.active.add(wid)
        return self

    def shutdown(self, timeout: float = 60.0) -> None:
        """End of run: release workers (they drain, write results, exit 0)
        and reap them; stragglers past ``timeout`` are killed."""
        self.lease_server.finish()
        deadline = time.monotonic() + timeout
        for wid in sorted(self.procs):
            p = self.procs[wid]
            if p.poll() is not None:
                continue
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except Exception:
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except Exception:
                    pass

    # -- detection helpers ---------------------------------------------------
    def _alive(self, wid: int) -> bool:
        p = self.procs.get(wid)
        return p is not None and p.poll() is None

    def _spawn(self, wid: int) -> None:
        self.procs[wid] = self.spawn_worker(wid)

    def _declare_dead(self, wid: int, note: str, reason: str) -> None:
        self._frozen.discard(wid)
        super()._declare_dead(wid, note, reason)

    def _check_workers(self) -> None:
        # deaths: waitpid — any exit while the epoch is incomplete is a
        # casualty (a healthy worker blocks in acquire until the run ends)
        for wid in sorted(self.active):
            p = self.procs[wid]
            rc = p.poll()
            if rc is not None:
                self._declare_dead(wid, f"worker process exited with code "
                                        f"{rc} mid-epoch", reason="died")
        # frozen: beating stopped but waitpid says alive (SIGSTOP, swap
        # death, a wedged device).  Revoke its leases NOW — survivors steal
        # them instead of waiting out the lease deadline.  The process is
        # left alone: a thaw re-enters via the ledger's holder check.
        if self.freeze_deadline is None:
            return
        now = time.monotonic()
        beats = self.lease_server.beats()
        for wid in sorted(self.active):
            beat = beats.get(wid)
            if beat is None or not self._alive(wid):
                continue
            if now - beat > self.freeze_deadline:
                if wid not in self._frozen:
                    self._frozen.add(wid)
                    n = self.ledger.revoke_worker(wid)
                    self.events.append({"kind": "frozen", "worker": wid,
                                        "leases_revoked": n})
                    logger.warning(
                        "worker process %d frozen (no heartbeat for %.1fs); "
                        "%d lease(s) revoked", wid, now - beat, n)
            elif wid in self._frozen:
                self._frozen.discard(wid)
                self.events.append({"kind": "thawed", "worker": wid})

    def _check_ps(self) -> None:
        if not self.ps_procs or self.respawn_ps is None:
            return
        now = time.monotonic()
        if now - self._last_ps_probe < self.ps_probe_interval:
            return
        self._last_ps_probe = now
        for j, p in enumerate(self.ps_procs):
            if now < self._ps_grace_until[j]:
                if wire_heartbeat(*self.ps_addrs[j],
                                  timeout=self.ps_deadline):
                    self._ps_grace_until[j] = 0.0  # up: probes count again
                continue
            dead = p.poll() is not None
            if not dead:
                dead = not wire_heartbeat(*self.ps_addrs[j],
                                          timeout=self.ps_deadline)
            if not dead:
                continue
            if self.ps_restarts[j] >= self.max_ps_restarts:
                continue  # crash loop: leave it to PSShardDown
            self.ps_restarts[j] += 1
            t0 = time.monotonic()
            try:
                p.kill()  # a wedged-but-alive process must release the port
                p.wait(timeout=5.0)
            except Exception:
                pass
            self.ps_procs[j] = self.respawn_ps(j)
            self._ps_grace_until[j] = time.monotonic() + self.ps_grace
            rec = {"shard": j, "respawn_ms":
                   round((time.monotonic() - t0) * 1e3, 1)}
            self.ps_recoveries.append(rec)
            self.events.append({"kind": "ps_respawn", **rec})
            logger.warning("PS shard process %d dead; respawned at %s:%d",
                           j, *self.ps_addrs[j])

    # -- the per-epoch loop --------------------------------------------------
    def run_epoch(self, epoch: int) -> None:
        """Drive one epoch of the ledger to completion (or raise)."""
        self.ledger.begin_epoch(epoch)
        self.lease_server.open_epoch(epoch)
        try:
            while not self.ledger.epoch_done():
                for lease, holder in self.ledger.revoke_expired():
                    self.events.append({"kind": "lease_revoked",
                                        "epoch": epoch,
                                        "lease": lease.lease_id,
                                        "worker": holder})
                self._check_workers()
                self._check_ps()
                # liveness: leases remain but no unfrozen worker is running
                if not self.ledger.epoch_done() and not any(
                        self._alive(w) and w not in self._frozen
                        for w in self.active):
                    if self._respawn(-1, "worker pool drained") is None:
                        raise RuntimeError(
                            f"all worker processes failed with "
                            f"{self.respawns} respawns spent (max_respawns="
                            f"{self.max_respawns}); failures: "
                            f"{self.failures}")
                time.sleep(self.poll_interval)
        finally:
            self.lease_server.close_epoch()

    def stats(self) -> Dict[str, Any]:
        return {
            "respawns": self.respawns,
            "respawn_records": list(self.respawn_records),
            "ps_restarts": list(self.ps_restarts),
            "ps_recoveries": list(self.ps_recoveries),
            "leases_reassigned": self.ledger.reassigned,
            "windows_per_worker": dict(self.ledger.windows_by_worker),
            "events": list(self.events),
        }
