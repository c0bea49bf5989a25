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

Still to come with the async host-PS family (ROADMAP queue A item 6):
``dial``, ``wire_heartbeat``, ``Partitioned``, ``ShardJournal``,
``ShardSupervisor``, the lease classes and ``WorkerSupervisor``.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

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
