"""Online deployment, port of ``distkeras_tpu/deployment_online.py``:
train-while-serve under one lifecycle, over the port's streaming trainer
(``streaming.run_stream_training``), its hot-reloading ``ServingEngine``
(``attach_ps``) and its ``resilience.EngineSupervisor``.

``_weighted_percentile``, ``FreshnessTracker``, ``_DeployedSource`` and
``OnlineDeployment`` are the JAX module's, host code over the port's
seams: the trainer's ``_on_ps_ready`` and ``on_horizon``, the engine's
``attach_ps``, ``_reload_listener``, ``respawn_clone`` and
``_pull_weights``.  What differs lies beneath them: an attached port
engine owns a private copy of its weights (a clone takes its own), so a
blue/green swap's pull into the clone never reaches the requests the old
engine is still serving, and a request is served by exactly one
generation end to end, as in the JAX package, whose engines hold
immutable weights; the horizon loop hands ``on_horizon`` the center
once every commit that can still land has applied; and the deployment
detaches its engine (``detach_ps``) through the loop's ``_on_ps_close``
seam before the training run's PS stops, so that a live engine's pull
never races the PS's shutdown: after training the engine serves the last
center it pulled, where a JAX engine stays attached and counts a failed
pull at every later step.

The JAX module's description follows.

Online deployment: train-while-serve under one lifecycle.

The paper's whole premise is asynchronous trainers (DOWNPOUR/ADAG) feeding
a live parameter server; the repo grew both production halves — online
training from an unbounded stream, and serving with ``attach_ps`` hot
reload — and this module runs them as ONE system:

.. code-block:: text

        traffic ──▶ OnlineDeployment.serve() ──▶ ServingEngine ──┐
           ▲              │ feed(x, y)                           │ 'p' pull
           │              ▼                                      ▼
        clients      StreamSource ──▶ run_stream_training ──▶ socket PS
                     (stamped)         (elastic host-PS)      (live center)

one process graph under one supervisor surface, chaos-killable at every
seam by COMPOSING the existing machinery rather than duplicating it:

 - **workers** die and respawn through the streaming trainer's own
   ``WorkerSupervisor`` + ``LeaseLedger`` (exactly-once per horizon);
 - **PS shards** die and respawn same-address through ``ShardSupervisor``
   (``recovery=True``); the engine's reload socket re-dials under a
   ``resilience.RetryPolicy`` and a failed pull keeps the current weights;
 - **the serving engine** dies (crash or wedge) and is respawned through
   ``EngineSupervisor`` — the deployment itself is the supervisor's
   ``target``, so the detect→``respawn_clone``→``warmup``→swap path lands
   on the deployment's atomic ``engine`` setter and bumps the serve
   generation exactly like a blue/green swap does.

**Freshness** is the first-class observable: every example is stamped when
it enters the stream (``feed()`` time for served-traffic feedback rows,
read-arrival time for base chunks), every completed horizon stamps the
commit instant (by ``on_horizon`` every row of horizon *h* is applied to
the live center), and every successful ``attach_ps`` pull closes the loop
through the engine's reload listener — the pulled center's update clock is
``stats["center_generation"]``, and the next decode step serves it.  One
freshness sample per stamped chunk:

    ``freshness_s = t_pull_live - t_stream_entry``

reported as ``freshness_p50_s`` / ``freshness_p99_s`` (row-weighted
percentiles) in :meth:`OnlineDeployment.stats`, mirrored into
``trainer.stream_stats`` and ``engine.stats``.

**Blue/green reload** (:meth:`OnlineDeployment.blue_green_swap`): serve
generation *g* while *g+1* warms — a ``respawn_clone()`` pulls the
freshest center, ``warmup()`` prepares every program, and only then does
the atomic engine swap land; the old engine drains (in-flight requests
finish on *g*), so a request is served by exactly one generation end to
end.

Constructing no ``OnlineDeployment`` changes nothing: the trainer hooks
(``_on_ps_ready``, ``on_horizon``) default to None, the engine's reload
listener defaults to None, and the stamped-source wrapper only exists
inside a deployment.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .resilience import EngineSupervisor
from .serving import EngineDead, ServingEngine
from .streaming import StreamSource

logger = logging.getLogger("distkeras_tpu_torch.deployment_online")


# ---------------------------------------------------------------------------
# freshness: stream entry → PS commit → attach_ps pull
# ---------------------------------------------------------------------------

def _weighted_percentile(samples: Sequence[Tuple[float, int]],
                         q: float) -> Optional[float]:
    """Row-weighted percentile over ``(value, rows)`` samples — every
    stamped row counts once without materializing a per-row array."""
    if not samples:
        return None
    ordered = sorted(samples)
    total = sum(w for _, w in ordered)
    target = q / 100.0 * total
    seen = 0
    for value, w in ordered:
        seen += w
        if seen >= target:
            return value
    return ordered[-1][0]


class FreshnessTracker:
    """Time-to-served-effect accounting across the three online seams.

    Called from three threads — the stream consumer (``note_horizon``),
    the training thread's horizon loop (``note_commit``), and the engine's
    decode thread (``note_pull``, via the engine's reload listener) — so
    every transition holds the tracker lock.  All instants are
    ``time.monotonic()``.

     - :meth:`note_horizon` — one call per stream read (one read = one
       horizon in ``run_stream_training``); ``entries`` is the chunk
       breakdown ``[(rows, t_entry), ...]`` so feedback rows keep their
       ``feed()``-time stamps while base rows carry arrival time.
     - :meth:`note_commit` — horizon *h* completed: by ``on_horizon``
       every one of its rows is applied to the live center.
     - :meth:`note_pull` — a successful hot-reload pull at instant *t*
       with the center's update clock: every committed-but-unserved
       horizon whose commit predates *t* becomes served, one freshness
       sample per stamped chunk (the next decode step serves the pulled
       weights — pull instants are taken between steps).
    """

    def __init__(self):
        self._lock = threading.Lock()
        #: per horizon: {"chunks": [(rows, t_entry)], "committed": t|None,
        #:  "served": t|None}
        self._horizons: List[Dict[str, Any]] = []
        self._samples: List[Tuple[float, int]] = []   # (freshness_s, rows)
        self.pulls = 0
        self.last_pull_generation: Optional[int] = None

    def note_horizon(self, entries: Sequence[Tuple[int, float]]) -> int:
        with self._lock:
            self._horizons.append({"chunks": [(int(n), float(t))
                                              for n, t in entries],
                                   "committed": None, "served": None})
            return len(self._horizons) - 1

    def note_commit(self, horizon: int, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else float(t)
        with self._lock:
            if 0 <= horizon < len(self._horizons):
                h = self._horizons[horizon]
                if h["committed"] is None:
                    h["committed"] = t

    def note_pull(self, t: float, generation: Optional[int]) -> None:
        with self._lock:
            self.pulls += 1
            if generation is not None:
                self.last_pull_generation = int(generation)
            for h in self._horizons:
                if (h["served"] is None and h["committed"] is not None
                        and h["committed"] <= t):
                    h["served"] = t
                    for rows, t_entry in h["chunks"]:
                        self._samples.append(
                            (max(float(t) - t_entry, 0.0), rows))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            rows = sum(w for _, w in self._samples)
            served = sum(1 for h in self._horizons
                         if h["served"] is not None)
            committed = sum(1 for h in self._horizons
                            if h["committed"] is not None)
            return {
                "freshness_p50_s": _weighted_percentile(self._samples, 50),
                "freshness_p99_s": _weighted_percentile(self._samples, 99),
                "freshness_rows": rows,
                "freshness_horizons_served": served,
                "freshness_horizons_committed": committed,
                "reload_pulls": self.pulls,
                "center_generation": self.last_pull_generation,
            }


# ---------------------------------------------------------------------------
# the stamped + feedback stream source
# ---------------------------------------------------------------------------

class _DeployedSource(StreamSource):
    """The deployment's view of the caller's :class:`StreamSource`:
    every read is stamped for freshness, and served-traffic feedback rows
    (:meth:`OnlineDeployment.feed`) are spliced in ahead of base rows —
    the served→trained feedback loop.  Subclasses ``StreamSource`` only
    to satisfy the streaming trainer's contract check; all state lives on
    the wrapped base source."""

    # deliberately no super().__init__: this wrapper owns no backend —
    # read/start/stop delegate, and `buffer` aliases the base's ring so
    # run_stream_training's buffer accounting observes the real stream
    def __init__(self, base: StreamSource, tracker: FreshnessTracker):
        self._base = base
        self._tracker = tracker
        self._fb_lock = threading.Lock()
        #: pending feedback chunks: (x, y, t_feed)
        self._fb: List[Tuple[np.ndarray, np.ndarray, float]] = []
        self.rows_fed_back = 0
        self._closed = False

    @property
    def buffer(self):
        return self._base.buffer

    def start(self) -> "StreamSource":
        self._base.start()
        return self

    def stop(self) -> None:
        # feedback makes the stream SELF-SUSTAINING (every served batch
        # fed back becomes a future horizon), so closing the base alone
        # would never end the run — the closed flag stops the splice,
        # abandoning unconsumed feedback, while buffered base rows still
        # drain (zero lost base examples)
        self._closed = True
        self._base.stop()

    def feed(self, x: np.ndarray, y: np.ndarray) -> int:
        x = np.asarray(x)
        y = np.asarray(y)
        if len(x) != len(y):
            raise ValueError(f"feedback rows disagree: x has {len(x)}, "
                             f"y has {len(y)}")
        if len(x) == 0:
            return 0
        with self._fb_lock:
            self._fb.append((x.copy(), y.copy(), time.monotonic()))
            self.rows_fed_back += len(x)
        return len(x)

    def read(self, n: int, timeout: Optional[float] = None):
        if self._closed:
            chunk = self._base.read(n, timeout=timeout)  # drain the tail
            if chunk is None:
                return None
            self._tracker.note_horizon([(len(chunk[0]), time.monotonic())])
            return chunk
        with self._fb_lock:
            pending, self._fb = self._fb, []
        fb_rows = sum(len(x) for x, _, _ in pending)
        base_chunk = None
        if fb_rows < n:
            base_chunk = self._base.read(n - fb_rows, timeout=timeout)
        if not pending and base_chunk is None:
            return None  # base stream drained, no feedback queued
        entries: List[Tuple[int, float]] = [(len(x), t)
                                            for x, _, t in pending]
        parts_x = [x for x, _, _ in pending]
        parts_y = [y for _, y, _ in pending]
        if base_chunk is not None:
            # base rows are stamped at arrival — the instant they leave
            # the source and become trainable (docs/DEPLOY.md defines the
            # freshness clock start per row class)
            entries.append((len(base_chunk[0]), time.monotonic()))
            parts_x.append(base_chunk[0])
            parts_y.append(base_chunk[1])
        self._tracker.note_horizon(entries)
        if len(parts_x) == 1:
            return parts_x[0], parts_y[0]
        return np.concatenate(parts_x), np.concatenate(parts_y)


# ---------------------------------------------------------------------------
# the deployment supervisor
# ---------------------------------------------------------------------------

class OnlineDeployment:
    """Run the canonical online-ML process graph under one lifecycle.

    ``trainer`` is a stream-mode async PS trainer (``stream=True``,
    ``execution='host_ps'``), ``source`` the unbounded
    :class:`~distkeras_tpu_torch.streaming.StreamSource` it trains from,
    and ``engine`` a :class:`~distkeras_tpu_torch.serving.ServingEngine`
    over the
    SAME architecture (the hot-reload pull maps the PS center onto the
    engine's weight list — a mismatched architecture fails the pull and
    counts ``reload_failures``; it never corrupts serving).

    :meth:`start` wires the seams and launches training on a background
    thread: the source is wrapped for freshness stamping + feedback, the
    trainer's ``_on_ps_ready`` hook attaches the engine to the live PS the
    moment its address exists, and ``on_horizon`` is chained (freshness
    commit stamp first, then the caller's hook).  The engine may be
    ``start()``-ed (live mode — its decode loop pulls between steps) or
    inline (``serve`` pumps ``step()`` on the caller's thread — the
    deterministic tier-1 test path).

    ``supervise=True`` starts an :class:`EngineSupervisor` with the
    DEPLOYMENT as its target: a crashed or wedged engine is respawned
    (``respawn_clone`` → ``warmup`` → ``start``) and swapped in through
    the same atomic ``engine`` setter blue/green uses, bumping
    ``generation``.  Requests in flight at the kill fail with
    :class:`EngineDead`; :meth:`serve` resubmits them to the replacement
    (deterministic seeds make the retry idempotent), so a chaos kill
    loses zero requests end to end.

    Chaos surface (composing, not duplicating): :meth:`kill_engine`
    (→ ``EngineSupervisor`` recovery), :meth:`kill_ps_shard`
    (→ ``ShardSupervisor`` same-address respawn; needs ``recovery=True``
    on the trainer), and worker kills via the trainer's own
    ``fault_injection`` knob (→ ``WorkerSupervisor`` respawn under the
    exactly-once lease ledger).
    """

    def __init__(self, trainer, source: StreamSource,
                 engine: ServingEngine, *, reload_every: int = 1,
                 reload_retry_policy=None, supervise: bool = False,
                 supervisor_kw: Optional[Dict[str, Any]] = None):
        if not getattr(trainer, "stream", False):
            raise ValueError(
                "OnlineDeployment drives the streaming horizon loop — "
                "construct the trainer with stream=True "
                "(execution='host_ps')")
        if not isinstance(source, StreamSource):
            raise ValueError(
                f"source must be a streaming.StreamSource, got "
                f"{type(source).__name__}")
        if not isinstance(engine, ServingEngine):
            raise ValueError(
                f"engine must be a serving.ServingEngine, got "
                f"{type(engine).__name__}")
        if engine._ps_addr is not None:
            raise ValueError(
                "engine is already attach_ps-ed; the deployment owns the "
                "attachment (it learns the PS address from the training "
                "run)")
        if int(reload_every) < 1:
            raise ValueError(f"reload_every must be >= 1, "
                             f"got {reload_every}")
        self.trainer = trainer
        self.tracker = FreshnessTracker()
        self.source = _DeployedSource(source, self.tracker)
        self.reload_every = int(reload_every)
        self.reload_retry_policy = reload_retry_policy
        self._engine = engine
        self._lock = threading.Lock()        # engine identity + generation
        self.generation = 0                  # serve generation (g)
        #: one record per engine swap (blue/green or supervised restart)
        self.swaps: List[Dict[str, Any]] = []
        self.supervisor: Optional[EngineSupervisor] = None
        self._supervise = bool(supervise)
        self._supervisor_kw = dict(supervisor_kw or {})
        self._train_thread: Optional[threading.Thread] = None
        self._train_error: Optional[BaseException] = None
        self._fitted = None
        self._done = threading.Event()
        self._ps_ready = threading.Event()
        self.ps_addr: Optional[Tuple[str, int]] = None
        self._user_on_horizon: Optional[Callable] = None
        self._started = False
        self._ps_closed = False              # the training run's PS stopped

    # -- engine identity (the atomic swap seam) ------------------------------
    @property
    def engine(self) -> ServingEngine:
        return self._engine

    @engine.setter
    def engine(self, new: ServingEngine) -> None:
        # EngineSupervisor._recover assigns here (`target.engine = new`)
        # and blue_green_swap routes through the same setter: ONE atomic
        # transition bumps the serve generation, so every submit observes
        # a consistent (engine, generation) pair
        with self._lock:
            old, self._engine = self._engine, new
            self.generation += 1
            self.swaps.append({
                "generation": self.generation,
                "old_engine": id(old), "new_engine": id(new),
                "old_dead": old.dead is not None,
            })
            closed = self._ps_closed
        if closed:  # a clone attached before the PS stopped
            new.detach_ps()

    def _current(self) -> Tuple[ServingEngine, int]:
        with self._lock:
            return self._engine, self.generation

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "OnlineDeployment":
        if self._started:
            raise RuntimeError("OnlineDeployment.start() is one-shot")
        self._started = True
        with self._lock:
            self._engine._reload_listener = self.tracker.note_pull
        self.trainer._on_ps_ready = self._on_ps_ready
        self.trainer._on_ps_close = self._on_ps_close
        self._user_on_horizon = getattr(self.trainer, "on_horizon", None)
        self.trainer.on_horizon = self._on_horizon
        if self._supervise:
            self.supervisor = EngineSupervisor(self, **self._supervisor_kw)
            self.supervisor.start()
        self._train_thread = threading.Thread(
            target=self._train, daemon=True, name="dkt-online-trainer")
        self._train_thread.start()
        return self

    def _on_ps_ready(self, server, addr: Tuple[str, int]) -> None:
        self.ps_addr = (str(addr[0]), int(addr[1]))
        eng, _ = self._current()
        # sharded training PS (ps_shards>1): the streaming run hands this
        # hook the live ShardedServerGroup — attach the engine with its
        # plan + per-shard ports so every hot-reload pull gathers the FULL
        # center (attach_ps's all-or-nothing sharded path), never one
        # shard's torn slice.  The advertise host comes from `addr`; the
        # group's ports are bind-side but port numbers are host-agnostic.
        plan = getattr(server, "plan", None)
        shard_kw = {}
        if plan is not None and getattr(plan, "num_shards", 1) > 1:
            shard_kw = {"shard_plan": plan,
                        "shard_addrs": [(self.ps_addr[0], int(p))
                                        for p in server.ports]}
        eng.attach_ps(*self.ps_addr, every=self.reload_every,
                      retry_policy=self.reload_retry_policy, **shard_kw)
        self._ps_ready.set()

    def _on_ps_close(self) -> None:
        # the run is over and its PS about to stop: end the attachment
        # first, waiting for a pull in flight
        with self._lock:
            self._ps_closed = True
            eng = self._engine
        eng.detach_ps()

    def _on_horizon(self, h: int, fitted) -> None:
        self.tracker.note_commit(h)
        if self._user_on_horizon is not None:
            self._user_on_horizon(h, fitted)

    def _train(self) -> None:
        try:
            self._fitted = self.trainer.train(self.source)
        except BaseException as e:
            self._train_error = e
            logger.exception("online deployment training run failed")
        finally:
            self._ps_ready.set()  # unblock waiters even on early failure
            self._publish_freshness()
            self._done.set()

    def _publish_freshness(self) -> None:
        """Mirror the freshness observables into the trainer's
        ``stream_stats`` and the engine's ``stats``."""
        fresh = self.tracker.stats()
        stats = getattr(self.trainer, "stream_stats", None)
        if isinstance(stats, dict):
            stats.update({k: fresh[k] for k in
                          ("freshness_p50_s", "freshness_p99_s",
                           "freshness_rows")})
        eng, _ = self._current()
        eng.stats["freshness_p50_s"] = fresh["freshness_p50_s"]
        eng.stats["freshness_p99_s"] = fresh["freshness_p99_s"]

    def wait_ps_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the training run's PS exists and the engine is
        attached (or training already ended)."""
        return self._ps_ready.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def join(self, timeout: Optional[float] = None):
        """Wait for the training run to end (stream drained or
        ``max_horizons`` reached); returns the fitted model.  Re-raises
        the training thread's error, if any."""
        if self._train_thread is None:
            raise RuntimeError("OnlineDeployment was never start()-ed")
        self._train_thread.join(timeout)
        if self._train_thread.is_alive():
            raise TimeoutError(
                f"training run still live after {timeout}s")
        if self._train_error is not None:
            raise self._train_error
        return self._fitted

    def stop(self, drain_timeout: Optional[float] = 30.0):
        """Wind the whole graph down: end the stream (the horizon loop
        finishes its current horizon and returns), join training, stop
        the engine supervisor, and drain the serving engine.  Returns the
        fitted model (None if training failed before fitting)."""
        self.source.stop()
        fitted = None
        if self._train_thread is not None:
            try:
                fitted = self.join()
            except TimeoutError:
                raise
            except BaseException:
                logger.warning("online deployment stopped after a failed "
                               "training run", exc_info=True)
        if self.supervisor is not None:
            self.supervisor.stop()
        eng, _ = self._current()
        if eng.dead is None:
            eng.drain(timeout=drain_timeout)
        self._publish_freshness()
        return fitted

    def __enter__(self) -> "OnlineDeployment":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the serving surface -------------------------------------------------
    def feed(self, x, y) -> int:
        """Feed served traffic (or any labeled rows) back into the
        stream: rows are stamped NOW — their freshness clock starts at
        this call — and spliced ahead of base-stream rows in the next
        horizon read."""
        return self.source.feed(x, y)

    def submit(self, prompt, num_steps: int, **kw):
        """Submit one request to the CURRENT engine; returns
        ``(handle, generation)`` — the attribution contract: the request
        runs on exactly the engine generation it was submitted to (an
        in-between swap drains the old engine, it never kills it)."""
        eng, gen = self._current()
        return eng.submit(prompt, num_steps, **kw), gen

    def serve(self, prompts, num_steps: int = 1, retries: int = 3,
              retry_wait_s: float = 2.0, **kw):
        """Serve a batch of prompts against the live deployment; returns
        ``(rows, generations)`` — one ``generate``-shaped row and one
        serve-generation tag per prompt.

        Inline engines (never ``start()``-ed) are pumped on this thread —
        the deterministic, sleep-free path.  Live engines resolve through
        their decode loop.  A request failed by an engine death
        (:class:`EngineDead`) is resubmitted to the replacement engine up
        to ``retries`` times (deterministic seeds make the retry
        idempotent — same tokens, new generation), waiting up to
        ``retry_wait_s`` for the supervisor's swap; requests are lost
        only when every retry is exhausted, and then loudly."""
        prompts = [np.asarray(p, np.int32) for p in prompts]
        rows: List[Optional[np.ndarray]] = [None] * len(prompts)
        gens: List[Optional[int]] = [None] * len(prompts)
        outstanding = list(range(len(prompts)))
        for attempt in range(int(retries) + 1):
            eng, gen = self._current()
            if eng.dead is not None:
                eng = self._await_replacement(eng, retry_wait_s)
                eng, gen = self._current()
            handles = []
            for i in outstanding:
                handles.append((i, eng.submit(prompts[i], num_steps,
                                              **kw)))
            self._pump(eng, [h for _, h in handles])
            failed: List[int] = []
            for i, h in handles:
                try:
                    rows[i] = h.result()
                    gens[i] = gen
                except EngineDead:
                    failed.append(i)
            outstanding = failed
            if not outstanding:
                return rows, gens
        raise EngineDead(
            f"{len(outstanding)} request(s) lost after {retries} "
            f"engine-death retries")

    def _pump(self, eng: ServingEngine, handles) -> None:
        """Drive an inline engine to completion of ``handles`` on the
        calling thread (live engines return immediately — their decode
        loop owns the stepping)."""
        if eng._thread is not None or eng.dead is not None:
            return
        # generous bound: every handle's full prompt+decode budget plus
        # queue depth, so a stuck request raises instead of spinning
        budget = sum(len(h.prompt) + h.num_steps + 2 for h in handles)
        budget = (budget + 16) * max(1, len(handles))
        steps = 0
        while any(not h.done for h in handles):
            eng.step()
            steps += 1
            if eng.dead is not None:
                return
            if steps > budget:
                raise RuntimeError(
                    f"inline serve exceeded its step budget ({budget}) "
                    f"with requests still pending")

    def _await_replacement(self, dead_eng: ServingEngine,
                           wait_s: float) -> ServingEngine:
        """Wait (bounded) for the supervisor to swap a replacement in
        after ``dead_eng`` died."""
        deadline = time.monotonic() + float(wait_s)
        while time.monotonic() < deadline:
            eng, _ = self._current()
            if eng is not dead_eng and eng.dead is None:
                return eng
            time.sleep(0.01)
        eng, _ = self._current()
        if eng.dead is not None:
            raise EngineDead(
                "no live replacement engine arrived within "
                f"{wait_s}s of the kill") from eng.dead
        return eng

    # -- blue/green ----------------------------------------------------------
    def blue_green_swap(self, pull: bool = True,
                        drain_timeout: Optional[float] = 30.0
                        ) -> Dict[str, Any]:
        """Serve generation *g* while *g+1* warms, then swap atomically.

        The replacement is ``respawn_clone()`` (same weights/knobs/
        attachment, a private copy of the weights — the supervised restart
        path), optionally hot-pulled to the
        freshest center BEFORE warmup, then ``warmup()``-ed so its first
        live step pays no first call (on a card: its decode graph is
        captured).  The swap itself is one assignment
        through the deployment's ``engine`` setter — submissions observe
        either (old, g) or (new, g+1), never a torn pair — and the old
        engine drains: every request in flight at the swap finishes on
        the generation that admitted it."""
        old, old_gen = self._current()
        new = old.respawn_clone()
        if pull and new._ps_addr is not None:
            # warm g+1 with the live center (best-effort, same contract
            # as any hot reload — a dead PS leaves the cloned weights)
            new._pull_weights()
        new.warmup()
        was_live = old._thread is not None
        if was_live:
            new.start()
        self.engine = new  # the atomic generation bump
        t0 = time.monotonic()
        drained = old.drain(timeout=drain_timeout)
        with self._lock:
            record = self.swaps[-1]
        record.update({"blue_green": True, "pulled": bool(
            pull and new._ps_addr is not None and
            new.stats["reloads"] > 0),
            "old_drained_clean": bool(drained),
            "drain_ms": round((time.monotonic() - t0) * 1e3, 1)})
        return record

    # -- chaos ---------------------------------------------------------------
    def kill_engine(self, reason: str = "chaos: engine killed") -> None:
        """Chaos hook: declare the current engine dead (every in-flight
        handle fails with :class:`EngineDead`).  With ``supervise=True``
        the :class:`EngineSupervisor` respawns and swaps a warmed clone
        in; :meth:`serve` resubmits its failed requests there."""
        eng, _ = self._current()
        eng.declare_dead(reason)

    def kill_ps_shard(self, j: int = 0) -> None:
        """Chaos hook: crash PS shard ``j`` through the training run's
        ``ShardSupervisor`` (same-address respawn from the journal).
        Requires ``recovery=True`` on the trainer."""
        sup = getattr(self.trainer, "_ps_supervisor", None)
        if sup is None:
            raise RuntimeError(
                "no ShardSupervisor: construct the trainer with "
                "recovery=True to make the PS killable")
        sup.kill_shard(j)

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """One merged deployment snapshot: freshness percentiles, serve
        generation + swap records, engine reload/request counters, and —
        once training ended — the trainer's stream/elastic stats."""
        with self._lock:
            eng, gen = self._engine, self.generation
            swaps = [dict(s) for s in self.swaps]
        out: Dict[str, Any] = {"generation": gen,
                               "swaps": swaps,
                               "rows_fed_back":
                                   self.source.rows_fed_back,
                               "ps_addr": self.ps_addr,
                               "training_done": self.done}
        out.update(self.tracker.stats())
        for k in ("reloads", "reload_failures", "center_generation",
                  "weight_reloads", "requests_submitted",
                  "requests_completed", "requests_failed",
                  "requests_rejected", "decode_steps",
                  "tokens_generated"):
            out[f"engine_{k}"] = eng.stats[k]
        if self.supervisor is not None:
            out["engine_recoveries"] = [dict(r) for r in
                                        self.supervisor.recoveries]
        if self.done:
            out["stream_stats"] = dict(
                getattr(self.trainer, "stream_stats", {}) or {})
            out["elastic_stats"] = {
                k: v for k, v in
                (getattr(self.trainer, "elastic_stats", {}) or {}).items()
                if k in ("respawns", "leases_reassigned")}
        return out
