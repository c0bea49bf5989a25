"""Host parameter servers, port of ``distkeras_tpu/parameter_servers.py``:
the semantically-exact asynchronous path (``execution="host_ps"``).

The server side is host code in both packages: the center weights live in
host memory as f32 numpy arrays and every commit is applied there, so the
apply rules, the two server cores and the wire are the JAX module's, byte
for byte and bit for bit (``tests/test_torch_host_ps_parity.py`` holds
the two centers and clocks equal for the same commits).  What runs on the
card is the workers' window program (``workers.py``): each worker is a
thread that trains its own copy of the model on the trainer's device and
talks to the server over a loopback socket.

Differences from the JAX module:

 - a ``"bfloat16"`` wire leaf arrives as a CPU ``torch.bfloat16`` tensor
   (``networking``: no ``ml_dtypes``) and is upcast with ``.float()``
   before the axpy, the same exact widening ``ml_dtypes`` does;
 - ``get_model(device=)`` builds the fitted model on a torch device;
 - ``apply_kernel`` resolves through the port's ``applykernel``, whose
   native route is the port's own build of ``csrc/applykernel.cpp``
   (``native.py``; numpy is the reference and bit-identical either way);
 - ``run_host_ps_training`` runs the static engine (the round-robin
   deal, the epoch waves and the npz checkpoint) and the elastic one
   (``_run_elastic_host_ps``: leases, a ``WorkerSupervisor``), over one
   server or a ``ps_sharding.ShardedServerGroup`` (``ps_shards > 1``, or
   any count under ``recovery``, with a ``resilience.ShardSupervisor``),
   with ``fault_tolerance``'s degraded completion and ``row_sparse``
   resolved by ``streaming.resolve_row_sparse_tables``.  Before it reads
   the center it waits until every server has applied the commits that
   can still land (``_await_applied``): each shard's clock at the start
   of its generation plus the commits the workers sent it at that
   generation;
 - ``run_process_ps_training`` runs the same workers as OS processes
   (``ps_worker_main``, launched through ``job_deployment``), static or
   elastic under a ``resilience.ProcessSupervisor`` over the lease rail,
   with the PS in the driver or in shard processes (``ps_shard_main``);
   its wait counts the commits each child reports in its result file;
 - the elastic epoch engine and the streaming horizon loop
   (``streaming.run_stream_training``) share one lease engine
   (``_LeaseLoop``).

The JAX module's description follows.

Reference being replaced: ``distkeras/parameter_servers.py`` (SURVEY.md §2.1
rows 14–16, §3.4): a TCP server thread on the Spark driver holding the center
model; one handler thread per worker connection; 1-byte actions ``'p'``
(pull → send center weights) and ``'c'`` (commit → apply delta).  The
reference applies commits **without a lock** (GIL-tolerated hogwild); we keep
true hogwild *interleaving* across windows but make each individual apply
atomic under a mutex — same algorithm semantics, no torn ndarray writes.

The server core is **event-driven**: one I/O thread multiplexes every
worker connection over a selector (``SocketParameterServer``), and commits
that arrive while an apply is in flight are **coalesced** — applied as one
batch per drain, with runs of sparse commits merged into ONE vectorized
scatter-add (the classic server-side aggregation the PS scaling results
hinge on: Dean et al. NIPS 2012; Li et al. OSDI 2014).  The
thread-per-connection core is retained as ``ThreadedSocketParameterServer``
(``ps_core="threaded"``).  Coalescing semantics per algorithm:

 - DOWNPOUR / the elastic family: commits within a drain apply in arrival
   order with per-commit arithmetic unchanged, so a coalesced drain is
   BIT-equal to the same commits applied sequentially (sums commute, and
   the accumulation order is preserved per coordinate).
 - ADAG: same — the 1/num_workers scale is clock-independent.
 - DynSGD: staleness is stamped at ENQUEUE (the commit's arrival at the
   server), not at apply: commits coalesced into one drain do not count
   each other as staleness.  Single-worker runs are bit-identical (a
   strict request/reply worker never has two commits in one drain).
"""

from __future__ import annotations

import logging
import selectors
import socket
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import applykernel, networking
from .core.model import FittedModel, deserialize_model, serialize_model
from .device import DeviceLike
from .ps_sharding import PSShardDown, ShardedServerGroup
from .resilience import (LeaseLedger, ShardSupervisor, WorkerSupervisor,
                         wire_probe)
from .workers import (WORKER_CLASSES, parse_fault_injection,
                      share_compiled_state)

logger = logging.getLogger("distkeras_tpu_torch.parameter_servers")


def _f32(d) -> np.ndarray:
    """One dense delta leaf as f32 numpy: a ``"bfloat16"`` wire leaf is a
    CPU ``torch.bfloat16`` tensor here, widened exactly with ``.float()``
    (what ``astype(np.float32)`` does to an ``ml_dtypes`` bfloat16 array
    in the JAX package); every other leaf as in the JAX module."""
    if isinstance(d, torch.Tensor):
        return d.detach().float().numpy()
    return np.asarray(d).astype(np.float32, copy=False)


def _flat_offsets(center: List[np.ndarray]):
    """(per-tensor flat offsets, total elements) of the concatenated list."""
    sizes = np.array([int(c.size) for c in center], np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes)))
    return offsets, int(offsets[-1])


def _validate_sparse(sp: "networking.SparseDelta", total: int,
                     scale: float = 1.0):
    """One sparse commit's (sorted int64 indices, scaled f32 values),
    validated against the dense length — the per-commit normalization of
    ``_scatter_add``, factored out so a coalesced drain can concatenate
    many commits into one scatter-add with unchanged per-commit arithmetic
    (each commit is sorted/scaled exactly as its sequential apply would)."""
    if sp.length != total:
        raise ValueError(
            f"sparse commit declares dense length {sp.length}, center "
            f"has {total} elements")
    idx = sp.indices.astype(np.int64, copy=False)
    vals = sp.f32_values()
    if idx.size:
        if np.any(np.diff(idx) < 0):  # tolerate unsorted senders
            order = np.argsort(idx, kind="stable")
            idx, vals = idx[order], vals[order]
        if idx[0] < 0 or idx[-1] >= total:
            raise ValueError(
                f"sparse commit index out of range for dense length {total}")
    if scale != 1.0:
        vals = vals * np.float32(scale)
    return idx, vals


def _scatter_flat(center: List[np.ndarray], offsets: np.ndarray,
                  idx: np.ndarray, vals: np.ndarray, kernel=None) -> None:
    """One scatter-add of (sorted flat indices, f32 values) over the tensor
    list: the sorted indices are bisected once over the tensor offsets, then
    each tensor gets one sequential scatter-add (``np.add.at`` or the native
    kernel — bit-identical) over its contiguous index run."""
    bounds = np.searchsorted(idx, offsets)
    for t in range(len(center)):
        lo, hi = int(bounds[t]), int(bounds[t + 1])
        if lo == hi:
            continue
        flat = center[t].reshape(-1)  # view: center tensors are contiguous
        applykernel.scatter_add(kernel, flat, idx[lo:hi] - int(offsets[t]),
                                vals[lo:hi])


def _row_scatter_add(tensor: np.ndarray, rsp: "networking.RowSparseDelta",
                     scale: float = 1.0, kernel=None) -> None:
    """Apply a row-sparse delta to ONE tensor: O(k·dim) per-row scatter-add.

    ``rsp`` names touched leading-axis rows of ``tensor``; shapes and row
    range are validated so a hostile or mis-split commit raises instead of
    writing into neighbouring rows.  ``kernel`` routes the per-row axpy
    through the native apply kernel — bit-identical results.
    """
    if tensor.ndim < 2:
        raise ValueError(
            f"row-sparse commit targets a {tensor.ndim}-D tensor; row "
            "sparsity needs a leading row axis")
    if rsp.num_rows != tensor.shape[0]:
        raise ValueError(
            f"row-sparse commit declares {rsp.num_rows} rows, tensor has "
            f"{tensor.shape[0]}")
    if rsp.row_shape != tuple(tensor.shape[1:]):
        raise ValueError(
            f"row-sparse commit rows are shaped {rsp.row_shape}, tensor "
            f"rows are {tuple(tensor.shape[1:])}")
    rows = rsp.rows.astype(np.int64, copy=False)
    if rows.size == 0:
        return
    if int(rows.min()) < 0 or int(rows.max()) >= rsp.num_rows:
        raise ValueError(
            f"row-sparse commit row out of range for {rsp.num_rows} rows")
    vals = np.ascontiguousarray(rsp.f32_values())
    applykernel.row_scatter_add(
        kernel, tensor.reshape(tensor.shape[0], -1), rows,
        vals.reshape(vals.shape[0], -1), scale)


def _scatter_add(center: List[np.ndarray], sp: "networking.SparseDelta",
                 scale: float = 1.0, kernel=None) -> None:
    """Apply a k-sparse flat delta to a tensor list: O(k) scatter-add.

    ``sp`` indexes the concatenation of ``center`` (C-order flat, list
    order); indices are validated against the dense length so a hostile or
    mis-split commit raises instead of corrupting neighbouring tensors.
    The whole apply touches k coordinates, not the n-element center;
    ``kernel`` routes the inner scatter through the native apply kernel
    (``csrc/applykernel.cpp``) when enabled — bit-identical results.
    """
    offsets, total = _flat_offsets(center)
    idx, vals = _validate_sparse(sp, total, scale)
    if idx.size == 0:
        return
    _scatter_flat(center, offsets, idx, vals, kernel)


def _decode_commit_msg(msg):
    """Transport-boundary decompression + wire-contract validation, shared
    by BOTH server cores: int8 codes × per-tensor scales → f32 deltas;
    sparse top-k and row-sparse nodes VALIDATED (sorted unique in-range
    indices — ``networking.ProtocolError`` on violation, which the caller
    treats exactly like a torn frame: drop the connection, center
    untouched) and dequantized/detached to f32 copies, so every PS rule
    sees ordinary floats that outlive the receive buffer."""
    if not isinstance(msg, dict):
        return msg
    if "scales" in msg:
        msg["delta"] = [
            np.asarray(q, np.float32) * s
            for q, s in zip(msg["delta"], msg.pop("scales"))]
        return msg
    delta = msg.get("delta")
    if isinstance(delta, networking.SparseDelta):
        msg["delta"] = delta.validate().decoded()
    elif isinstance(delta, list) and any(
            isinstance(d, networking.RowSparseDelta) for d in delta):
        msg["delta"] = [
            d.validate().decoded()
            if isinstance(d, networking.RowSparseDelta) else d
            for d in delta]
    return msg


class ParameterServer:
    """Base PS (reference: ``parameter_servers.py :: ParameterServer``):
    holds the center weights + the update clock."""

    def __init__(self, model_blob: dict,
                 apply_kernel: Optional[str] = None):
        self.model_blob = model_blob
        self.center: List[np.ndarray] = [
            np.array(w, dtype=np.float32, copy=True)
            for w in model_blob["weights"]]
        self.num_updates = 0
        # the APPLY lock: guards center + clock only.  Connection
        # bookkeeping lives behind SocketParameterServer's own lock, so N
        # workers' commits never serialize behind accept/teardown state.
        self._lock = threading.Lock()
        # apply_kernel= knob (docs/API.md): None/'numpy' keeps the pure-
        # NumPy apply (the default and the bit-equality reference),
        # 'native' requires csrc/applykernel.cpp, 'auto' uses it if built.
        # Resolved eagerly so a bad name / missing build fails loudly at
        # construction, not mid-training under the apply lock.
        self.apply_kernel = apply_kernel
        self._kernel = applykernel.resolve(apply_kernel)

    def initialize(self):
        """Reference-parity hook (center is built in __init__ here)."""

    def next_update(self) -> int:
        self.num_updates += 1
        return self.num_updates

    def get_model(self, device: DeviceLike = None) -> FittedModel:
        """The center as a fitted model on ``device`` (``None`` means the
        CUDA card)."""
        with self._lock:
            weights = [w.copy() for w in self.center]
        return FittedModel(deserialize_model(
            {"model": self.model_blob["model"], "weights": weights},
            device=device))

    # -- the per-algorithm apply rule (subclasses override _scale) -----------
    def _scale(self, msg: Dict[str, Any]) -> float:
        """The scalar every rule reduces one commit to (called with
        ``_lock`` HELD).  This reduction is what lets sparsity AND drain
        coalescing compose with all the rules: a drain pre-computes each
        commit's scale, then applies the batch with per-commit arithmetic
        unchanged."""
        raise NotImplementedError

    def _apply(self, msg: Dict[str, Any]):
        """Apply one commit to the center.  Called with ``_lock`` HELD."""
        self._apply_scaled(msg, self._scale(msg))

    def _apply_scaled(self, msg: Dict[str, Any], scale: float):
        """Shared commit arithmetic: ``center += scale * delta`` for a dense
        tensor list, or an O(k) scatter-add for a k-sparse commit
        (``networking.SparseDelta`` — the ``wire_dtype="topk"`` wire form).
        Every rule reduces to a scalar ``scale``, so sparsity composes with
        all of them under the same apply lock.  With ``apply_kernel`` the
        dense axpy and the sparse scatter run through the native kernel —
        bit-identical to the numpy path (tests/test_applykernel.py)."""
        delta = msg["delta"]
        if isinstance(delta, networking.SparseDelta):
            _scatter_add(self.center, delta, scale, self._kernel)
        else:
            # a delta LIST may mix dense tensors with row-sparse embedding
            # blocks (``row_sparse=`` commits): dense entries apply as one
            # axpy each, row-sparse entries as an O(k·dim) row scatter-add
            # — same scalar ``scale``, so every rule composes unchanged
            for c, d in zip(self.center, delta):
                if isinstance(d, networking.RowSparseDelta):
                    _row_scatter_add(c, d, scale, self._kernel)
                else:
                    applykernel.axpy(self._kernel, c.reshape(-1),
                                     _f32(d).reshape(-1), scale)
        self.next_update()

    # -- coalesced drains (the event-driven core's batch apply) --------------
    def apply_drain(self, msgs: List[Dict[str, Any]]) -> int:
        """Apply transport-decoded commit messages in ARRIVAL ORDER under
        ONE lock acquisition, merging runs of consecutive sparse commits
        into one vectorized scatter-add.  Returns the clock after the
        drain.  Semantics per algorithm (module docstring + docs/host_ps.md):
        DOWNPOUR/ADAG coalesced results are bit-equal to the same commits
        applied sequentially; DynSGD prices staleness from each commit's
        ``_arrival`` stamp (set at enqueue by the event server) instead of
        the mid-drain clock."""
        with self._lock:
            self._apply_drain_locked(msgs)
            return self.num_updates

    def _apply_drain_locked(self, msgs: List[Dict[str, Any]]):
        i, n = 0, len(msgs)
        while i < n:
            if isinstance(msgs[i].get("delta"), networking.SparseDelta):
                j = i + 1
                while j < n and isinstance(msgs[j].get("delta"),
                                           networking.SparseDelta):
                    j += 1
                self._apply_sparse_run_locked(msgs[i:j])
                i = j
            else:
                # dense commits apply in arrival order with per-commit
                # arithmetic (one axpy per tensor) — pre-summing deltas
                # would re-round the accumulation and break the DOWNPOUR
                # bit-equality contract; the coalescing win here is one
                # lock acquisition and ONE reply snapshot per drain
                self._apply(msgs[i])
                i += 1

    def _apply_sparse_run_locked(self, msgs: List[Dict[str, Any]]):
        """A run of consecutive sparse commits as ONE scatter-add: each
        commit is sorted/scaled exactly as its sequential apply would be,
        the segments are concatenated, and a STABLE argsort merges them —
        stability keeps every coordinate's additions in arrival order, so
        the float accumulation (and hence the result) is bit-identical to
        applying the commits one by one."""
        if len(msgs) == 1:
            self._apply(msgs[0])
            return
        offsets, total = _flat_offsets(self.center)
        parts_i, parts_v = [], []
        for m in msgs:
            # scale BEFORE bumping the clock for this commit — the exact
            # sequence of the sequential path (DynSGD's fallback baseline
            # reads num_updates when no _arrival stamp is present)
            idx, vals = _validate_sparse(m["delta"], total, self._scale(m))
            parts_i.append(idx)
            parts_v.append(vals)
            self.next_update()
        idx = np.concatenate(parts_i)
        vals = np.concatenate(parts_v)
        if idx.size == 0:
            return
        order = np.argsort(idx, kind="stable")
        _scatter_flat(self.center, offsets, idx[order], vals[order],
                      self._kernel)

    def handle_commit(self, msg: Dict[str, Any]):
        with self._lock:
            self._apply(msg)

    def handle_update(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """``'u'`` = commit+pull: apply the delta and snapshot center+clock
        under ONE lock acquisition, so the reply is exactly the center this
        commit produced (plus any commits that landed before it) — the
        atomic combined round trip the overlapped workers ride."""
        with self._lock:
            self._apply(msg)
            return {"weights": [w.copy() for w in self.center],
                    "clock": self.num_updates}

    def handle_pull(self) -> Dict[str, Any]:
        with self._lock:
            return {"weights": [w.copy() for w in self.center],
                    "clock": self.num_updates}

    def handle_heartbeat(self) -> Dict[str, Any]:
        """``'h'``: cheap liveness probe — clock only, no weights.  Goes
        through the apply lock *deliberately*: a shard wedged inside an
        apply must fail the heartbeat deadline, not answer "alive" while
        every commit stalls (resilience.ShardSupervisor)."""
        with self._lock:
            return {"clock": self.num_updates}


class DeltaParameterServer(ParameterServer):
    """center += delta (reference: ``DeltaParameterServer`` — DOWNPOUR's and
    the elastic family's PS; for EASGD the committed 'delta' is the elastic
    term, so the same rule applies)."""

    def _scale(self, msg):
        return 1.0


class ADAGParameterServer(ParameterServer):
    """ADAG normalization (reference: ``ADAGParameterServer``): accumulated
    deltas are normalized over the number of concurrent committers before
    applying — the per-commit form of ``rules.adag_commit`` (which divides
    the cross-worker sum by the worker count)."""

    def __init__(self, model_blob, num_workers: int,
                 apply_kernel: Optional[str] = None):
        super().__init__(model_blob, apply_kernel=apply_kernel)
        self.num_workers = max(int(num_workers), 1)

    def _scale(self, msg):
        return 1.0 / self.num_workers


class DynSGDParameterServer(ParameterServer):
    """Staleness-aware apply (reference: ``DynSGDParameterServer``):
    center += delta / (staleness + 1), where staleness = updates that landed
    since this worker's last pull (the commit's ``clock`` field) — exactly
    ``rules.dynsgd_commit``.

    Coalescing ordering rule (docs/host_ps.md): the staleness baseline is
    the ``_arrival`` stamp the event server sets when the commit is
    ENQUEUED, so commits coalesced into one drain do not count each other
    as staleness — the drain prices every member against the clock it
    actually arrived at.  Without a stamp (direct calls, the threaded
    core) the baseline falls back to the live clock: the exact sequential
    semantics of the seed-era server, bit for bit."""

    def _scale(self, msg):
        baseline = int(msg.get("_arrival", self.num_updates))
        staleness = max(baseline - int(msg.get("clock", 0)), 0)
        return 1.0 / (staleness + 1.0)


def _enable_keepalive(sock: socket.socket,
                      idle_deadline: Optional[float] = None) -> None:
    """Kernel-level dead-peer detection on an accepted PS connection: a
    host that vanished without a FIN (power loss, hard partition) stops
    acking keepalive probes and the kernel errors the socket out of its
    blocked recv — the transport-level half of half-open reaping (the
    application-level half is ``idle_deadline``).  With a deadline set,
    the probe schedule is tightened to fire WITHIN it (idle at half the
    deadline, then up to 3 probes); without one, the OS defaults (hours)
    apply.  Every knob is best-effort — platforms without TCP_KEEPIDLE
    simply keep the plain SO_KEEPALIVE bit."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    except OSError:
        return
    if idle_deadline is None:
        return
    idle = max(1, int(idle_deadline / 2))
    intvl = max(1, int(idle_deadline / 6))
    for opt, val in (("TCP_KEEPIDLE", idle), ("TCP_KEEPINTVL", intvl),
                     ("TCP_KEEPCNT", 3)):
        if hasattr(socket, opt):
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                getattr(socket, opt), val)
            except OSError:
                pass


class ThreadedSocketParameterServer:
    """The seed-era thread-per-connection PS core (reference:
    ``SocketParameterServer.run`` — thread per connection, opcode dispatch).

    Retained behind ``ps_core="threaded"`` as the before/after baseline for
    the ``host_ps_worker_scaling`` bench: one handler thread per worker
    connection, one apply-lock acquisition and one full center snapshot per
    commit.  Structurally wrong at large worker counts — N threads churn
    the GIL and every 'u' pays an O(n) copy — which is exactly what the
    event-driven ``SocketParameterServer`` replaces.

    Composition instead of inheritance so the apply rules above stay pure-ish
    and unit-testable without sockets.
    """

    def __init__(self, ps: ParameterServer, host: str = "127.0.0.1",
                 port: int = 0, generation: int = 0,
                 idle_deadline: Optional[float] = None):
        self.ps = ps
        self.host = host
        self.port = port  # 0 → ephemeral; real port set by start()
        # recovery epoch (resilience.ShardSupervisor): bumped on every
        # respawn of this address.  Replies carry it; commits stamped with
        # an older generation are rejected (they were computed against a
        # center this restart rolled back) — the epoch/generation handshake.
        self.generation = int(generation)
        # half-open reaping (docs/host_ps.md failure matrix): a WAN peer
        # that vanished without a FIN (partition, SIGKILLed host, NAT state
        # loss) leaves its handler blocked in recv forever.  idle_deadline
        # seconds of silence reaps the connection — the worker re-dials and
        # resumes under its RetryPolicy, so reaping costs one reconnect,
        # never a lost commit.  None (default) keeps the seed behavior:
        # only kernel keepalive (always on) eventually notices.
        self.idle_deadline = (None if idle_deadline is None
                              else float(idle_deadline))
        if self.idle_deadline is not None and self.idle_deadline <= 0:
            raise ValueError("idle_deadline must be > 0 (or None)")
        #: connections reaped for idle_deadline silence (observability)
        self.reaped = 0
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conn_of: Dict[threading.Thread, socket.socket] = {}
        self._conn_lock = threading.Lock()  # guards: _conns, _conn_threads, _conn_of, _running
        self._running = False

    # -- lifecycle (reference: initialize/start/stop) ------------------------
    def start(self):
        self.ps.initialize()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._server.listen(128)
        with self._conn_lock:
            self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dkt-ps-accept")
        self._accept_thread.start()

    def stop(self, join_timeout: float = 5.0):
        """Idempotent shutdown that actually unblocks every thread.

        Closing an fd from another thread does not reliably interrupt a
        blocked ``accept()`` on Linux, so we wake the accept loop with a
        self-connection, join it, then ``shutdown(SHUT_RDWR)`` every accepted
        connection to kick handler threads out of ``recv`` before joining
        them.  A handler that outlives its ``join_timeout`` (wedged inside
        an apply, not a recv) is no longer leaked silently: the leak is
        logged and its connection socket force-closed again, so a thread
        stuck in socket I/O unblocks and one stuck in compute at least
        fails fast on its next send instead of writing to a live peer.
        """
        with self._conn_lock:
            was_running = self._running
            self._running = False
        if was_running and self._server is not None:
            try:  # wake the blocked accept(); loop sees _running=False
                wake = socket.create_connection((self.host, self.port),
                                                timeout=1.0)
                wake.close()
            except OSError:
                pass  # server socket already dead — accept has returned
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        with self._conn_lock:
            conns, threads = list(self._conns), list(self._conn_threads)
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
        for t in threads:
            t.join(timeout=join_timeout)
            if t.is_alive():
                logger.warning(
                    "PS handler thread %s still alive after stop(join_"
                    "timeout=%.1fs) — likely wedged in an apply; force-"
                    "closing its connection and leaving it to die detached",
                    t.name, join_timeout)
                with self._conn_lock:
                    conn = self._conn_of.get(t)
                if conn is not None:
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        conn.close()
                    except OSError:
                        pass

    @property
    def live_connections(self) -> int:
        """Connections with a live handler thread — the bookkeeping a
        half-frame worker death must decrement (a dying worker's torn
        commit drops its connection silently: no codec error escapes the
        handler, no `_conns` entry leaks; tests/test_elastic_workers.py)."""
        with self._conn_lock:
            return len(self._conns)

    def crash(self):
        """Abrupt-death simulation (chaos/bench hook): close the listener
        and every connection with no graceful shutdown, no joins, no final
        state flush — the in-process analogue of a SIGKILLed shard.  The
        in-memory center is deliberately abandoned; recovery must come from
        the last journal snapshot (resilience.ShardSupervisor), which is
        exactly the bounded-loss contract under test."""
        with self._conn_lock:
            self._running = False
            conns = list(self._conns)
        if self._server is not None:
            # shutdown() interrupts a blocked accept() (close() alone does
            # not on Linux — the accept syscall pins the open file
            # description, which would keep the PORT bound and block a
            # same-address respawn with EADDRINUSE)
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._server.close()
            except OSError:
                pass
        for c in conns:
            networking._hard_close(c)

    def get_model(self, device: DeviceLike = None) -> FittedModel:
        return self.ps.get_model(device)

    def respawn_clone(self, ps: ParameterServer
                      ) -> "ThreadedSocketParameterServer":
        """A same-core replacement server on this address with the
        generation bumped (resilience.ShardSupervisor.respawn_shard)."""
        return ThreadedSocketParameterServer(
            ps, host=self.host, port=self.port,
            generation=self.generation + 1,
            idle_deadline=self.idle_deadline)

    # -- service loops -------------------------------------------------------
    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return  # socket closed by stop()
            with self._conn_lock:
                if not self._running:  # stop()'s wake connection, or late join
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                _enable_keepalive(conn, self.idle_deadline)
                if self.idle_deadline is not None:
                    # blocked recv/send wakes with socket.timeout after
                    # this much silence → the handler reaps the half-open
                    # connection instead of pinning a thread forever
                    conn.settimeout(self.idle_deadline)
                t = threading.Thread(
                    target=self._handle_connection, args=(conn,),
                    daemon=True, name="dkt-ps-conn")
                self._conns.append(conn)
                self._conn_threads.append(t)
                self._conn_of[t] = conn
            t.start()

    def _handle_connection(self, conn: socket.socket):
        """Reference: ``handle_connection`` — loop on 1-byte actions until
        EOF/quit ('p' pull, 'c' commit, 'u' commit+pull, 'h' heartbeat,
        'q' quit).  Every reply carries this server's ``generation``."""
        # per-connection send pool: replies (full center, fixed layout)
        # re-serialize into the same preallocated buffer every round trip
        # instead of allocating a weight-sized output blob per reply
        send_pool = networking.BufferPool()
        try:
            while True:
                op = networking.recv_opcode(conn)
                if op in (b"", b"q"):
                    return
                if op == b"p":
                    reply = self.ps.handle_pull()
                    reply["gen"] = self.generation
                    networking.send_data(conn, reply, pool=send_pool)
                elif op == b"h":
                    # liveness probe (resilience.ShardSupervisor): clock +
                    # generation, no weights — and it takes the apply lock,
                    # so a wedged apply fails the probe deadline
                    reply = self.ps.handle_heartbeat()
                    reply["gen"] = self.generation
                    networking.send_data(conn, reply, pool=send_pool)
                elif op in (b"c", b"u"):
                    try:
                        # decode + the shared transport-boundary pass
                        # (_decode_commit_msg): int8 dequantization, sparse
                        # top-k / row-sparse validation (ProtocolError ⊂
                        # ValueError) — a contract-violating commit drops
                        # the connection exactly like a torn frame, before
                        # any apply could corrupt the center
                        msg = _decode_commit_msg(
                            networking.recv_data(conn))
                    except ValueError:
                        return  # torn/corrupt/hostile frame: drop it
                    # generation handshake: a commit stamped with an older
                    # generation was computed against a center a restart
                    # rolled back — drop it (bounded loss, same class as
                    # worker staleness) instead of applying it to the
                    # restored center.  'u' still replies with the current
                    # state + generation so the worker re-syncs in the same
                    # round trip.
                    gen = msg.get("gen") if isinstance(msg, dict) else None
                    stale = gen is not None and int(gen) != self.generation
                    # apply-rule errors deliberately propagate (visible
                    # thread traceback) — only transport faults are silent
                    if op == b"c":
                        if not stale:
                            self.ps.handle_commit(msg)
                    else:
                        # 'u': apply + snapshot atomically, reply in the
                        # same round trip (one DCN RTT per window instead
                        # of a commit send followed by a pull round trip)
                        if stale:
                            reply = self.ps.handle_pull()
                            reply["stale"] = True
                        else:
                            reply = self.ps.handle_update(msg)
                        reply["gen"] = self.generation
                        networking.send_data(conn, reply, pool=send_pool)
                else:
                    return  # protocol violation: drop the connection
        except socket.timeout:
            # idle_deadline of silence: the peer is half-open (vanished
            # without FIN) or wedged — reap the connection; a live worker
            # re-dials under its RetryPolicy
            self.reaped += 1
            return
        except (ConnectionError, OSError):
            # worker died: reference behavior is silent handler exit; the
            # server keeps serving the others
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            me = threading.current_thread()
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                if me in self._conn_threads:
                    self._conn_threads.remove(me)
                self._conn_of.pop(me, None)


#: event-loop receive chunk: big enough that a steady-state commit frame
#: lands complete in ONE recv (the parser's zero-copy fast path); frames
#: larger than this reassemble through the parser accumulator (correct,
#: just pays copies — docs/TUNING.md)
_RECV_CHUNK = 1 << 20


class _EventConn:
    """Per-connection state on the event loop: a pooled receive scratch
    (``recv_into`` lands every chunk in the same reused memory — no
    per-recv allocation), the incremental frame parser decoding zero-copy
    views over that scratch, and the pending-write queue with its encode
    pool (replies re-serialize into reusable pooled memory).

    Lifetime contract for the decoded views: the loop drains every parsed
    request at the end of the SAME iteration that read it, and the next
    ``recv_into`` on this connection can only happen in a later iteration
    — so the scratch is never overwritten under a live commit.  This is
    the pooled-``recv_data`` contract, per connection."""

    __slots__ = ("sock", "parser", "out", "recv_pool", "send_pool",
                 "want_write", "last_activity")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.parser = networking.FrameParser()
        self.out: List[memoryview] = []
        self.recv_pool = networking.BufferPool()
        self.send_pool = networking.BufferPool()
        self.want_write = False
        #: monotonic instant of the last byte received (half-open reaping:
        #: idle_deadline of silence → the loop drops this connection)
        self.last_activity = time.monotonic()


class SocketParameterServer:
    """The event-driven PS core: ONE I/O thread multiplexes every worker
    connection over a selector (the ``ChaosProxy``-style frame relay idiom,
    turned into the server), with per-connection read/write buffers and
    commit COALESCING.

    Protocol, reply shapes, generation handshake, heartbeat semantics, and
    torn-frame policy are identical to ``ThreadedSocketParameterServer`` —
    the full resilience/elastic/chaos test matrix runs unchanged on this
    core.  What changes is the execution shape:

     - **No thread per connection.**  Accepting, reading, parsing, applying,
       and replying all happen on one thread driving a ``selectors``
       event loop; hundreds of workers cost hundreds of registered fds,
       not hundreds of Python threads fighting the GIL.
     - **Coalesced applies.**  Commits that arrive while an apply is in
       flight accumulate in the kernel's socket buffers; the next loop
       iteration parses them all and applies them as ONE drain — one apply-
       lock acquisition, runs of sparse commits merged into one vectorized
       scatter-add (``ParameterServer.apply_drain``), and the post-drain
       center serialized ONCE with every 'u' reply in the drain sharing
       the same encoded frame (the seed core paid an O(n) snapshot copy
       plus an O(n) encode per commit).  Ordering: commits apply in arrival
       order; DOWNPOUR/ADAG drains are bit-equal to sequential applies,
       DynSGD stamps staleness at enqueue (class docstrings +
       docs/host_ps.md).  ``coalesce=False`` degrades every drain to
       batches of one with a per-commit snapshot — the sequential
       semantics, still on the event loop.
     - **Heartbeats still probe the apply.**  'h' is answered by the same
       thread that applies, after everything queued before it — a server
       wedged inside an apply answers no probe, exactly the property
       ``resilience.ShardSupervisor`` detects wedges by.

    An apply-rule error (hostile shapes, mis-split sparse commit) is logged
    with its traceback and costs the offending drain's connections — the
    loop itself survives, where the threaded core sacrificed one handler
    thread.  ``_conn_threads`` is kept as an (always empty) attribute for
    callers that assert the seed core's per-connection threads unwound.
    """

    def __init__(self, ps: ParameterServer, host: str = "127.0.0.1",
                 port: int = 0, generation: int = 0, coalesce: bool = True,
                 idle_deadline: Optional[float] = None):
        self.ps = ps
        self.host = host
        self.port = port  # 0 → ephemeral; real port set by start()
        # recovery epoch (resilience.ShardSupervisor): bumped on every
        # respawn of this address; replies carry it, older-generation
        # commits are rejected (the epoch/generation handshake)
        self.generation = int(generation)
        self.coalesce = bool(coalesce)
        # half-open reaping (docs/host_ps.md failure matrix): a peer gone
        # without a FIN holds its fd registered forever.  idle_deadline
        # seconds without a received byte reaps the registration (the
        # worker re-dials under its RetryPolicy); None keeps reaping off
        # and only kernel keepalive (always on) eventually notices.
        self.idle_deadline = (None if idle_deadline is None
                              else float(idle_deadline))
        if self.idle_deadline is not None and self.idle_deadline <= 0:
            raise ValueError("idle_deadline must be > 0 (or None)")
        #: connections reaped for idle_deadline silence (observability)
        self.reaped = 0
        self._server: Optional[socket.socket] = None
        self._selector: Optional[selectors.BaseSelector] = None
        self._waker: Optional[tuple] = None  # (recv side, send side)
        #: the I/O thread.  The name is load-bearing: the shard
        #: supervisor's liveness check reads ``_accept_thread.is_alive()``
        #: on either core.
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: Dict[socket.socket, _EventConn] = {}
        self._conn_lock = threading.Lock()  # guards: _conns, _running
        self._conn_threads: List[threading.Thread] = []  # event core: none
        # server-level pool for the drain's SHARED 'u' reply frame (every
        # connection in a drain queues a view of the same encoded bytes)
        self._reply_pool = networking.BufferPool()
        self._running = False
        #: coalescing observability (bench host_ps_worker_scaling + tests):
        #: drains = commit batches applied, commits_applied = commits in
        #: them, coalesced_drains = drains that merged >= 2, max_drain =
        #: largest batch
        self.drains = 0
        self.commits_applied = 0
        self.coalesced_drains = 0
        self.max_drain = 0

    @property
    def coalesce_stats(self) -> Dict[str, Any]:
        return {"drains": self.drains,
                "commits_applied": self.commits_applied,
                "coalesced_drains": self.coalesced_drains,
                "max_drain": self.max_drain,
                "mean_drain": (round(self.commits_applied
                                     / self.drains, 3)
                               if self.drains else None)}

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self.ps.initialize()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self.host, self.port))
        self.port = self._server.getsockname()[1]
        self._server.listen(128)
        self._server.setblocking(False)
        # the waker: a socketpair registered in the selector.  stop()/
        # crash() write one byte to interrupt a blocked select() — no
        # self-connection through the public listener required.
        r, w = socket.socketpair()
        r.setblocking(False)
        self._waker = (r, w)
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._server, selectors.EVENT_READ, None)
        self._selector.register(r, selectors.EVENT_READ, None)
        with self._conn_lock:
            self._running = True
        self._accept_thread = threading.Thread(
            target=self._io_loop, daemon=True, name="dkt-ps-io")
        self._accept_thread.start()

    def _wake(self):
        if self._waker is not None:
            try:
                self._waker[1].send(b"\0")
            except OSError:
                pass

    def stop(self, join_timeout: float = 5.0):
        """Idempotent shutdown, entirely through the event loop.

        The seed core had to wake its blocked ``accept()`` with a
        self-connection to its own port (closing an fd from another thread
        does not reliably interrupt ``accept`` on Linux); the event core
        needs no such hack — the loop blocks in ``select()`` over a
        socketpair waker, so stop() writes one byte, the loop wakes,
        drains the selector, flushes every connection's pending write
        buffer (bounded best-effort), and closes every registered
        connection plus the listener itself.

        A loop that outlives ``join_timeout`` is wedged inside an apply
        (not I/O — the loop never blocks on a socket).  The leak is logged
        and every connection plus the listener is force-closed from here,
        so the wedged thread fails fast on its next socket op and a
        same-address respawn is not blocked by the old listener.
        """
        with self._conn_lock:
            was_running = self._running
            self._running = False
        self._wake()
        t = self._accept_thread
        if t is not None:
            t.join(timeout=join_timeout)
            if t.is_alive():
                logger.warning(
                    "PS I/O thread %s still alive after stop(join_timeout="
                    "%.1fs) — likely wedged in an apply; force-closing its "
                    "connections and listener and leaving it to die "
                    "detached", t.name, join_timeout)
                with self._conn_lock:
                    conns = list(self._conns.values())
                    self._conns.clear()
                for conn in conns:
                    try:
                        conn.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        conn.sock.close()
                    except OSError:
                        pass
        # belt and braces: the loop's own shutdown closes these; after a
        # crash()/wedge they may still be open
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        if was_running is False and t is not None and not t.is_alive():
            self._close_waker()

    def _close_waker(self):
        if self._waker is not None:
            for s in self._waker:
                try:
                    s.close()
                except OSError:
                    pass
            self._waker = None

    @property
    def live_connections(self) -> int:
        """Registered worker connections — the bookkeeping a half-frame
        worker death must decrement (a dying worker's torn commit drops
        its connection silently: no codec error escapes the loop, no
        registration leaks; tests/test_elastic_workers.py)."""
        with self._conn_lock:
            return len(self._conns)

    def crash(self):
        """Abrupt-death simulation (chaos/bench hook): close the listener
        and every connection with no graceful shutdown, no flush, no final
        state — the in-process analogue of a SIGKILLed shard.  The
        in-memory center is deliberately abandoned; recovery must come
        from the last journal snapshot (resilience.ShardSupervisor), the
        bounded-loss contract under test.  The port is released
        immediately so a same-address respawn can bind."""
        with self._conn_lock:
            self._running = False
            conns = list(self._conns.values())
            self._conns.clear()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        for conn in conns:
            networking._hard_close(conn.sock)
        self._wake()

    def get_model(self, device: DeviceLike = None) -> FittedModel:
        return self.ps.get_model(device)

    def respawn_clone(self, ps: ParameterServer) -> "SocketParameterServer":
        """A same-core replacement server on this address with the
        generation bumped and the coalescing knob carried over
        (resilience.ShardSupervisor.respawn_shard)."""
        return SocketParameterServer(ps, host=self.host, port=self.port,
                                     generation=self.generation + 1,
                                     coalesce=self.coalesce,
                                     idle_deadline=self.idle_deadline)

    # -- the event loop ------------------------------------------------------
    def _io_loop(self):
        sel = self._selector
        entries: List[tuple] = []
        # with reaping on, the loop must wake even when every peer is
        # silent — bound the select timeout well inside the deadline
        timeout = (None if self.idle_deadline is None
                   else min(max(self.idle_deadline / 4.0, 0.05), 1.0))
        try:
            while True:
                with self._conn_lock:
                    if not self._running:
                        return
                try:
                    events = sel.select(timeout=timeout)
                except OSError:
                    # fds hard-closed under us (crash()); re-check and exit
                    continue
                if self.idle_deadline is not None:
                    self._reap_idle()
                del entries[:]
                for key, mask in events:
                    if key.fileobj is self._server:
                        self._accept_ready()
                    elif (self._waker is not None
                          and key.fileobj is self._waker[0]):
                        try:
                            self._waker[0].recv(4096)
                        except OSError:
                            pass
                    else:
                        conn = key.data
                        if conn is None:
                            continue
                        if mask & selectors.EVENT_WRITE:
                            self._flush(conn)
                        if mask & selectors.EVENT_READ:
                            self._read_ready(conn, entries)
                if entries:
                    self._process_drain(entries)
        finally:
            self._shutdown_io()

    def _accept_ready(self):
        while True:
            try:
                sock, _ = self._server.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            with self._conn_lock:
                if not self._running:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                try:
                    sock.setblocking(False)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    _enable_keepalive(sock, self.idle_deadline)
                except OSError:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
                conn = _EventConn(sock)
                self._conns[sock] = conn
            try:
                self._selector.register(sock, selectors.EVENT_READ, conn)
            except (KeyError, ValueError, OSError):
                self._drop(conn)

    def _reap_idle(self):
        """Drop every registered connection silent past ``idle_deadline``
        — the event-core half-open reap (the per-connection stamp is the
        last received byte; writes don't count, a peer owing us nothing
        but reading replies still acks into our recv path via the probe
        traffic its client layer sends)."""
        cutoff = time.monotonic() - self.idle_deadline
        with self._conn_lock:
            stale = [c for c in self._conns.values()
                     if c.last_activity < cutoff]
        for conn in stale:
            self.reaped += 1
            logger.info("reaping half-open PS connection (silent > %.1fs)",
                        self.idle_deadline)
            self._drop(conn)

    def _drop(self, conn: _EventConn):
        """Silent connection teardown (EOF, torn frame, protocol
        violation, send fault) — the reference policy: the server keeps
        serving the others, bookkeeping decrements."""
        with self._conn_lock:
            self._conns.pop(conn.sock, None)
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        del conn.out[:]

    def _read_ready(self, conn: _EventConn, entries: List[tuple]):
        while True:
            # direct-fill continuation first: a frame torn across recvs
            # streams straight into the parser's preallocated frame buffer
            # (no chunk copy); otherwise land the bytes in the pooled
            # scratch and let the parser decode zero-copy views over it
            target = conn.parser.writable()
            fed_scratch = target is None
            if fed_scratch:
                target = memoryview(conn.recv_pool.get(_RECV_CHUNK))
            try:
                n = conn.sock.recv_into(target)
            except (BlockingIOError, InterruptedError):
                return
            except (ConnectionError, OSError):
                self._drop(conn)
                return
            if not n:
                self._drop(conn)  # EOF; a partial frame dropped silently
                return
            conn.last_activity = time.monotonic()
            if fed_scratch:
                conn.parser.feed(target[:n])
            else:
                conn.parser.advance(n)
            got = False
            try:
                for op, msg in conn.parser.messages():
                    got = True
                    if op in (b"c", b"u"):
                        msg = self._decode_commit(msg)
                        gen = (msg.get("gen") if isinstance(msg, dict)
                               else None)
                        stale = (gen is not None
                                 and int(gen) != self.generation)
                        if stale and op == b"c":
                            continue  # dropped: bounded loss, no reply owed
                        if not stale and isinstance(msg, dict):
                            # the DynSGD ordering rule: staleness is priced
                            # against the clock at ENQUEUE, so commits
                            # coalesced into one drain don't count each
                            # other
                            msg["_arrival"] = self.ps.num_updates
                        entries.append((conn, op, msg, stale))
                    elif op in (b"p", b"h"):
                        entries.append((conn, op, None, False))
                    else:  # b"q" quit, or protocol violation: drop either
                        self._drop(conn)
                        return
            except ValueError:
                self._drop(conn)  # torn/corrupt frame: drop the connection
                return
            if got:
                # parsed requests may be zero-copy views into this round's
                # scratch — stop before the next recv can overwrite them
                # (the drain at this iteration's end consumes them; a
                # level-triggered selector re-arms for what's left)
                return

    @staticmethod
    def _decode_commit(msg):
        """Transport-boundary decompression + validation, identical to the
        threaded core (``_decode_commit_msg``): int8 dequantization, sparse
        top-k / row-sparse index validation — a ``ProtocolError`` propagates
        as ``ValueError`` to ``_read_ready``'s handler, which drops the
        connection exactly as on a torn frame."""
        return _decode_commit_msg(msg)

    # -- drain processing ----------------------------------------------------
    def _process_drain(self, entries: List[tuple]):
        """One event-loop iteration's parsed requests, in arrival order.
        Maximal runs of commits become coalesced apply batches; pulls and
        heartbeats between them snapshot at their own arrival point."""
        replies: List[tuple] = []
        i, n = 0, len(entries)
        while i < n:
            conn, op, msg, stale = entries[i]
            if op in (b"c", b"u"):
                j = i
                batch = []
                while j < n and entries[j][1] in (b"c", b"u"):
                    batch.append(entries[j])
                    j += 1
                if self.coalesce:
                    self._apply_batch(batch, replies)
                else:
                    for e in batch:  # sequential semantics, per-commit
                        self._apply_batch([e], replies)
                i = j
            elif op == b"p":
                reply = self.ps.handle_pull()
                reply["gen"] = self.generation
                replies.append((conn, reply))
                i += 1
            else:  # b"h": through the apply path, as the threaded core's
                # heartbeat went through the apply lock — a wedged apply
                # blocks this loop and the probe times out
                reply = self.ps.handle_heartbeat()
                reply["gen"] = self.generation
                replies.append((conn, reply))
                i += 1
        for conn, obj in replies:
            self._queue_reply(conn, obj)

    def _apply_batch(self, batch: List[tuple], replies: List[tuple]):
        """Apply one commit batch under ONE lock acquisition and serialize
        the center ONCE for every 'u' reply in it.  The shared post-drain
        center is each commit's own result plus any commits that landed in
        the same drain — a strictly fresher center of the same bounded-
        staleness class the async rules already tolerate (docs/host_ps.md).

        The reply is encoded straight from the live center *under the
        apply lock* — the encoded frame IS the snapshot, so a drain pays
        one O(n) serialization total where the threaded core pays a
        snapshot copy plus an encode per commit.  The shared bytes are
        immutable; every involved connection queues a view of the same
        frame."""
        live = [e[2] for e in batch if not e[3]]
        pulls = [e for e in batch if e[1] == b"u"]
        encoded = encoded_stale = None
        try:
            with self.ps._lock:
                if live:
                    self.ps._apply_drain_locked(live)
                if pulls:
                    reply = {"weights": self.ps.center,
                             "clock": self.ps.num_updates,
                             "gen": self.generation}
                    if any(not e[3] for e in pulls):
                        encoded = self._encode_shared(reply)
                    if any(e[3] for e in pulls):
                        reply["stale"] = True
                        encoded_stale = networking.encode_message(reply)
        except Exception:
            # a hostile/mis-split commit must not kill the loop (the
            # threaded core sacrificed one handler thread; here the
            # offending drain's connections pay instead)
            logger.exception(
                "PS apply failed for a drain of %d commits; dropping the "
                "%d involved connections", len(live),
                len({id(e[0]) for e in batch}))
            for e in batch:
                self._drop(e[0])
            return
        if live:
            self.drains += 1
            self.commits_applied += len(live)
            if len(live) >= 2:
                self.coalesced_drains += 1
            self.max_drain = max(self.max_drain, len(live))
        for conn, op, msg, stale in pulls:
            replies.append((conn, encoded_stale if stale else encoded))

    def _encode_shared(self, reply) -> memoryview:
        """Serialize the drain's shared 'u' reply, into the server-level
        pooled buffer when it is provably free — i.e. no connection holds
        a pending (possibly pooled) write — else into fresh bytes.  In
        steady state replies flush synchronously (loopback/LAN socket
        buffers dwarf a frame), so every drain reuses the same memory; a
        backpressured connection downgrades the next drains to fresh
        allocations until it flushes."""
        with self._conn_lock:
            pool_free = all(not c.out for c in self._conns.values())
        if pool_free:
            return networking.encode_message_into(reply, self._reply_pool)
        return memoryview(networking.encode_message(reply))

    # -- the write path ------------------------------------------------------
    def _queue_reply(self, conn: _EventConn, obj):
        """Queue one reply.  ``obj`` is either a message dict ('p'/'h'
        replies, encoded into this connection's pooled send buffer) or the
        drain's pre-encoded shared 'u' frame (immutable bytes — many
        connections may hold views of the same frame)."""
        with self._conn_lock:
            if conn.sock not in self._conns:
                return  # dropped while its reply was being built
        if isinstance(obj, (bytes, memoryview)):
            data = memoryview(obj)
        elif conn.out:
            # the pooled buffer still backs an in-flight reply (a client
            # pipelining past the request/reply contract): fresh bytes
            data = memoryview(networking.encode_message(obj))
        else:
            data = memoryview(networking.encode_message_into(
                obj, conn.send_pool))
        conn.out.append(data)
        self._flush(conn)

    def _flush(self, conn: _EventConn):
        while conn.out:
            buf = conn.out[0]
            try:
                sent = conn.sock.send(buf)
            except (BlockingIOError, InterruptedError):
                break
            except (ConnectionError, OSError):
                self._drop(conn)
                return
            if sent < len(buf):
                conn.out[0] = buf[sent:]
                break
            conn.out.pop(0)
        want = bool(conn.out)
        if want != conn.want_write:
            conn.want_write = want
            mask = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if want else 0)
            try:
                self._selector.modify(conn.sock, mask, conn)
            except (KeyError, ValueError, OSError):
                pass

    def _shutdown_io(self):
        """Loop exit path: flush pending write buffers (bounded best
        effort), close every registered connection, the listener, the
        selector, and the waker."""
        with self._conn_lock:
            conns = list(self._conns.values())
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
            try:
                conn.sock.close()
            except OSError:
                pass
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        if self._selector is not None:
            try:
                self._selector.close()
            except OSError:
                pass
        self._close_waker()


#: the selectable PS server cores (``ps_core=`` on the async trainers)
PS_CORES = {"event": SocketParameterServer,
            "threaded": ThreadedSocketParameterServer}


def make_socket_server(ps: ParameterServer, host: str = "127.0.0.1",
                       port: int = 0, generation: int = 0,
                       ps_core: str = "event", coalesce: bool = True,
                       idle_deadline: Optional[float] = None):
    """Construct the selected PS server core around ``ps``.  ``coalesce``
    only applies to the event core (the threaded core has no drain);
    ``idle_deadline`` enables half-open reaping on either core."""
    if ps_core not in PS_CORES:
        raise ValueError(
            f"ps_core must be one of {sorted(PS_CORES)}, got {ps_core!r}")
    if ps_core == "threaded":
        return ThreadedSocketParameterServer(ps, host=host, port=port,
                                             generation=generation,
                                             idle_deadline=idle_deadline)
    return SocketParameterServer(ps, host=host, port=port,
                                 generation=generation, coalesce=coalesce,
                                 idle_deadline=idle_deadline)


PS_CLASSES = {
    "downpour": DeltaParameterServer,
    "adag": ADAGParameterServer,
    "dynsgd": DynSGDParameterServer,
    "aeasgd": DeltaParameterServer,
    "eamsgd": DeltaParameterServer,
}

#: bind addresses that are listenable but not dialable — an advertise
#: host must never default to one of these
_WILDCARD_HOSTS = ("0.0.0.0", "::", "")


def resolve_ps_hosts(trainer) -> tuple:
    """The (bind, advertise) PS address pair for one training run.

    ``ps_bind_host`` is where the socket server listens; ``ps_advertise_host``
    is what the workers' config (and any ``attach_ps`` engine) dials.
    Advertise defaults to the bind host — except when the bind is a
    wildcard, which is listenable but not dialable, so the default falls
    back to loopback (multi-host callers bind ``"0.0.0.0"`` and advertise
    ``networking.determine_host_address()`` — docs/DEPLOY.md).  Both
    default to the historical loopback, bit for bit."""
    bind = getattr(trainer, "ps_bind_host", None) or "127.0.0.1"
    advertise = getattr(trainer, "ps_advertise_host", None)
    if advertise is None:
        advertise = "127.0.0.1" if bind in _WILDCARD_HOSTS else bind
    return bind, advertise


def allocate_parameter_server(algorithm: str, model_blob: dict,
                              num_workers: int,
                              apply_kernel: Optional[str] = None
                              ) -> ParameterServer:
    """Factory (reference: ``DistributedTrainer.allocate_parameter_server``)."""
    cls = PS_CLASSES[algorithm]
    if cls is ADAGParameterServer:
        return cls(model_blob, num_workers, apply_kernel=apply_kernel)
    return cls(model_blob, apply_kernel=apply_kernel)


def run_host_ps_training(trainer, dataset, shuffle: bool = False,
                         resume: bool = False) -> FittedModel:
    """Execute a DistributedTrainer with true async semantics: a live socket
    PS on loopback + one worker thread per "executor", each driving its
    window program on the trainer's device (the CUDA card unless the
    trainer was given ``device="cpu"``).

    ``num_workers × parallelism_factor`` counts worker threads, all on the
    trainer's one device.  Each worker owns its model, its optimizer state
    and its generator (``workers.share_compiled_state`` shares only what is
    read-only); all of them launch on the device's default stream, so the
    card runs their windows one after another.

    Checkpoint/resume (epoch granularity): training runs as epoch *waves* —
    all worker threads are joined between epochs, at which point the full
    async state (PS center weights + update clock + every worker's params
    and optimizer state) is consistent and saved by the npz
    ``Checkpointer``.  Within an epoch commits stay truly asynchronous;
    bit-exact resume holds only where the interleaving is fixed (one
    worker) — the deterministic path is ``execution='spmd'``.

    ``recovery=True`` puts the center behind a ``ShardedServerGroup`` for
    any shard count (the one-shard plan is the identity partition) with a
    ``resilience.ShardSupervisor`` (``trainer._ps_supervisor``) that
    journals and respawns shards; the workers reconnect-resume.
    ``fault_tolerance=True`` finishes on the surviving workers
    (``trainer.failed_workers``, ``worker_failures``); ``elastic=True``
    replaces the static deal with leases (``_run_elastic_host_ps``).
    """
    algorithm = trainer.ALGORITHM
    if algorithm not in WORKER_CLASSES:
        raise ValueError(
            f"execution='host_ps' supports PS algorithms "
            f"{sorted(WORKER_CLASSES)}, not {algorithm!r} "
            f"({type(trainer).__name__})")
    if getattr(trainer, "checkpoint_unit", "epoch") == "round":
        raise ValueError(
            "checkpoint_unit='round' requires execution='spmd'; the host_ps "
            "path checkpoints at epoch waves")
    if resume and trainer.checkpoint_dir is None:
        raise ValueError("train(resume=True) needs checkpoint_dir")
    elastic = bool(getattr(trainer, "elastic", False))
    fault_kinds = parse_fault_injection(getattr(trainer, "fault_injection",
                                                None))
    if elastic and (resume or trainer.checkpoint_dir is not None):
        raise ValueError(
            "elastic=True owns its own lease-based epoch loop and does not "
            "compose with checkpoint/resume yet — use elastic=False for "
            "checkpointed host_ps runs")
    if not elastic and any(k == "hang" for k, _ in fault_kinds.values()):
        raise ValueError(
            "fault_injection kind 'hang' wedges a worker until teardown; "
            "without elastic=True nothing ever revokes its work and the "
            "epoch join would deadlock — use elastic=True (or kinds "
            "'raise'/'exit')")

    trainer.record_training_start()
    trainer.failed_workers = []
    trainer.worker_failures = {}
    trainer.elastic_stats = {}
    x = np.asarray(dataset[trainer.features_col])
    y = np.asarray(dataset[trainer.label_col])
    if shuffle:
        perm = np.random.default_rng(trainer.seed).permutation(len(x))
        x, y = x[perm], y[perm]
    model0 = trainer._initial_params(x.shape[1:])
    blob = serialize_model(model0)

    # reference parity (SURVEY §2.1 row 6): async trainers may run
    # parallelism_factor x num_workers concurrent tasks against the PS
    n = trainer.num_workers * getattr(trainer, "parallelism_factor", 1)
    # deal rows round-robin per worker (Spark round-robin repartition
    # analogue): every row lands on exactly one worker, nothing dropped;
    # shard sizes differ by at most one row and the workers' own
    # window-padding absorbs the raggedness
    if len(x) < n:
        raise ValueError(
            f"dataset of {len(x)} rows has fewer rows than workers ({n})")
    xs = [x[i::n] for i in range(n)]
    ys = [y[i::n] for i in range(n)]
    bind_host, advertise_host = resolve_ps_hosts(trainer)
    ps_shards = int(getattr(trainer, "ps_shards", 1) or 1)
    recovery = bool(getattr(trainer, "recovery", False))
    ps_core = getattr(trainer, "ps_core", "event") or "event"
    coalesce = bool(getattr(trainer, "coalesce", True))
    apply_kernel = getattr(trainer, "apply_kernel", None)
    # recovery routes through the ShardedServerGroup for ANY shard count
    # (the one-shard plan is the identity partition, bit-identical), so
    # there is one supervised lifecycle: servers held in a list the
    # supervisor can respawn into
    sharded = ps_shards > 1 or recovery
    if sharded:
        # PS sharding (ps_sharding.py): the center partitioned over N shard
        # servers, each wrapping the UNCHANGED apply rule on its slice with
        # its own lock and clock, so staleness is per-shard identical to
        # the single-PS path
        server = ShardedServerGroup(algorithm, blob, n, ps_shards,
                                    host=bind_host, ps_core=ps_core,
                                    coalesce=coalesce,
                                    apply_kernel=apply_kernel)
        ps = None
    else:
        ps = allocate_parameter_server(algorithm, blob, n,
                                       apply_kernel=apply_kernel)
        server = make_socket_server(ps, host=bind_host, ps_core=ps_core,
                                    coalesce=coalesce)
    supervisor = ckpt = None
    try:
        server.start()
        trainer._ps_server = server  # observability: the clock (smoke run)
        if recovery:
            # periodic per-shard snapshots + heartbeat-driven respawn from
            # the last snapshot on the same address; windows committed
            # after a shard's last snapshot are dropped (bounded loss)
            supervisor = ShardSupervisor(server, algorithm, n)
            supervisor.start()
        trainer._ps_supervisor = supervisor  # observability (tests, smoke)
        kw = _worker_kwargs(trainer, n, len(x))
        kw.update(worker_optimizer=trainer.worker_optimizer,
                  ps_host=advertise_host,
                  ps_port=server.ports[0] if sharded else server.port,
                  device=trainer.device)
        rs = getattr(trainer, "row_sparse", None)
        if rs:
            # row-sparse embedding commits: True = every Embedding table
            # of the model, or explicit weight indices
            from .streaming import resolve_row_sparse_tables
            kw.update(row_sparse_tables=resolve_row_sparse_tables(
                rs, model0))
        if sharded:
            # workers scatter-commit / gather-pull through a
            # ShardedPSClient; _shard_addr_hook lets a test interpose a
            # proxy per shard (the supervisor heartbeats the shards
            # directly)
            addrs = [(advertise_host, int(p)) for _, p in server.addrs]
            hook = getattr(trainer, "_shard_addr_hook", None)
            if hook is not None:
                addrs = [(str(h), int(p)) for h, p in hook(list(addrs))]
            kw.update(shard_plan=server.plan, shard_addrs=addrs)
        if recovery:
            kw.update(recovery=True,
                      retry_policy=getattr(trainer, "recovery_policy", None))
        worker_cls = WORKER_CLASSES[algorithm]
        if elastic:
            # lease-based redistribution, death-respawn and straggler
            # stealing replace the static deal and the epoch waves below
            workers = _run_elastic_host_ps(trainer, x, y, n, worker_cls,
                                           blob, kw, server, supervisor)
        else:
            workers = [worker_cls(blob, **kw) for _ in range(n)]
            share_compiled_state(workers)
            trainer._ps_workers = workers  # observability: counters
            if trainer.checkpoint_dir is not None:
                from .checkpoint import make_checkpointer
                ckpt = make_checkpointer(trainer.checkpoint_dir,
                                         trainer.checkpoint_backend)
            _run_static_waves(trainer, server, ps, workers, xs, ys,
                              ps_shards, resume, supervisor, ckpt)
    finally:
        if supervisor is not None:
            # stop the supervisor FIRST: the group teardown below must not
            # read as N shard deaths and trigger a respawn storm
            supervisor.stop()
        server.stop()
        # coalescing observability: counters survive the stop; None on
        # the threaded core
        trainer.ps_coalesce_stats = getattr(server, "coalesce_stats", None)
        if ckpt is not None:
            ckpt.close()

    trainer.history.clear()
    for w in workers:
        trainer.history.extend(w.history)
    fitted = server.get_model(device=trainer.device)
    trainer._fitted = fitted
    trainer.record_training_stop()
    return fitted


def _run_static_waves(trainer, server, ps, workers, xs, ys, ps_shards: int,
                      resume: bool, supervisor, ckpt) -> None:
    """The static engine: every worker trains its round-robin shard, as
    one fully-async wave without a checkpointer or as epoch waves with the
    joined state saved to ``ckpt`` between them (resumed from it first
    when ``resume`` asks and it holds a step)."""
    n = len(workers)
    sharded = ps is None
    states: List[Any] = [None] * n

    def full_state():
        """The complete async-training state: the center, the clock and
        every worker's (params, optimizer state).  Sharded runs store
        the GATHERED center and the per-shard clock vector, so the
        layout is shard-count-explicit (resume checks it against this
        run's ps_shards through the meta)."""
        if sharded:
            center, clocks = server.snapshot()
            clock = np.asarray(clocks, np.int64)
        else:
            with ps._lock:
                center = [w.copy() for w in ps.center]
                clock = np.int64(ps.num_updates)
        return {"center": center, "clock": clock,
                "workers": [tuple(s) for s in states]}

    start_epoch = 0
    if ckpt is not None:
        from .checkpoint import foreign_checkpoints
        backend = trainer.checkpoint_backend
        latest = ckpt.latest_step()
        if resume and latest is None:
            foreign = foreign_checkpoints(trainer.checkpoint_dir, backend)
            if foreign:
                raise ValueError(
                    f"resume=True with checkpoint_backend={backend!r}, "
                    f"but {trainer.checkpoint_dir} holds steps {foreign} "
                    "written by the other backend — resuming now would "
                    "silently retrain from scratch; use the backend that "
                    "wrote the checkpoints")
        if resume and latest is not None:
            meta = ckpt.read_meta(latest)
            if meta.get("engine", "spmd") != "host_ps":
                raise ValueError(
                    f"checkpoint at {trainer.checkpoint_dir} was saved "
                    f"by engine={meta.get('engine', 'spmd')!r}; this "
                    "trainer is host_ps — resume with the same "
                    "configuration")
            if int(meta.get("ps_shards", 1)) != ps_shards:
                raise ValueError(
                    f"checkpoint was saved with ps_shards="
                    f"{meta.get('ps_shards', 1)}; this trainer has "
                    f"ps_shards={ps_shards} — resume with the same "
                    "configuration")
            # a template of the right structure, then refill: the
            # restored tensors land on the trainer's device
            states = [w.state_template() for w in workers]
            restored = ckpt.restore(full_state(), latest)
            if sharded:
                server.restore_state(restored["center"],
                                     restored["clock"])
            else:
                with ps._lock:
                    ps.center = [np.asarray(w, np.float32)
                                 for w in restored["center"]]
                    ps.num_updates = int(restored["clock"])
            states = [tuple(s) for s in restored["workers"]]
            start_epoch = latest

    # Without checkpointing there is no reason to barrier between epochs:
    # each worker runs all its epochs in one fully-async wave (one
    # connect, no stragglers at epoch joins) — the reference execution
    # model.  With a checkpoint_dir, epochs run as waves and the joined
    # state is saved.
    if ckpt is None:
        waves = [None]  # one wave, all epochs (worker default)
    else:
        waves = [(e, e + 1) for e in range(start_epoch, trainer.num_epoch)]
    alive = [True] * n
    for epoch_range in waves:
        results: List[Optional[dict]] = [None] * n
        errors: List[tuple] = []
        mark = _applied_mark(server, workers)

        def run(i, epoch_range=epoch_range):
            try:
                results[i] = workers[i].train(
                    i,
                    {trainer.features_col: xs[i], trainer.label_col: ys[i]},
                    initial_state=states[i], epoch_range=epoch_range)
            except BaseException as e:  # propagate to the trainer's thread
                errors.append((i, e))

        threads = [threading.Thread(target=run, args=(i,),
                                    name=f"dkt-worker-{i}")
                   for i in range(n) if alive[i]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            _settle_errors(trainer, errors, alive)
        _await_applied(server, lambda: _landing_targets(
            server, workers, mark, supervisor))
        states = [r["state"] if r is not None else states[i]
                  for i, r in enumerate(results)]
        if ckpt is not None and (
                epoch_range[1] % trainer.checkpoint_every == 0):
            ckpt.save(epoch_range[1], full_state(),
                      meta={"engine": "host_ps", "unit": "epoch",
                            "ps_shards": ps_shards})


def _settle_errors(trainer, errors: List[tuple], alive: List[bool]) -> None:
    """A wave's worker errors: a dead shard surfaces as itself, a death
    without ``fault_tolerance`` raises (an 'exit' as a RuntimeError, never
    as the process's own exit), and under ``fault_tolerance`` the dead are
    recorded with their tracebacks and the run goes on with the
    survivors (all of them dead raises)."""
    # a dead SHARD is not a dead worker: it holds a partition of the
    # center that no survivor can reconstruct, so degraded completion is
    # impossible — surface it regardless of fault_tolerance
    shard_err = next((e for _, e in errors if isinstance(e, PSShardDown)),
                     None)
    if shard_err is not None:
        raise shard_err
    if not getattr(trainer, "fault_tolerance", False):
        i, err = errors[0]
        if isinstance(err, SystemExit):
            raise RuntimeError(f"worker {i} exited: {err}") from err
        raise err
    # degraded completion (the reference relied on Spark retry; we go on
    # with the survivors, and the center keeps every commit applied before
    # the death).  A tolerated death stays diagnosable: the traceback text
    # on the trainer and a line on stderr.
    for i, e in errors:
        alive[i] = False
        if i not in trainer.failed_workers:
            trainer.failed_workers.append(i)
            trainer.worker_failures[i] = "".join(
                traceback.format_exception(e)).strip()
        print(f"[distkeras_tpu_torch] worker {i} died ({e!r}); "
              "fault_tolerance: continuing with survivors", file=sys.stderr)
    if not any(alive):
        raise RuntimeError(
            f"all {len(alive)} workers failed (fault_tolerance can survive "
            "some, not all)") from errors[0][1]


def _time_first_window(head, x, y) -> float:
    """One masked window of ``head`` (``compile_windows``), timed in a
    fresh thread: the seed of a lease ledger's cold estimate.  The JAX
    estimate is generous because its window pays the compile; the port's
    counterpart is a thread's first window (its cuDNN and cuBLAS handles,
    its convolution algorithms), so it is timed in a thread of its own."""
    warm: Dict[str, Any] = {}

    def time_window():
        try:
            warm["seconds"] = head.compile_windows(x, y)
        except BaseException as e:  # re-raised in the caller's thread
            warm["error"] = e

    th = threading.Thread(target=time_window, name="dkt-elastic-warmup")
    th.start()
    th.join()
    if "error" in warm:
        raise warm["error"]
    return warm["seconds"]


class _LeaseLoop:
    """The lease engine that the elastic epoch engine
    (``_run_elastic_host_ps``) and the streaming horizon loop
    (``streaming.run_stream_training``) share: one ``LeaseLedger`` seeded
    by a window timed in a fresh thread (× ``n`` for the n-way
    contention), a ``WorkerSupervisor`` over ``n`` worker threads (the
    first built here, every later one — respawns included — built by the
    factory; each warmed in its own thread before its first lease, off
    the ledger clock), and per pass (an epoch or a horizon, ``run``) the
    wait for every commit that can still land before the exactly-once
    contract is asserted.  ``close`` shuts the supervisor down and
    publishes ``elastic_stats``, ``failed_workers``, ``worker_failures``
    and ``_ps_workers`` on the trainer."""

    def __init__(self, trainer, n: int, worker_cls, blob: dict, kw: dict,
                 server, supervisor, x0, y0, lease_windows: int):
        self.server, self.supervisor = server, supervisor
        win_rows = trainer.communication_window * trainer.batch_size
        head = worker_cls(blob, **kw)
        t_window = _time_first_window(head, x0, y0)
        self.ledger = LeaseLedger(
            len(x0), win_rows, lease_windows,
            min_deadline=getattr(trainer, "lease_timeout", 5.0),
            default_window_s=t_window * n)

        def factory(wid: int):
            w = head if wid == 0 else worker_cls(blob, **kw)
            share_compiled_state([head, w])  # the update rule, top-k layout
            return w

        self.data: Dict[str, Any] = {}
        self._warmed: set = set()
        self.sup = WorkerSupervisor(self.ledger, factory, self._run_worker,
                                    n)
        trainer._worker_supervisor = self.sup  # observability (tests, smoke)
        self.reports: Dict[int, Any] = {}

    def _run_worker(self, wid: int, worker):
        xe, ye = self.data["x"], self.data["y"]
        if wid not in self._warmed:
            # a worker's first window in its own thread also builds that
            # thread's cuDNN and cuBLAS handles and picks its convolution
            # algorithms (the JAX program compiles once for every thread):
            # warm each worker in its thread before its first lease, off
            # the ledger clock, or a healthy worker reads as wedged
            worker.compile_windows(xe, ye)
            self._warmed.add(wid)

        def data_fn(lease):
            return xe[lease.start:lease.stop], ye[lease.start:lease.stop]

        res = worker.train_leases(wid, self.ledger, data_fn,
                                  initial_state=self.sup.states.get(wid))
        self.sup.states[wid] = res["state"]
        return res

    def run(self, index: int, x, y) -> Dict[str, Any]:
        """One ledger pass over the rows ``x``, ``y`` (already shuffled):
        the workers drain its leases, the server applies every commit
        that can still land (a lease loop's last commit may be a
        fire-and-forget 'c'), and the pass's exactly-once report is
        asserted and returned."""
        self.data["x"], self.data["y"] = x, y
        mark = _applied_mark(self.server, list(self.sup.workers.values()))
        self.sup.run_epoch(index)
        _await_applied(self.server, lambda: _landing_targets(
            self.server, list(self.sup.workers.values()), mark,
            self.supervisor))
        self.reports[index] = self.ledger.assert_epoch_complete(index)
        return self.reports[index]

    def close(self, trainer) -> list:
        """Release 'hang'-faulted threads, join stragglers and publish the
        run's observability; returns every worker (original ids and
        respawns, id order) for history collection."""
        sup = self.sup
        sup.shutdown()
        trainer.failed_workers = sorted(sup.failures)
        trainer.worker_failures = dict(sup.failures)
        trainer.elastic_stats = {
            "respawns": sup.respawns,
            "respawn_records": list(sup.respawn_records),
            "leases_reassigned": self.ledger.reassigned,
            "windows_per_worker": dict(self.ledger.windows_by_worker),
            "lease_completions": self.reports,
            "events": list(sup.events),
        }
        workers = [sup.workers[wid] for wid in sorted(sup.workers)]
        trainer._ps_workers = workers
        return workers


def _run_elastic_host_ps(trainer, x, y, n: int, worker_cls, blob: dict,
                         kw: dict, server, supervisor):
    """The elastic worker engine (``elastic=True``).

    Replaces the static round-robin deal with a per-epoch ``LeaseLedger``:
    the epoch's rows are globally shuffled (``default_rng(seed + 7919 ·
    epoch)``, the JAX engine's permutation) and tiled into window-aligned
    leases that the worker threads acquire, renew and complete; a
    ``WorkerSupervisor`` revokes the leases of dead or wedged workers
    (survivors steal them) and respawns replacements under fresh ids from
    a live center pull (``_LeaseLoop``).  After every epoch the server has
    applied every commit that can still land and the ledger's
    exactly-once contract is asserted: killing k of N workers mid-epoch
    loses zero examples.

    Returns the full worker list (original ids + respawns, id order) for
    history collection; observability lands on the trainer as
    ``elastic_stats``, ``failed_workers``, ``worker_failures``,
    ``_worker_supervisor`` and ``_ps_workers``.
    """
    win_rows = trainer.communication_window * trainer.batch_size
    total_windows = -(-len(x) // win_rows)
    lease_windows = getattr(trainer, "lease_windows", None)
    if lease_windows is None:
        # ~4 leases per worker per epoch: enough granularity for stealing
        # and respawn pickup without drowning in ledger round trips
        lease_windows = max(1, total_windows // (4 * n))
    loop = _LeaseLoop(trainer, n, worker_cls, blob, kw, server, supervisor,
                      x, y, lease_windows)
    try:
        for epoch in range(trainer.num_epoch):
            # global per-epoch shuffle: leases are contiguous row ranges of
            # this permutation, so lease boundaries resample every epoch
            perm = np.random.default_rng(
                trainer.seed + 7919 * epoch).permutation(len(x))
            loop.run(epoch, x[perm], y[perm])
    finally:
        workers = loop.close(trainer)
    return workers


def _servers(server) -> list:
    """The socket servers behind ``server``: its shards, or itself."""
    return list(getattr(server, "servers", [server]))


def _clocks(server) -> List[int]:
    """The update clock of a socket server, or of each shard of a
    ``ShardedServerGroup``."""
    return [s.ps.num_updates for s in _servers(server)]


def _sent(workers, shard: int, gen: Optional[int]) -> int:
    """Commits the workers sent ``shard`` stamped with generation ``gen``
    (plus unstamped ones), less those whose connection died unanswered."""
    out = 0
    for w in workers:
        sent = getattr(w, "sent_by_gen", {})
        out += sent.get((shard, gen), 0) + sent.get((shard, None), 0)
    return out


def _applied_mark(server, workers) -> tuple:
    """Where a wave's wait starts from: each server's generation and
    clock, and the commits already sent to it at that generation."""
    gens = [s.generation for s in _servers(server)]
    return (gens, _clocks(server),
            [_sent(workers, j, g) for j, g in enumerate(gens)])


def _landing_targets(server, workers, mark: tuple,
                     supervisor=None) -> List[Optional[int]]:
    """The clock each server reaches once every commit that can still land
    has applied: a server still at the generation of ``mark`` adds the
    commits sent since then to its clock then; a respawned one starts
    from its restored clock (the supervisor's record) and adds every
    commit sent at its generation.  A commit stamped with an older
    generation is rejected and one a fault aborted was never sent, so
    neither counts.  None: the respawn record is not written yet."""
    gens0, clocks0, sent0 = mark
    out: List[Optional[int]] = []
    for j, s in enumerate(_servers(server)):
        g = s.generation
        sent = _sent(workers, j, g)
        if g == gens0[j]:
            out.append(clocks0[j] + sent - sent0[j])
            continue
        recs = [r for r in getattr(supervisor, "recoveries", [])
                if r["shard"] == j and r["generation"] == g]
        out.append(recs[-1]["restored_clock"] + sent if recs else None)
    return out


def _await_clocks(read, timeout: float = 30.0) -> None:
    """Poll ``read() -> (clocks, targets)`` until every clock has reached
    its target (None on either side: not known yet); a shortfall left at
    ``timeout`` is logged, not waited for."""
    deadline = time.monotonic() + timeout
    while True:
        have, want = read()
        if all(c is not None and w is not None and c >= w
               for c, w in zip(have, want)):
            return
        if time.monotonic() > deadline:
            logger.warning("PS clocks %s short of the %s commits sent",
                           have, want)
            return
        time.sleep(0.001)


def _await_applied(server, clocks: List[Optional[int]],
                   timeout: float = 30.0) -> None:
    """Wait until the server (each shard) has applied commits up to
    ``clocks``.  A worker's last commit on a serial loop is a
    fire-and-forget 'c': when its thread joins, the frame may still sit in
    the server's socket buffer, and a center read then (a checkpoint, the
    fitted model) would miss it.  A server that does not get there within
    ``timeout`` is logged, not waited for.  ``clocks`` may be a callable
    that recomputes the targets (a shard can respawn while we wait)."""
    _await_clocks(lambda: (_clocks(server),
                           clocks() if callable(clocks) else clocks),
                  timeout)


def _worker_kwargs(trainer, n: int, rows: int) -> dict:
    """Worker construction kwargs: the LR-schedule horizon formula and the
    elastic rho special-case.

    Schedule horizon per worker: the largest shard has ceil(rows/n) rows →
    windows/epoch × window mini-steps × epochs, ceil-divided by the
    accumulation factor (workers differ by at most one window).
    """
    accum = getattr(trainer, "gradient_accumulation", 1)
    win = trainer.communication_window
    shard_rows = -(-rows // n)
    windows_pe = -(-shard_rows // (win * trainer.batch_size))
    kw = dict(
        loss=trainer.loss, communication_window=win,
        features_col=trainer.features_col, label_col=trainer.label_col,
        batch_size=trainer.batch_size, num_epoch=trainer.num_epoch,
        learning_rate=trainer.learning_rate, seed=trainer.seed,
        lr_schedule=getattr(trainer, "lr_schedule", None),
        schedule_steps=-(-windows_pe * win * trainer.num_epoch // accum),
        gradient_accumulation=accum,
        gradient_clip_norm=getattr(trainer, "gradient_clip_norm", None),
        wire_dtype=getattr(trainer, "wire_dtype", None),
        wire_topk=getattr(trainer, "wire_topk", 0.01),
        wire_topk_dtype=getattr(trainer, "wire_topk_dtype", None),
        comm_overlap=getattr(trainer, "comm_overlap", False),
        fault_injection=getattr(trainer, "fault_injection", None))
    pw = int(getattr(trainer, "partition_windows", 0) or 0)
    if pw:
        kw["partition_windows"] = pw
    if trainer.ALGORITHM in ("aeasgd", "eamsgd"):
        kw["rho"] = getattr(trainer, "rho", 5.0)
    return kw


# ---------------------------------------------------------------------------
# the cross-process engine: worker (and shard) OS processes
# ---------------------------------------------------------------------------

class _ChildResult:
    """What a worker process left in its result file
    (``ps_worker_main.write_result``): its window losses, the commits it
    sent by (shard, generation) (``sent_by_gen``, read by ``_sent``) and
    its kernel launch counters (a JAX worker's file has its losses
    only)."""

    def __init__(self, worker_id: int, path: str):
        with np.load(path) as z:
            self.history = z["history"].tolist()
            sent = z["sent"] if "sent" in z.files else np.zeros((0, 3))
            names = z["launch_names"] if "launch_names" in z.files else []
            counts = z["launches"] if "launches" in z.files else []
            compiles = (int(z["native_compiles"])
                        if "native_compiles" in z.files else 0)
            span = (z["train_span"].tolist() if "train_span" in z.files
                    else None)
        self.worker_id = int(worker_id)
        self.sent_by_gen = {(int(j), None if int(g) < 0 else int(g)): int(c)
                            for j, g, c in sent}
        self.launches = {str(k): int(n) for k, n in zip(names, counts)}
        #: host-extension compiles the child ran (0: it loaded the build)
        self.native_compiles = compiles
        #: (start, end) on the host's wall clock of the child's training
        self.train_span = span


def _sum_launches(results: List[_ChildResult]) -> Dict[str, int]:
    """The children's kernel launches, summed counter by counter (each
    process counts its own)."""
    total: Dict[str, int] = {}
    for r in results:
        for k, v in r.launches.items():
            total[k] = total.get(k, 0) + v
    return total


def _child_env() -> Dict[str, str]:
    """The repo root on ``PYTHONPATH``, so ``-m distkeras_tpu_torch.<main>``
    resolves in a child without an installed package (the children
    inherit the rest of ``os.environ``)."""
    import os
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {"PYTHONPATH": os.pathsep.join(
        p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p)}


def _backend_flags() -> Dict[str, bool]:
    """The driver's process-wide numerics switches, which a worker thread
    shares and a worker process must be given: TF32 in matmuls and
    convolutions, cuDNN's deterministic and benchmark choices, and the
    intra-op thread count (on the CPU it sets the order of a reduction)
    (``ps_worker_main`` applies them before it builds its model)."""
    return {
        "num_threads": int(torch.get_num_threads()),
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
        "cudnn_deterministic": bool(torch.backends.cudnn.deterministic),
        "cudnn_benchmark": bool(torch.backends.cudnn.benchmark)}


def _await_shard_processes(addrs, addr_dir: str,
                           results: List[_ChildResult],
                           timeout: float = 30.0) -> None:
    """``_await_applied`` for shards in their own processes: each shard's
    (generation, clock) comes from an ``'h'`` probe, and its target is the
    clock its generation started from (``ps_shard_main.read_restored``)
    plus the commits the workers sent it at that generation."""
    from .ps_shard_main import read_restored

    def read():
        have, want = [], []
        for j, (h, p) in enumerate(addrs):
            probe = wire_probe(h, p, timeout=2.0)
            start = (None if probe is None
                     else read_restored(addr_dir, j, probe[0]))
            have.append(None if probe is None else probe[1])
            want.append(None if start is None
                        else start + _sent(results, j, probe[0]))
        return have, want

    _await_clocks(read, timeout)


def run_process_ps_training(trainer, dataset, shuffle: bool = False
                            ) -> FittedModel:
    """Execute a DistributedTrainer with workers as separate OS PROCESSES
    (``execution="process_ps"``).

    The driver hosts the socket PS (one server, or a ``ShardedServerGroup``
    with ``ps_shards > 1``); each worker is its own interpreter
    (``python -m distkeras_tpu_torch.ps_worker_main``) launched through
    ``job_deployment.Job`` and ``LocalJobRunner`` on loopback,
    uncoordinated, and shares nothing with the driver but the socket.  Its
    device is the trainer's (``"cuda"`` on the card: the children's CUDA
    contexts time-slice the one card; ``"cpu"`` in tests).  The model blob
    and the round-robin shards (the thread engine's deal) go through a
    scratch directory, the histories come back the same way, in worker
    order, with each child's sent commits and kernel launches
    (``trainer.process_launches``: the children's counters summed).  The
    driver's TF32 and cuDNN switches go to the children with the config,
    so a one-worker process run is the one-thread host-PS run, bit for
    bit.

    ``fault_tolerance`` finishes on the surviving processes, read from the
    exit codes (``trainer.failed_workers``).  Before it reads the center
    the driver waits until every server has applied the commits the
    surviving children sent (a serial worker's last ``'c'`` is
    fire-and-forget: its frame may sit in the server's socket buffer when
    the process exits).  ``elastic=True`` is the supervised engine
    (``_run_process_elastic``).  Refused, as in the JAX package: the
    checkpoint directory, the ``'hang'`` fault without ``elastic`` and a
    callable ``lr_schedule``.
    """
    import json
    import os
    import tempfile

    from .job_deployment import Job, LocalJobRunner
    from .ps_worker_main import save_model_blob

    algorithm = trainer.ALGORITHM
    if algorithm not in WORKER_CLASSES:
        raise ValueError(
            f"execution='process_ps' supports PS algorithms "
            f"{sorted(WORKER_CLASSES)}, not {algorithm!r} "
            f"({type(trainer).__name__})")
    if trainer.checkpoint_dir is not None:
        raise ValueError(
            "checkpoint/resume is not supported on execution='process_ps' "
            "(use 'host_ps' for epoch-wave checkpoints)")
    if not getattr(trainer, "elastic", False) and any(
            k == "hang" for k, _ in parse_fault_injection(
                getattr(trainer, "fault_injection", None)).values()):
        raise ValueError(
            "fault_injection kind 'hang' wedges a worker process forever; "
            "the static process engine has no lease ledger to revoke its "
            "work — use elastic=True (any execution) so the leases of a "
            "wedged worker are revoked and stolen")

    trainer.record_training_start()
    trainer.failed_workers = []
    trainer.worker_failures = {}
    trainer.elastic_stats = {}
    trainer.process_launches = {}
    x = np.asarray(dataset[trainer.features_col])
    y = np.asarray(dataset[trainer.label_col])
    if shuffle:
        perm = np.random.default_rng(trainer.seed).permutation(len(x))
        x, y = x[perm], y[perm]
    blob = serialize_model(trainer._initial_params(x.shape[1:]))

    n = trainer.num_workers * getattr(trainer, "parallelism_factor", 1)
    if len(x) < n:
        raise ValueError(
            f"dataset of {len(x)} rows has fewer rows than workers ({n})")
    # all validation/config prep BEFORE the server starts: an error here
    # must not leak the listener thread
    optimizer = trainer.worker_optimizer
    if not isinstance(optimizer, str):  # Optimizer object → JSON config
        optimizer = optimizer.get_config()
    kw = _worker_kwargs(trainer, n, len(x))
    if callable(kw["lr_schedule"]):
        raise ValueError(
            "execution='process_ps' cannot ship a callable lr_schedule to "
            "worker processes — pass a name or config dict "
            "(e.g. 'warmup_cosine'), or use execution='host_ps'")
    # the children's device: the trainer's, as a string ("cuda", "cuda:0",
    # "cpu"); the worker raises where the card is asked for and absent
    kw["device"] = str(trainer.device)
    # the host extensions are built here, once: the children load this
    # build and never run the compiler (trainer.process_native_compiles)
    from . import native
    native.build()
    trainer.process_native_compiles = 0

    if getattr(trainer, "elastic", False):
        # the supervised cross-process engine: lease rail + process-level
        # supervision + (optionally) PS shards as their own OS processes
        return _run_process_elastic(trainer, x, y, n, blob, kw, optimizer,
                                    algorithm)

    num_shards = int(getattr(trainer, "ps_shards", 1) or 1)
    bind_host, advertise_host = resolve_ps_hosts(trainer)
    ps_core = getattr(trainer, "ps_core", "event") or "event"
    coalesce = bool(getattr(trainer, "coalesce", True))
    apply_kernel = getattr(trainer, "apply_kernel", None)
    if num_shards > 1:
        # sharded static path: the worker processes scatter/gather through
        # a ShardedPSClient — the process boundary is invisible to the
        # shard wire protocol
        server = ShardedServerGroup(algorithm, blob, n, num_shards,
                                    host=bind_host, ps_core=ps_core,
                                    coalesce=coalesce,
                                    apply_kernel=apply_kernel)
    else:
        server = make_socket_server(
            allocate_parameter_server(algorithm, blob, n,
                                      apply_kernel=apply_kernel),
            host=bind_host, ps_core=ps_core, coalesce=coalesce)
    server.start()
    trainer._ps_server = server  # observability: the clock
    try:
        mark = _applied_mark(server, [])
        with tempfile.TemporaryDirectory(prefix="dkt_procps_") as tmp:
            model_path = os.path.join(tmp, "model.npz")
            save_model_blob(model_path, blob)
            shard_paths, result_paths = [], []
            for i in range(n):  # round-robin deal, as the thread engine
                p = os.path.join(tmp, f"shard_{i}.npz")
                np.savez(p, x=x[i::n], y=y[i::n])
                shard_paths.append(p)
                result_paths.append(os.path.join(tmp, f"result_{i}.npz"))
            if num_shards > 1:
                endpoint = {
                    "ps_host": advertise_host,
                    "ps_port": server.ports[0],
                    "num_shards": num_shards,
                    "shard_addrs": [[advertise_host, int(p)]
                                    for _, p in server.addrs],
                }
            else:
                endpoint = {"ps_host": advertise_host,
                            "ps_port": server.port}
            cfg_path = os.path.join(tmp, "worker_config.json")
            with open(cfg_path, "w") as f:
                json.dump({**kw, **endpoint, "algorithm": algorithm,
                           "model_path": model_path,
                           "shard_paths": shard_paths,
                           "result_paths": result_paths,
                           "worker_optimizer": optimizer,
                           "backends": _backend_flags()}, f)
            job = Job(name=f"{algorithm}-process-ps", script="-m",
                      args=["distkeras_tpu_torch.ps_worker_main", cfg_path],
                      hosts=["127.0.0.1"] * n, env=_child_env(),
                      coordinated=False)
            job.run(LocalJobRunner())
            # max() would mask signal deaths (negative codes) behind a 0
            failed = [i for i, c in enumerate(job.returncodes) if c != 0]
            if failed:
                if not getattr(trainer, "fault_tolerance", False):
                    raise RuntimeError(
                        f"worker process failed (exit codes "
                        f"{job.returncodes})")
                if len(failed) == n:
                    raise RuntimeError(
                        f"all {n} worker processes failed (exit codes "
                        f"{job.returncodes}); fault_tolerance can survive "
                        "some, not all")
                # degraded completion: the PS already holds every commit
                # the dead workers applied before dying (their EOF was a
                # normal disconnect to the server)
                trainer.failed_workers = failed
                for i in failed:
                    trainer.worker_failures[i] = (
                        f"exit code {job.returncodes[i]}")
                print(f"[distkeras_tpu_torch] worker processes {failed} "
                      f"exited nonzero ({job.returncodes}); "
                      "fault_tolerance: continuing with survivors",
                      file=sys.stderr)
            results = [_ChildResult(i, p) for i, p in enumerate(result_paths)
                       if i not in failed]  # no result from a dead worker
        # the survivors' last commits may still sit in the server's socket
        # buffers: wait for them before reading the center
        _await_applied(server, lambda: _landing_targets(server, results,
                                                        mark))
    finally:
        server.stop()
        trainer.ps_coalesce_stats = getattr(server, "coalesce_stats", None)

    trainer.history.clear()
    for r in results:
        trainer.history.extend(r.history)
    trainer._process_results = results
    trainer.process_launches = _sum_launches(results)
    trainer.process_native_compiles = sum(r.native_compiles
                                          for r in results)
    fitted = server.get_model(device=trainer.device)
    trainer._fitted = fitted
    trainer.record_training_stop()
    return fitted


def _run_process_elastic(trainer, x, y, n: int, blob: dict, kw: dict,
                         optimizer, algorithm: str) -> FittedModel:
    """The supervised cross-process engine (``execution='process_ps'``
    with ``elastic=True``).

    Worker *processes* lease row ranges from a ``resilience.LeaseServer``
    over the wire; a ``resilience.ProcessSupervisor`` detects SIGKILLed
    (waitpid) and SIGSTOPped (wire-heartbeat-silent, ``freeze_deadline``)
    workers, revokes their leases so survivors steal the work, and
    respawns replacements under fresh ids through the ``Job`` rail; the
    per-epoch ``assert_epoch_complete`` keeps the zero-data-loss contract.
    Each child warms one window before its first lease (its CUDA context
    and handles), and one window timed in a fresh thread of the driver
    seeds the ledger's cold estimate.

    The PS has two placements (``trainer.ps_placement``): ``"driver"``, a
    ``ShardedServerGroup`` inside this process, and ``"process"``, one
    ``ps_shard_main`` process a shard, journaling to the scratch
    directory (``snapshot_interval``) and respawned at the same address
    by the supervisor; the fresh process restores its journal with its
    generation bumped.  The whole dataset goes to every worker once (one
    npz); each epoch's shuffle is reproduced in every process from
    ``seed + 7919 * epoch``.  After the workers exit the driver waits for
    the commits they sent (a killed worker's are not known, so the wait is
    a lower bound there), gathers the final center (over the wire from
    shard processes, before they are retired) and globs the histories
    from ``result_*.npz``.  Observability: ``trainer.elastic_stats`` (the
    supervisor's ``stats()`` plus ``lease_completions``),
    ``_process_supervisor``, ``failed_workers``, ``process_launches``.
    """
    import contextlib
    import glob as globmod
    import json
    import os
    import tempfile

    from .job_deployment import Job, LocalJobRunner
    from .ps_sharding import ShardedPSClient, make_shard_plan
    from .ps_worker_main import save_model_blob
    from .resilience import LeaseServer, ProcessSupervisor

    num_shards = int(getattr(trainer, "ps_shards", 1) or 1)
    placement = getattr(trainer, "ps_placement", "driver") or "driver"
    if placement not in ("driver", "process"):
        raise ValueError(
            f"ps_placement must be 'driver' or 'process', got {placement!r}")
    recovery = bool(getattr(trainer, "recovery", False))
    bind_host, advertise_host = resolve_ps_hosts(trainer)
    ps_core = getattr(trainer, "ps_core", "event") or "event"
    coalesce = bool(getattr(trainer, "coalesce", True))
    apply_kernel = getattr(trainer, "apply_kernel", None)

    # lease geometry — identical to the in-process elastic engine
    win_rows = trainer.communication_window * trainer.batch_size
    total_windows = -(-len(x) // win_rows)
    lease_windows = getattr(trainer, "lease_windows", None)
    if lease_windows is None:
        lease_windows = max(1, total_windows // (4 * n))
    # cold-start deadline seed: one window of the program the workers run,
    # timed in a fresh thread (its first window builds the thread's
    # handles, as a child's does), × n for contention
    head = WORKER_CLASSES[algorithm](
        blob, worker_optimizer=trainer.worker_optimizer,
        ps_host=advertise_host, ps_port=0, **kw)
    warm: Dict[str, Any] = {}

    def time_window():
        try:
            warm["seconds"] = head.compile_windows(x, y)
        except BaseException as e:  # re-raised in the trainer's thread
            warm["error"] = e

    th = threading.Thread(target=time_window, name="dkt-process-warmup")
    th.start()
    th.join()
    if "error" in warm:
        raise warm["error"]
    ledger = LeaseLedger(len(x), win_rows, lease_windows,
                         min_deadline=getattr(trainer, "lease_timeout", 5.0),
                         default_window_s=warm["seconds"] * n)
    env = _child_env()

    with contextlib.ExitStack() as stack:
        scratch = getattr(trainer, "scratch_dir", None)
        if scratch is None:
            scratch = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="dkt_procel_"))
        else:
            os.makedirs(scratch, exist_ok=True)
        model_path = os.path.join(scratch, "model.npz")
        save_model_blob(model_path, blob)
        data_path = os.path.join(scratch, "data.npz")
        np.savez(data_path, x=x, y=y)
        result_dir = os.path.join(scratch, "results")
        os.makedirs(result_dir, exist_ok=True)

        # -- bring up the PS ------------------------------------------------
        group = None
        ps_procs: List[Any] = []
        respawn_ps = None
        addr_dir = os.path.join(scratch, "addrs")
        if placement == "driver":
            group = ShardedServerGroup(algorithm, blob, n, num_shards,
                                       host=bind_host, ps_core=ps_core,
                                       coalesce=coalesce,
                                       apply_kernel=apply_kernel)
            group.start()
            stack.callback(group.stop)
            trainer._ps_server = group
            shard_addrs = [(advertise_host, int(p))
                           for _, p in group.addrs]
        else:
            from .ps_shard_main import read_addr
            journal_dir = os.path.join(scratch, "journal")
            os.makedirs(addr_dir, exist_ok=True)
            os.makedirs(journal_dir, exist_ok=True)
            ps_cfg_path = os.path.join(scratch, "shard_config.json")
            with open(ps_cfg_path, "w") as f:
                json.dump({
                    "algorithm": algorithm, "model_path": model_path,
                    "num_workers": n, "num_shards": num_shards,
                    "bind_host": bind_host, "addr_dir": addr_dir,
                    "journal_dir": journal_dir, "ps_core": ps_core,
                    "coalesce": coalesce, "apply_kernel": apply_kernel,
                    "snapshot_interval":
                        getattr(trainer, "snapshot_interval", 0.5),
                }, f)

            def spawn_shard(j: int):
                job = Job(name=f"{algorithm}-ps-shard{j}", script="-m",
                          args=["distkeras_tpu_torch.ps_shard_main",
                                ps_cfg_path, str(j)],
                          hosts=["127.0.0.1"], env=env, coordinated=False)
                job.run(LocalJobRunner(), wait=False)
                return job.processes[0]

            respawn_ps = spawn_shard
            ps_procs = [spawn_shard(j) for j in range(num_shards)]

            def _stop_shards():
                procs = (trainer._process_supervisor.ps_procs
                         if getattr(trainer, "_process_supervisor", None)
                         else ps_procs)
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=15)
                    except Exception:
                        p.kill()

            stack.callback(_stop_shards)
            trainer._process_supervisor = None
            shard_addrs = []
            deadline = time.monotonic() + 180  # cold imports
            for j in range(num_shards):
                path = os.path.join(addr_dir, f"shard_{j}.addr")
                while not os.path.exists(path):
                    if ps_procs[j].poll() is not None:
                        raise RuntimeError(
                            f"PS shard process {j} exited with code "
                            f"{ps_procs[j].returncode} before publishing "
                            "its address")
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"PS shard process {j} never published its "
                            "address")
                    time.sleep(0.05)
                h, port, _gen = read_addr(path)
                shard_addrs.append((advertise_host if h in _WILDCARD_HOSTS
                                    else h, port))

        # -- the lease rail --------------------------------------------------
        lease_server = stack.enter_context(LeaseServer(ledger,
                                                       host=bind_host))
        wcfg = {**kw, "algorithm": algorithm, "model_path": model_path,
                "data_path": data_path, "result_dir": result_dir,
                "worker_optimizer": optimizer,
                "lease_host": advertise_host,
                "lease_port": lease_server.port,
                "ps_host": shard_addrs[0][0], "ps_port": shard_addrs[0][1],
                "backends": _backend_flags()}
        if num_shards > 1:
            wcfg["num_shards"] = num_shards
            wcfg["shard_addrs"] = [[h, p] for h, p in shard_addrs]
        if recovery:
            wcfg["recovery"] = True
        pw = int(getattr(trainer, "partition_windows", 0) or 0)
        if pw:
            wcfg["partition_windows"] = pw
            wcfg["recovery"] = True  # heal-exhaustion falls back to resume
        wcfg_path = os.path.join(scratch, "worker_config.json")
        with open(wcfg_path, "w") as f:
            json.dump(wcfg, f)

        def spawn_worker(wid: int):
            job = Job(name=f"{algorithm}-elastic-w{wid}", script="-m",
                      args=["distkeras_tpu_torch.ps_worker_main", wcfg_path,
                            str(wid)],
                      hosts=["127.0.0.1"], env=env, coordinated=False,
                      process_ids=[wid])
            job.run(LocalJobRunner(), wait=False)
            return job.processes[0]

        sup = ProcessSupervisor(
            ledger, lease_server, spawn_worker, n,
            freeze_deadline=getattr(trainer, "freeze_deadline", None),
            max_respawns=getattr(trainer, "max_respawns", None),
            ps_procs=ps_procs or None,
            ps_addrs=shard_addrs if ps_procs else None,
            respawn_ps=respawn_ps)
        trainer._process_supervisor = sup  # observability (tests, smoke)

        epoch_reports: Dict[int, Any] = {}
        try:
            sup.start()
            for epoch in range(trainer.num_epoch):
                sup.run_epoch(epoch)
                # the zero-data-loss contract, asserted per epoch
                epoch_reports[epoch] = ledger.assert_epoch_complete(epoch)
        finally:
            sup.shutdown()
            trainer.failed_workers = sorted(sup.failures)
            trainer.worker_failures = dict(sup.failures)
            trainer.elastic_stats = {**sup.stats(),
                                     "lease_completions": epoch_reports}

        # histories from every worker that ever ran (original ids +
        # respawned fresh ids), id order — files are globbed because
        # replacements land under ids the launch config never knew
        results = [
            _ChildResult(int(os.path.basename(p)[len("result_"):-4]), p)
            for p in globmod.glob(os.path.join(result_dir, "result_*.npz"))]
        results.sort(key=lambda r: r.worker_id)
        trainer.history.clear()
        for r in results:
            trainer.history.extend(r.history)
        trainer._process_results = results
        trainer.process_launches = _sum_launches(results)
        trainer.process_native_compiles = sum(r.native_compiles
                                              for r in results)

        # -- final model -----------------------------------------------------
        if group is not None:
            _await_applied(group, lambda: _landing_targets(
                group, results, ([0] * num_shards, [0] * num_shards,
                                 [0] * num_shards)))
            trainer.ps_coalesce_stats = group.coalesce_stats
            fitted = group.get_model(device=trainer.device)
        else:
            # gather the final center over the wire before retiring the
            # shard processes (the ExitStack SIGTERMs them on the way out;
            # each journals a final snapshot — clean handoff)
            _await_shard_processes(shard_addrs, addr_dir, results)
            trainer.ps_coalesce_stats = None
            weights = [np.asarray(w) for w in blob["weights"]]
            plan = make_shard_plan([w.shape for w in weights],
                                   [w.dtype for w in weights], num_shards)
            client = ShardedPSClient(plan, shard_addrs, recovery=True)
            try:
                client.connect()
                center = client.pull()
            finally:
                client.disconnect()
            fitted = FittedModel(deserialize_model(
                {"model": blob["model"], "weights": center},
                device=trainer.device))

    trainer._fitted = fitted
    trainer.record_training_stop()
    return fitted
