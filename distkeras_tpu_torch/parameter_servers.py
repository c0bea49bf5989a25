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
   native build waits for ROADMAP queue A item 8 (numpy is the reference
   and bit-identical either way);
 - ``run_host_ps_training`` keeps the non-elastic engine: the round-robin
   deal, the epoch waves and the npz checkpoint, over one server or a
   ``ps_sharding.ShardedServerGroup`` (``ps_shards > 1``), with
   ``row_sparse`` resolved by ``streaming.resolve_row_sparse_tables``.
   Recovery, the elastic and streaming engines and the process engine
   wait for ROADMAP queue A item 6, and the trainers refuse their knobs.

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
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import applykernel, networking
from .core.model import FittedModel, deserialize_model, serialize_model
from .device import DeviceLike
from .ps_sharding import PSShardDown, ShardedServerGroup
from .workers import WORKER_CLASSES, share_compiled_state

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
    # the recovering, elastic and streaming engines (the trainers refuse
    # their knobs until then)
    for knob, is_set in (
            ("recovery=True", bool(getattr(trainer, "recovery", False))),
            ("elastic=True", bool(getattr(trainer, "elastic", False))),
            ("stream=True", bool(getattr(trainer, "stream", False)))):
        if is_set:
            raise NotImplementedError(
                f"{knob} on execution='host_ps' is not ported yet (ROADMAP "
                "queue A item 6)")

    trainer.record_training_start()
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
    ps_core = getattr(trainer, "ps_core", "event") or "event"
    coalesce = bool(getattr(trainer, "coalesce", True))
    apply_kernel = getattr(trainer, "apply_kernel", None)
    sharded = ps_shards > 1
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
    ckpt = None
    try:
        server.start()
        trainer._ps_server = server  # observability: the clock (smoke run)
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
            # proxy per shard
            addrs = [(advertise_host, int(p)) for _, p in server.addrs]
            hook = getattr(trainer, "_shard_addr_hook", None)
            if hook is not None:
                addrs = [(str(h), int(p)) for h, p in hook(list(addrs))]
            kw.update(shard_plan=server.plan, shard_addrs=addrs)
        workers = [WORKER_CLASSES[algorithm](blob, **kw) for _ in range(n)]
        share_compiled_state(workers)
        trainer._ps_workers = workers  # observability: transport counters
        start_epoch = 0
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

        if trainer.checkpoint_dir is not None:
            from .checkpoint import foreign_checkpoints, make_checkpointer
            backend = trainer.checkpoint_backend
            ckpt = make_checkpointer(trainer.checkpoint_dir, backend)
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

        # Without checkpointing there is no reason to barrier between
        # epochs: each worker runs all its epochs in one fully-async wave
        # (one connect, no stragglers at epoch joins) — the reference
        # execution model.  With a checkpoint_dir, epochs run as waves and
        # the joined state is saved.
        if ckpt is None:
            waves = [None]  # one wave, all epochs (worker default)
        else:
            waves = [(e, e + 1)
                     for e in range(start_epoch, trainer.num_epoch)]
        for epoch_range in waves:
            results: List[Optional[dict]] = [None] * n
            errors: List[tuple] = []
            clocks0 = _clocks(server)
            commits0 = sum(w._commits for w in workers)

            def run(i, epoch_range=epoch_range):
                try:
                    results[i] = workers[i].train(
                        i,
                        {trainer.features_col: xs[i],
                         trainer.label_col: ys[i]},
                        initial_state=states[i],
                        epoch_range=epoch_range)
                except BaseException as e:  # propagate to the driver thread
                    errors.append((i, e))

            threads = [threading.Thread(target=run, args=(i,),
                                        name=f"dkt-worker-{i}")
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                # a dead shard is not a dead worker: it holds part of the
                # center, so it surfaces as itself
                shard_err = next((e for _, e in errors
                                  if isinstance(e, PSShardDown)), None)
                raise shard_err if shard_err is not None else errors[0][1]
            new = sum(w._commits for w in workers) - commits0
            _await_applied(server, [c + new for c in clocks0])
            states = [r["state"] for r in results]
            if ckpt is not None and (
                    epoch_range[1] % trainer.checkpoint_every == 0):
                ckpt.save(epoch_range[1], full_state(),
                          meta={"engine": "host_ps", "unit": "epoch",
                                "ps_shards": ps_shards})
    finally:
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


def _clocks(server) -> List[int]:
    """The update clock of a socket server, or of each shard of a
    ``ShardedServerGroup``."""
    return [s.ps.num_updates for s in getattr(server, "servers", [server])]


def _await_applied(server, clocks: List[int],
                   timeout: float = 30.0) -> None:
    """Wait until the server (each shard) has applied commits up to
    ``clocks``.  A worker's last commit on the serial elastic loop is a
    fire-and-forget 'c': when its thread joins, the frame may still sit in
    the server's socket buffer, and a center read then (a checkpoint, the
    fitted model) would miss it.  A server that does not get there within
    ``timeout`` is logged, not waited for."""
    deadline = time.monotonic() + timeout
    while any(c < want for c, want in zip(_clocks(server), clocks)):
        if time.monotonic() > deadline:
            logger.warning("PS clocks %s short of the %s commits sent",
                           _clocks(server), clocks)
            return
        time.sleep(0.001)


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
        comm_overlap=getattr(trainer, "comm_overlap", False))
    if trainer.ALGORITHM in ("aeasgd", "eamsgd"):
        kw["rho"] = getattr(trainer, "rho", 5.0)
    return kw
