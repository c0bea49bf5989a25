"""Parameter-server sharding, a copy of ``distkeras_tpu/ps_sharding.py``
kept in the port so that it imports nothing of the JAX package.

The plan is host numpy code and is the JAX module's line for line:
``make_shard_plan`` gives the same assignments for the same shapes,
dtypes and shard count, so JAX and port workers can share one sharded
parameter server (``tests/test_torch_sparse_parity.py``).  What differs:

 - a delta leaf may be a CPU ``torch.bfloat16`` tensor (the port's bf16
   wire form, no ``ml_dtypes``): ``ShardPlan.take`` slices it as a
   tensor, and ``split_sparse`` scatters a ``SparseDelta``'s bf16 values
   with a tensor mask;
 - ``ShardedServerGroup`` holds the port's socket servers, and
   ``get_model(device=)`` builds the fitted model on a torch device.

``ShardedPSClient`` carries the reconnect-resume half (``_redial_once``,
``_with_resume``, the generations and ``last_stale``) that
``resilience.ShardSupervisor`` drives under ``recovery=True``, and it
counts the commits that can still land per (shard, generation) in
``sent``, which ``run_host_ps_training`` waits for.

The JAX module's description follows.

PS sharding — scatter/gather weight partitions across N parameter-server
shards.

The single-``ParameterServer`` path (``parameter_servers.py``) funnels every
commit and pull through one TCP server, so PS-side CPU and NIC bandwidth cap
asynchronous throughput no matter how many workers join — the 'u' pipelining
hid the round-trip *latency* but not the serialization at the server.  This
module is the standard next step in the parameter-server lineage (Li et al.,
*Scaling Distributed Machine Learning with the Parameter Server*, OSDI 2014;
Dean et al., DistBelief): partition the flat weight list across
``ps_shards=N`` independent servers and talk to all of them concurrently.

Three pieces:

 - ``make_shard_plan`` / ``ShardPlan`` — the static partitioning: greedy
   bin-packing of tensors by byte size, with row-wise splitting of any tensor
   larger than ``total_bytes / N`` so one embedding matrix can't unbalance
   the ring.  The plan is deterministic in (shapes, dtypes, N) — every worker
   and the trainer derive the identical layout with no negotiation.
 - ``ShardedPSClient`` — the worker-side transport: one socket + one
   receive-``BufferPool`` per shard; commits scatter (each shard gets only
   its slices), pulls gather.  Requests go out on every shard before any
   reply is read, so the N round trips ride the wire concurrently, and the
   combined ``'u'`` commit+pull opcode pipelines per shard exactly as on the
   single-PS path — the 1-RTT-per-window overlap property is preserved
   end to end, per shard.
 - ``ShardedServerGroup`` — the trainer-side lifecycle: N
   ``SocketParameterServer`` instances, each wrapping the *unchanged*
   per-algorithm apply rule (Delta/ADAG/DynSGD) on its slice of the center.

Semantics: every shard runs the full opcode protocol with its own apply lock
and its own update clock; a worker's commit carries the per-shard last-seen
clock, so DynSGD's staleness pricing is per-shard identical to the single-PS
path.  All apply rules are elementwise over the weight vector, so for a
single worker (no hogwild interleaving) an ``N``-shard run is bit-identical
to the single-PS run — and ``N=1`` degenerates to one server holding the
whole (unsplit, original-order) weight list.

A dead shard is not a dead worker: it holds a slice of the center that no
survivor can reconstruct, so shard-transport failures surface as
``PSShardDown(shard_id)`` (a ``ConnectionError`` subclass) and the trainer
raises it even under ``fault_tolerance=True``.
"""

from __future__ import annotations

import socket
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import networking
from .device import DeviceLike
from .resilience import (DEFAULT_CONNECT_POLICY, DEFAULT_RECOVERY_POLICY,
                         RETRYABLE_CONNECT, RetryPolicy, dial)


class PSShardDown(ConnectionError):
    """A parameter-server *shard* is unreachable.

    Distinct from a worker death (which the PS engines can tolerate): a
    shard holds a partition of the center weights, so losing one loses part
    of the model — ``run_host_ps_training`` re-raises this even under
    ``fault_tolerance=True`` instead of degrading to survivors.
    """

    def __init__(self, shard_id: int, addr: Optional[Tuple[str, int]] = None,
                 detail: Optional[str] = None):
        self.shard_id = int(shard_id)
        self.addr = addr
        msg = f"PS shard {self.shard_id}"
        if addr is not None:
            msg += f" at {addr[0]}:{addr[1]}"
        msg += " is down"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class ShardSlice(NamedTuple):
    """One contiguous leading-axis row range of one tensor, assigned to a
    shard.  ``(0, rows)`` means the whole tensor; 0-d tensors use rows=1."""

    tensor: int
    start: int
    stop: int


def _rows(shape: Tuple[int, ...]) -> int:
    return shape[0] if shape else 1


class ShardPlan:
    """Deterministic partition of a flat tensor list over ``num_shards``.

    ``assignments[j]`` is shard j's ordered slice list; the wire layout of a
    shard (slice order, shapes) is a pure function of the plan, so both ends
    of every connection agree without negotiation.
    """

    def __init__(self, shapes: Sequence[Tuple[int, ...]], dtypes: Sequence,
                 num_shards: int, assignments: List[List[ShardSlice]]):
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.dtypes = [np.dtype(d) for d in dtypes]
        self.num_shards = int(num_shards)
        self.assignments = assignments
        self._flat_meta = None  # lazy: flat-interval map for sparse commits

    def slice_bytes(self, s: ShardSlice) -> int:
        shape = self.shapes[s.tensor]
        per_row = (self.dtypes[s.tensor].itemsize
                   * int(np.prod(shape[1:], dtype=np.int64)))
        return (s.stop - s.start) * per_row

    def shard_bytes(self) -> List[int]:
        return [sum(self.slice_bytes(s) for s in a) for a in self.assignments]

    @staticmethod
    def take(arr: np.ndarray, s: ShardSlice) -> np.ndarray:
        """The slice of ``arr`` a ``ShardSlice`` names (view, no copy); a
        CPU torch tensor (a bf16 delta leaf) is sliced as a tensor."""
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        return arr if arr.ndim == 0 else arr[s.start:s.stop]

    def scatter(self, tensors: Sequence[np.ndarray]
                ) -> List[List[np.ndarray]]:
        """Full tensor list → per-shard slice lists (views, zero-copy)."""
        return [[self.take(tensors[s.tensor], s) for s in a]
                for a in self.assignments]

    # -- sparse (flat top-k) commits ----------------------------------------
    def _flat_intervals(self):
        """Lazily build the flat-interval map for sparse-commit bisection.

        Every ``ShardSlice`` is one CONTIGUOUS interval of the concatenated
        flat weight vector (row-split slices are leading-axis ranges of
        C-contiguous tensors), and the slices tile it exactly.  Returns
        sorted arrays ``(g_starts, shard_ids, local_starts)`` plus the
        per-shard element counts — a flat index bisects to its interval in
        O(log m), and its shard-LOCAL coordinate is
        ``idx - g_start + local_start`` (shard layout = its slices
        concatenated in assignment order, matching the shard's wire/center
        layout).
        """
        if self._flat_meta is not None:
            return self._flat_meta
        elems = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        toff = np.concatenate(([0], np.cumsum(np.asarray(elems, np.int64))))
        starts, shards, locals_ = [], [], []
        shard_elems = [0] * self.num_shards
        for j, pieces in enumerate(self.assignments):
            loc = 0
            for s in pieces:
                shape = self.shapes[s.tensor]
                per_row = int(np.prod(shape[1:], dtype=np.int64)) \
                    if shape else 1
                starts.append(int(toff[s.tensor]) + s.start * per_row)
                shards.append(j)
                locals_.append(loc)
                loc += (s.stop - s.start) * per_row
            shard_elems[j] = loc
        order = np.argsort(np.asarray(starts, np.int64), kind="stable")
        self._flat_meta = (np.asarray(starts, np.int64)[order],
                           np.asarray(shards, np.int64)[order],
                           np.asarray(locals_, np.int64)[order],
                           shard_elems, int(toff[-1]))
        return self._flat_meta

    def flat_elements(self) -> int:
        """Dense length of the concatenated flat weight vector."""
        return self._flat_intervals()[4]

    def shard_elements(self) -> List[int]:
        """Per-shard dense length (sum of its slice element counts)."""
        return list(self._flat_intervals()[3])

    def shard_of_flat(self, indices: np.ndarray) -> np.ndarray:
        """Owning shard id per global flat index (validated in range)."""
        g_starts, shards, _, _, total = self._flat_intervals()
        idx = np.asarray(indices, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= total):
            raise ValueError(
                f"flat index out of range for dense length {total}")
        pos = np.searchsorted(g_starts, idx, side="right") - 1
        return shards[pos]

    def split_sparse(self, indices: np.ndarray, values: np.ndarray
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Scatter a flat sparse commit over the shards by index bisection:
        returns per-shard ``(local_indices int32, values)`` in the shard's
        own flat coordinates (row-split tensors re-index into slice-local
        positions).  Sorted global indices stay sorted per shard, because a
        shard's slices are kept in ascending global order."""
        g_starts, shards, local_starts, _, total = self._flat_intervals()
        idx = np.asarray(indices, np.int64)
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        if idx.size and (idx.min() < 0 or idx.max() >= total):
            raise ValueError(
                f"flat index out of range for dense length {total}")
        pos = np.searchsorted(g_starts, idx, side="right") - 1
        local = idx - g_starts[pos] + local_starts[pos]
        owner = shards[pos]
        out = []
        for j in range(self.num_shards):
            m = owner == j
            vals = (values[torch.from_numpy(m)]
                    if isinstance(values, torch.Tensor) else values[m])
            out.append((local[m].astype(np.int32), vals))
        return out

    def gather(self, shard_tensors: Sequence[Sequence[np.ndarray]]
               ) -> List[np.ndarray]:
        """Per-shard slice lists → full tensor list (freshly allocated, so
        pooled receive views are safe to hand the result off)."""
        out = [np.empty(s, d) for s, d in zip(self.shapes, self.dtypes)]
        for pieces, arrs in zip(self.assignments, shard_tensors):
            if len(pieces) != len(arrs):
                raise ValueError(
                    f"shard carries {len(arrs)} tensors, plan expects "
                    f"{len(pieces)}")
            for s, a in zip(pieces, arrs):
                t = out[s.tensor]
                if t.ndim == 0:
                    t[...] = np.asarray(a)
                else:
                    t[s.start:s.stop] = np.asarray(a)
        return out


def make_shard_plan(shapes: Sequence[Tuple[int, ...]], dtypes: Sequence,
                    num_shards: int) -> ShardPlan:
    """Partition tensors over shards: greedy bin-packing by byte size,
    splitting any tensor larger than ``total_bytes / num_shards`` row-wise
    (leading axis) into near-equal pieces first, so one oversized embedding
    cannot unbalance the ring.  ``num_shards=1`` is the identity plan: one
    shard, whole tensors, original order.
    """
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    shapes = [tuple(int(d) for d in s) for s in shapes]
    dtypes = [np.dtype(d) for d in dtypes]
    if len(shapes) != len(dtypes):
        raise ValueError("shapes and dtypes must align")
    sizes = [dt.itemsize * int(np.prod(s, dtype=np.int64))
             for s, dt in zip(shapes, dtypes)]
    if num_shards == 1:
        whole = [ShardSlice(t, 0, _rows(s)) for t, s in enumerate(shapes)]
        return ShardPlan(shapes, dtypes, 1, [whole])

    total = sum(sizes)
    threshold = max(-(-total // num_shards), 1)
    pieces: List[ShardSlice] = []
    for t, (shape, nb) in enumerate(zip(shapes, sizes)):
        rows = _rows(shape)
        if nb > threshold and rows > 1:
            k = min(rows, -(-nb // threshold))
            bounds = [(i * rows) // k for i in range(k + 1)]
            pieces.extend(ShardSlice(t, bounds[i], bounds[i + 1])
                          for i in range(k) if bounds[i + 1] > bounds[i])
        else:
            pieces.append(ShardSlice(t, 0, rows))

    plan = ShardPlan(shapes, dtypes, num_shards,
                     [[] for _ in range(num_shards)])
    # largest piece first onto the lightest shard (ties: lowest shard id) —
    # the classic LPT greedy, deterministic in the input ordering
    order = sorted(range(len(pieces)),
                   key=lambda i: (-plan.slice_bytes(pieces[i]), i))
    loads = [0] * num_shards
    for i in order:
        j = min(range(num_shards), key=lambda j: (loads[j], j))
        plan.assignments[j].append(pieces[i])
        loads[j] += plan.slice_bytes(pieces[i])
    for a in plan.assignments:
        a.sort()
    return plan


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

class ShardedPSClient:
    """Worker-side transport to N PS shards: one socket + one receive-buffer
    pool per shard, per-shard update clocks, scatter on send / gather on
    receive.

    Every logical operation fans out over all shards with the *send phase
    first on every shard, then the receive phase* — all N requests are in
    flight before any reply is read, so the shard round trips overlap on the
    wire instead of serializing.  The split-phase ``send_update`` /
    ``recv_update`` pair mirrors ``PSWorker.update_begin/update_finish``:
    overlapped workers run device compute between the two halves, keeping
    the 1-RTT-per-window pipeline *per shard*.

    Any transport fault on shard j (send or receive) raises
    ``PSShardDown(j)`` instead of a bare ``ConnectionError`` from deep in
    ``recv_data`` — unless ``recovery=True``, in which case the client first
    **reconnect-resumes**: it re-dials shard j under ``policy`` (attempts /
    backoff / jitter / deadline — resilience.RetryPolicy), re-syncs with a
    pull on the fresh connection, and only raises ``PSShardDown(j)`` once
    the policy's recovery deadline is exhausted.  Shard generations (bumped
    by a supervisor respawn) are tracked per shard from every reply; commits
    are stamped with the last-seen generation so a restarted shard can
    reject the in-flight windows a restart rolled back, and the per-shard
    clocks stay **monotonic** across a restart (a restored — older — shard
    clock never rolls the client's view backwards).
    """

    def __init__(self, plan: ShardPlan, addrs: Sequence[Tuple[str, int]],
                 recovery: bool = False,
                 policy: Optional[RetryPolicy] = None):
        if len(addrs) != plan.num_shards:
            raise ValueError(
                f"{len(addrs)} shard addresses for a {plan.num_shards}-shard "
                "plan")
        self.plan = plan
        self.addrs = [(str(h), int(p)) for h, p in addrs]
        self.recovery = bool(recovery)
        self.policy = policy
        self._socks: List[Optional[socket.socket]] = [None] * plan.num_shards
        self._pools: List[Optional[networking.BufferPool]] = (
            [None] * plan.num_shards)
        #: encode-side scratch pools (one per shard): steady-state commits
        #: re-serialize into reusable buffers instead of allocating a fresh
        #: output blob per window per shard
        self._send_pools: List[Optional[networking.BufferPool]] = (
            [None] * plan.num_shards)
        self._clocks = [0] * plan.num_shards
        #: per-shard ``stale`` flags from the last ``recv_update`` gather —
        #: a True entry means that shard gen-rejected the in-flight commit
        #: (workers re-credit the dropped sparse mass into their residual)
        self.last_stale: List[bool] = [False] * plan.num_shards
        #: last reply clock seen on the CURRENT connection to each shard
        #: (None until the first reply; reset on reconnect).  This — not
        #: the monotonic ``_clocks`` view — is the duplicate-reply
        #: baseline: a restarted shard's clock legitimately restarts below
        #: the monotonic view, but within one connection genuine replies
        #: never run backwards.
        self._conn_clocks: List[Optional[int]] = [None] * plan.num_shards
        #: last-seen server generation per shard (None until first reply)
        self._gens: List[Optional[int]] = [None] * plan.num_shards
        #: observability counters (tests + bench)
        self.resumes = 0          # successful mid-run reconnect-resumes
        self.stale_replies = 0    # duplicated/stale 'u' replies discarded
        self.clock_regressions = 0  # replies whose clock ran backwards
        #: commits sent, by (shard, the generation they were stamped
        #: with), less those whose connection died before a reply: what
        #: can still land (a worker hands in its own dict, so the count
        #: outlives the client it rebuilds on every connect)
        self.sent: Dict[Tuple[int, Optional[int]], int] = {}
        self._unconfirmed: List[List[Tuple[int, Optional[int]]]] = [
            [] for _ in range(plan.num_shards)]

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    @property
    def max_clock(self) -> int:
        return max(self._clocks) if self._clocks else 0

    @property
    def pools(self) -> List[Optional[networking.BufferPool]]:
        return self._pools

    def _connect_policy(self, attempts: Optional[int] = None,
                        backoff: Optional[float] = None,
                        policy: Optional[RetryPolicy] = None) -> RetryPolicy:
        """Resolve the dial policy: explicit ``policy`` wins, then legacy
        ``attempts``/``backoff`` overrides, then the instance policy, then
        the shared default (which carries jitter — N workers x N shards
        re-dialing a restarted shard must not arrive in lockstep)."""
        if policy is None:
            policy = self.policy or DEFAULT_CONNECT_POLICY
        kw = {}
        if attempts is not None:
            kw["attempts"] = max(int(attempts), 1)
        if backoff is not None:
            kw["backoff"] = float(backoff)
        return policy.replace(**kw) if kw else policy

    # -- lifecycle -----------------------------------------------------------
    def connect(self, attempts: Optional[int] = None,
                backoff: Optional[float] = None,
                policy: Optional[RetryPolicy] = None):
        """Dial every shard with the same bounded jittered
        retry-with-backoff as ``PSWorker.connect`` — a shard that is
        mid-``start()`` can refuse, accept-then-reset, or time out, so all
        three retry (resilience.RETRYABLE_CONNECT)."""
        policy = self._connect_policy(attempts, backoff, policy)
        for j, (host, port) in enumerate(self.addrs):
            try:
                self._socks[j] = dial(host, port, policy)
                self._pools[j] = networking.BufferPool()
                self._send_pools[j] = networking.BufferPool()
            except RETRYABLE_CONNECT as e:
                self.abort()
                raise PSShardDown(
                    j, (host, port),
                    f"refused {policy.describe()} connection attempts"
                ) from e

    def _redial_once(self, j: int):
        """Drop shard ``j``'s socket and dial it exactly once (no retry —
        ``_with_resume`` owns the retry loop, because a dial can succeed
        against a dead listener's kernel backlog and only fail on first
        use, so dial and first use must retry as one unit)."""
        if self._socks[j] is not None:
            try:
                self._socks[j].close()
            except OSError:
                pass
            self._socks[j] = None
        self._socks[j] = networking.connect(*self.addrs[j])
        self._pools[j] = networking.BufferPool()
        self._send_pools[j] = networking.BufferPool()
        self._conn_clocks[j] = None

    def _drop_unconfirmed(self, j: int):
        """Shard ``j``'s connection died: the commits sent on it since its
        last reply may or may not have applied, so they no longer count as
        landing (``sent`` is read as a lower bound)."""
        for key in self._unconfirmed[j]:
            self.sent[key] -= 1
        self._unconfirmed[j].clear()

    def _with_resume(self, j: int, fn, fault: BaseException):
        """Mid-run reconnect-resume for shard ``j``: repeatedly (re-dial +
        ``fn()``) under the recovery policy — the deadline budgets the
        supervisor's detect + respawn-from-snapshot time.  ``PSShardDown``
        is raised only once the policy is exhausted."""
        policy = self.policy or DEFAULT_RECOVERY_POLICY
        t0 = time.monotonic()
        last = fault
        for d in policy.delays():
            try:
                self._drop_unconfirmed(j)
                self._redial_once(j)
                out = fn()
                self.resumes += 1
                return out
            except (ConnectionError, OSError, ValueError,
                    socket.timeout) as e:
                last = e
                if (policy.deadline is not None
                        and time.monotonic() - t0 + d > policy.deadline):
                    break
                time.sleep(d)
        raise PSShardDown(
            j, self.addrs[j],
            f"unrecovered after {policy.describe()} reconnect attempts"
        ) from last

    def disconnect(self):
        """Graceful 'q' + close on every shard (best effort)."""
        for j, sock in enumerate(self._socks):
            if sock is not None:
                try:
                    networking.send_opcode(sock, b"q")
                    sock.close()
                except OSError:
                    pass
                self._socks[j] = None

    def abort(self):
        """Hard-close every shard socket without the graceful 'q' — each
        shard sees a plain EOF, the signature of a worker host dying (the
        fault-injection path)."""
        for j, sock in enumerate(self._socks):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
                self._socks[j] = None

    # -- transport with shard-fault attribution ------------------------------
    def _send_frame(self, j: int, payload: dict):
        pool = self._send_pools[j]
        if pool is None:
            networking.send_data(self._socks[j], payload)
        else:
            networking.send_data(self._socks[j], payload, pool=pool)

    def _send(self, j: int, op: bytes, payload: Optional[dict] = None):
        try:
            networking.send_opcode(self._socks[j], op)
            if payload is not None:
                self._send_frame(j, payload)
        except (ConnectionError, OSError) as e:
            if not self.recovery:
                raise PSShardDown(j, self.addrs[j]) from e

            # reconnect-resume: re-dial and re-issue this request on the
            # fresh connection.  If the shard restarted, the re-sent commit
            # still carries the OLD generation — the server drops it and
            # (for 'u') replies with its current state, which re-syncs us.
            def resend():
                networking.send_opcode(self._socks[j], op)
                if payload is not None:
                    self._send_frame(j, payload)

            self._with_resume(j, resend, e)
        if payload is not None:
            key = (j, payload.get("gen"))
            self.sent[key] = self.sent.get(key, 0) + 1
            self._unconfirmed[j].append(key)

    def _recv(self, j: int) -> Tuple[Dict[str, Any], bool]:
        """One reply from shard ``j`` as ``(reply, resumed)``.  On a
        transport fault with recovery on, the in-flight reply died with the
        connection (its window may or may not have applied — bounded loss);
        re-sync with a plain pull on the fresh connection and hand that
        back as the reply (``resumed=True``)."""
        try:
            return (networking.recv_data(self._socks[j],
                                         pool=self._pools[j]), False)
        except (ConnectionError, OSError, ValueError) as e:
            # ValueError = corrupt/torn reply frame (chaos): the stream is
            # desynchronized either way — same recovery as a dead socket
            if not self.recovery:
                raise PSShardDown(j, self.addrs[j]) from e

            def resync():
                networking.send_opcode(self._socks[j], b"p")
                return networking.recv_data(self._socks[j],
                                            pool=self._pools[j])

            return self._with_resume(j, resync, e), True

    def _split_commit(self, msg: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Scatter a full commit message into per-shard messages: each shard
        gets only its delta slices (and, for int8, the parent tensor's scale
        per slice — quantization happened on the *full* tensor, so the
        as-applied delta is independent of the sharding), stamped with that
        shard's own last-seen clock.

        A SPARSE commit (``networking.SparseDelta`` — the flat top-k wire
        form) splits by index bisection instead: each global flat index maps
        to its owning shard's interval and re-indexes into that shard's own
        flat coordinates (``ShardPlan.split_sparse``); the per-commit value
        scale (int8-coded values) is shared by every shard, because the
        quantization ran on the full selected set before the scatter."""
        deltas = msg["delta"]
        out: List[Dict[str, Any]] = []
        if isinstance(deltas, networking.SparseDelta):
            parts = self.plan.split_sparse(deltas.indices, deltas.values)
            shard_elems = self.plan.shard_elements()
            for j, (li, lv) in enumerate(parts):
                m: Dict[str, Any] = {
                    "delta": networking.SparseDelta(li, lv, shard_elems[j],
                                                    deltas.scale),
                    "worker_id": msg.get("worker_id"),
                    "clock": self._clocks[j]}
                if self._gens[j] is not None:
                    m["gen"] = self._gens[j]
                out.append(m)
            return out
        scales = msg.get("scales")

        def take_piece(s: ShardSlice):
            d = deltas[s.tensor]
            if isinstance(d, networking.RowSparseDelta):
                # row-sparse embedding block: each shard gets the touched
                # rows its leading-axis range owns, re-indexed into the
                # slice's LOCAL row coordinates — the row twin of
                # split_sparse's flat-index bisection (rows are sorted, so
                # slicing preserves the wire contract per shard)
                return d.slice_rows(s.start, s.stop)
            return self.plan.take(d, s)

        for j, pieces in enumerate(self.plan.assignments):
            m = {
                "delta": [take_piece(s) for s in pieces],
                "worker_id": msg.get("worker_id"),
                "clock": self._clocks[j]}
            if self._gens[j] is not None:
                # generation handshake: a shard respawned since this clock
                # was read rejects the commit instead of applying it to a
                # rolled-back center
                m["gen"] = self._gens[j]
            if scales is not None:
                m["scales"] = [scales[s.tensor] for s in pieces]
            out.append(m)
        return out

    # -- operations ----------------------------------------------------------
    def pull(self) -> List[np.ndarray]:
        """'p' on every shard, then gather the replies into the full weight
        list (freshly allocated — safe across later receives)."""
        for j in range(self.num_shards):
            self._send(j, b"p")
        return self._gather_replies()

    def send_commit(self, msg: Dict[str, Any]):
        """Scatter one 'c' commit across the shards (fire-and-forget)."""
        for j, m in enumerate(self._split_commit(msg)):
            self._send(j, b"c", m)

    def send_update(self, msg: Dict[str, Any]):
        """Scatter one 'u' commit+pull across the shards; every shard's
        combined reply stays in flight until ``recv_update`` — the overlap
        window the pipelined workers ride, per shard."""
        for j, m in enumerate(self._split_commit(msg)):
            self._send(j, b"u", m)

    def recv_update(self) -> List[np.ndarray]:
        """Drain the 'u' replies from every shard and gather the center."""
        return self._gather_replies(dedupe=True)

    def update(self, msg: Dict[str, Any]) -> List[np.ndarray]:
        """Blocking combined commit+pull across all shards (serial-path
        form of send_update + recv_update)."""
        self.send_update(msg)
        return self.recv_update()

    def _sync_reply(self, j: int, reply: Dict[str, Any]):
        """Fold a reply's (gen, clock) into the per-shard view: generations
        follow the server (a respawn bumps them); clocks stay MONOTONIC —
        a restored shard clock behind ours (post-snapshot windows dropped)
        must not roll the staleness baseline backwards."""
        g = reply.get("gen")
        if g is not None:
            self._gens[j] = int(g)
        c = int(reply["clock"])
        self._conn_clocks[j] = c
        if c < self._clocks[j]:
            self.clock_regressions += 1
        self._clocks[j] = max(self._clocks[j], c)
        self._unconfirmed[j].clear()  # a reply confirms what came before

    def _gather_replies(self, dedupe: bool = False) -> List[np.ndarray]:
        slices = []
        stale_flags = [False] * self.num_shards
        for j in range(self.num_shards):
            reply, resumed = self._recv(j)
            if dedupe and self.recovery and not resumed:
                # a chaos proxy can replay a 'u' reply.  WITHIN one
                # connection a genuine combined reply always advances the
                # clock (our own commit bumped it; a gen-rejected commit is
                # marked "stale" and exempt), so a non-advancing unmarked
                # reply is a duplicate to discard.  The per-connection
                # baseline matters: a restarted shard's clock legitimately
                # restarts below the MONOTONIC view.
                while (not reply.get("stale")
                       and self._conn_clocks[j] is not None
                       and int(reply["clock"]) <= self._conn_clocks[j]):
                    self.stale_replies += 1
                    reply, resumed = self._recv(j)
                    if resumed:
                        break
            self._sync_reply(j, reply)
            # a gen-rejected ('stale'-marked) combined reply means this
            # shard DROPPED the in-flight commit — surfaced per shard so
            # topk workers can re-credit the dropped mass into their
            # error-feedback residual (a resumed pull re-sync stays False:
            # its commit's fate is unknown, the bounded-loss class)
            stale_flags[j] = bool(reply.get("stale")) and not resumed
            slices.append(reply["weights"])
        self.last_stale = stale_flags
        # per-shard pools: shard j's views stay valid while shard j+1
        # receives into its own pool, so one gather after the loop is safe
        return self.plan.gather(slices)


# ---------------------------------------------------------------------------
# trainer side
# ---------------------------------------------------------------------------

class ShardedServerGroup:
    """N ``SocketParameterServer`` instances, each wrapping the unchanged
    per-algorithm apply rule on its slice of the center.

    Presents the slice-of-lifecycle surface ``run_host_ps_training`` needs:
    start/stop, per-shard ports, a consistent (gathered center, per-shard
    clocks) snapshot for checkpointing, and ``get_model()``.
    """

    def __init__(self, algorithm: str, model_blob: dict, num_workers: int,
                 num_shards: int, host: str = "127.0.0.1",
                 ps_core: str = "event", coalesce: bool = True,
                 apply_kernel: Optional[str] = None):
        from .parameter_servers import (allocate_parameter_server,
                                        make_socket_server)
        weights = [np.asarray(w) for w in model_blob["weights"]]
        self.model_blob = model_blob
        self.plan = make_shard_plan([w.shape for w in weights],
                                    [w.dtype for w in weights], num_shards)
        self.servers = []
        for shard_w in self.plan.scatter(weights):
            ps = allocate_parameter_server(
                algorithm,
                {"model": model_blob["model"], "weights": shard_w},
                num_workers, apply_kernel=apply_kernel)
            self.servers.append(make_socket_server(
                ps, host=host, ps_core=ps_core, coalesce=coalesce))

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    @property
    def ports(self) -> List[int]:
        return [s.port for s in self.servers]

    @property
    def addrs(self) -> List[Tuple[str, int]]:
        return [(s.host, s.port) for s in self.servers]

    @property
    def coalesce_stats(self) -> Optional[dict]:
        """Summed event-core drain counters across the shards (None when
        the group runs the threaded core)."""
        per_shard = [getattr(s, "coalesce_stats", None)
                     for s in self.servers]
        if not any(per_shard):
            return None
        out = {"drains": 0, "commits_applied": 0, "coalesced_drains": 0,
               "max_drain": 0}
        for st in per_shard:
            if st is None:
                continue
            out["drains"] += st["drains"]
            out["commits_applied"] += st["commits_applied"]
            out["coalesced_drains"] += st["coalesced_drains"]
            out["max_drain"] = max(out["max_drain"], st["max_drain"])
        out["mean_drain"] = (round(out["commits_applied"]
                                   / out["drains"], 3)
                             if out["drains"] else None)
        return out

    def start(self):
        try:
            for s in self.servers:
                s.start()
        except Exception:
            self.stop()
            raise

    def stop(self):
        for s in self.servers:
            s.stop()

    def snapshot(self) -> Tuple[List[np.ndarray], List[int]]:
        """(gathered full center, per-shard clocks).  Each shard snapshots
        under its own apply lock; the composite is only epoch-wave
        consistent, exactly like the single-PS checkpoint (commits within an
        epoch stay hogwild by design)."""
        slices, clocks = [], []
        for s in self.servers:
            with s.ps._lock:
                slices.append([w.copy() for w in s.ps.center])
                clocks.append(s.ps.num_updates)
        return self.plan.gather(slices), clocks

    def restore_state(self, center: Sequence[np.ndarray], clocks):
        clocks = [int(c) for c in np.asarray(clocks).reshape(-1)]
        if len(clocks) != self.num_shards:
            raise ValueError(
                f"checkpoint carries {len(clocks)} shard clocks; this run "
                f"has ps_shards={self.num_shards} — resume with the same "
                "configuration")
        slices = self.plan.scatter(
            [np.asarray(w, np.float32) for w in center])
        for s, sw, c in zip(self.servers, slices, clocks):
            with s.ps._lock:
                s.ps.center = [np.array(w, dtype=np.float32, copy=True)
                               for w in sw]
                s.ps.num_updates = c

    def get_model(self, device: DeviceLike = None):
        """The gathered center as a ``FittedModel`` on ``device`` (None is
        the card)."""
        from .core.model import FittedModel, deserialize_model
        center, _ = self.snapshot()
        return FittedModel(deserialize_model(
            {"model": self.model_blob["model"], "weights": center},
            device=device))
