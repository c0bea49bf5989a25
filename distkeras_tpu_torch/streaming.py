"""Streaming ingestion and online training, port of
``distkeras_tpu/streaming.py``: the bounded row buffer (``StreamBuffer``),
the unbounded-stream data contract (``StreamSource``, with its producer
``feed_stream``), the horizon loop (``run_stream_training``) and the
row-sparse table detection of the host parameter server's ``row_sparse=``
knob (``embedding_weight_indices``, ``resolve_row_sparse_tables``).

Differences from the JAX module:

 - **bf16 rows without ``ml_dtypes``**: the port's wire decodes a
   ``"bfloat16"`` leaf as a CPU ``torch.bfloat16`` tensor
   (``networking``), so the buffer keeps a torch ring for torch chunks
   and a numpy ring for everything else; rows come out as the kind they
   went in, and ``feed_stream`` sends either kind;
 - **the ring copies a chunk in one indexed assignment** (the JAX module
   loops row by row): the same ring positions, the same bytes;
 - **the horizon loop waits for the commits that can still land**
   before it hands ``on_horizon`` the center and before it reads the
   fitted one (``parameter_servers._LeaseLoop``, shared with the elastic
   epoch engine): the JAX loop reads both right after the ledger closes,
   which can miss a serial worker's fire-and-forget last ``'c'``;
 - **each worker's first window runs in its own thread, off the lease
   clock** (the seeding window too, in a fresh thread): the port's first
   window in a thread builds its cuDNN and cuBLAS handles, where the JAX
   program compiles once for every thread;
 - ``on_horizon`` and the fitted model get the center as a
   ``FittedModel`` on the trainer's device.

The weight order of the row-sparse resolver is the JAX package's leaf
order (``core.model.jax_leaves``: layer by layer, each layer's keys
sorted), so a layer's leaf count locates its weights in the flat list
exactly as the JAX module's ``tree_leaves`` count does.

The JAX module's description follows.

Streaming ingestion — the unbounded-traffic online-learning path.
Production parameter-server workloads are not epochal: a recommender
ingests a continuous click-stream and trains online, forever — the
canonical workload parameter servers were invented for at industrial
scale (Dean et al. NIPS'12; Li et al. OSDI'14).  Three pieces:

 - ``StreamBuffer`` — a bounded host-side row buffer (preallocated ring
   storage per column, lazily shaped from the first chunk).  Producers
   block when it is full (**backpressure** — an over-fast feed cannot
   OOM the trainer host) and consumers block until rows arrive or the
   stream closes.
 - ``StreamSource`` — the unbounded-stream data contract the trainers
   consume: ``read(n)`` returns up to ``n`` rows (blocking) and ``None``
   once the stream is exhausted.  Backed by a generator of ``(x, y)``
   chunks (deterministic, no sockets) or by a socket feed speaking the
   ordinary wire codec (``{"x", "y"}`` frames then ``{"end": True}``)
   whose ingest loop receives every frame into a reusable ``BufferPool``
   scratch — no per-batch allocation on the ingest path; the ring copy is
   the only byte movement.
 - ``run_stream_training`` — the horizon loop: instead of leasing "an
   epoch", it re-leases a sliding horizon of ``horizon_windows``
   communication windows through the unchanged ``LeaseLedger`` /
   ``WorkerSupervisor`` / ``PSWorker.train_leases`` machinery, so elastic
   workers, death→respawn, straggler steal, and the exactly-once
   completion contract carry over from epochs to horizons: killing k of N
   workers mid-horizon loses zero examples within the horizon.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from . import networking
from .core.layers import Embedding, layer_leaves
from .core.model import Sequential, jax_leaves

__all__ = ["StreamBuffer", "StreamSource", "feed_stream",
           "embedding_weight_indices", "resolve_row_sparse_tables",
           "run_stream_training"]


def _rows(a):
    """A chunk column as the buffer stores it: a CPU torch tensor stays a
    tensor (the wire's bf16 rows), anything else becomes a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return np.asarray(a)


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# the bounded host-side buffer
# ---------------------------------------------------------------------------

class StreamBuffer:
    """Bounded ring buffer of (x, y) rows decoupling ingest from training.

    Storage is allocated ONCE, lazily, from the first pushed chunk's
    shapes and dtypes (``capacity_rows`` rows per column; a torch ring for
    torch chunks, a numpy ring otherwise); every later push copies rows
    into the ring in place — the steady-state ingest path allocates
    nothing.  ``push`` blocks while the ring is full (backpressure toward
    the producer; pass ``block=False`` to let a same-thread producer grow
    the ring instead — the synchronous generator mode, where blocking
    would deadlock), ``take`` blocks until rows are available or the
    stream is closed AND drained (then returns None).
    """

    def __init__(self, capacity_rows: int = 8192):
        if int(capacity_rows) < 1:
            raise ValueError("capacity_rows must be >= 1")
        self.capacity = int(capacity_rows)
        self._cond = threading.Condition()
        self._x = None  # ring storage, lazy
        self._y = None
        self._head = 0  # oldest buffered row
        self._count = 0  # buffered rows
        self._closed = False
        #: observability: rows through the buffer, ring growths (sync mode)
        self.rows_in = 0
        self.rows_out = 0
        self.grows = 0

    def __len__(self) -> int:
        with self._cond:
            return self._count

    @staticmethod
    def _empty(like, rows: int):
        if isinstance(like, torch.Tensor):
            return torch.empty((rows,) + tuple(like.shape[1:]),
                               dtype=like.dtype)
        return np.empty((rows,) + like.shape[1:], like.dtype)

    def _ensure_storage(self, x, y):
        if self._x is None:
            self._x = self._empty(x, self.capacity)
            self._y = self._empty(y, self.capacity)
        elif (tuple(x.shape[1:]) != tuple(self._x.shape[1:])
              or tuple(y.shape[1:]) != tuple(self._y.shape[1:])):
            raise ValueError(
                f"stream chunk rows shaped {tuple(x.shape[1:])}/"
                f"{tuple(y.shape[1:])} do not match the stream's "
                f"{tuple(self._x.shape[1:])}/{tuple(self._y.shape[1:])}")

    def _positions(self, start: int, n: int) -> np.ndarray:
        return (start + np.arange(n)) % self.capacity

    @staticmethod
    def _index(ring, idx: np.ndarray):
        return torch.from_numpy(idx) if isinstance(ring, torch.Tensor) \
            else idx

    def _grow(self, need: int):
        """Reallocate the ring to hold ``need`` rows (synchronous-producer
        mode only: the consumer is the same thread, so blocking on a full
        ring would deadlock — the bound is advisory there)."""
        new_cap = max(need, 2 * self.capacity)
        idx = self._positions(self._head, self._count)
        for name in ("_x", "_y"):
            old = getattr(self, name)
            new = self._empty(old, new_cap)
            new[:self._count] = old[self._index(old, idx)]
            setattr(self, name, new)
        self._head = 0
        self.capacity = new_cap
        self.grows += 1

    def push(self, x, y, block: bool = True,
             timeout: Optional[float] = None) -> None:
        """Copy a chunk of rows into the ring.  Blocks while full
        (``block=True``, the threaded-ingest backpressure); with
        ``block=False`` the ring grows instead.  Raises on a push after
        ``close()`` or on shape mismatch."""
        x, y = _rows(x), _rows(y)
        if len(x) != len(y):
            raise ValueError(
                f"stream chunk has {len(x)} feature rows but {len(y)} "
                "label rows")
        deadline = None if timeout is None else time.monotonic() + timeout
        off = 0
        with self._cond:
            self._ensure_storage(x, y)
            while off < len(x):
                if self._closed:
                    raise RuntimeError("push() after close()")
                free = self.capacity - self._count
                if free == 0:
                    if not block:
                        self._grow(self._count + (len(x) - off))
                        continue
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            "stream buffer full past the push timeout")
                    self._cond.wait(remaining)
                    continue
                n = min(free, len(x) - off)
                # ring positions may wrap: one indexed copy in place
                pos = self._positions(self._head + self._count, n)
                self._x[self._index(self._x, pos)] = x[off:off + n]
                self._y[self._index(self._y, pos)] = y[off:off + n]
                self._count += n
                self.rows_in += n
                off += n
                self._cond.notify_all()

    def take(self, max_rows: int, timeout: Optional[float] = None
             ) -> Optional[Tuple[Any, Any]]:
        """Pop up to ``max_rows`` rows (freshly-allocated copies — safe to
        keep across later pushes).  Blocks until at least one row is
        available; returns None once the stream is closed AND drained,
        raises TimeoutError past ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._count == 0:
                if self._closed:
                    return None
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "no stream rows arrived within the take timeout")
                self._cond.wait(remaining)
            n = min(int(max_rows), self._count)
            idx = self._positions(self._head, n)
            # an indexed read allocates its result: the copy is owned
            out = (self._x[self._index(self._x, idx)],
                   self._y[self._index(self._y, idx)])
            self._head = (self._head + n) % self.capacity
            self._count -= n
            self.rows_out += n
            self._cond.notify_all()
            return out

    def close(self) -> None:
        """End of stream: blocked takers drain what is buffered, then get
        None; further pushes raise."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed


# ---------------------------------------------------------------------------
# the stream source contract
# ---------------------------------------------------------------------------

def _contiguous(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous()
    return np.ascontiguousarray(a)


def feed_stream(sock: socket.socket, chunks: Iterable[Tuple[Any, Any]],
                pool: Optional[networking.BufferPool] = None) -> int:
    """Producer helper: frame ``(x, y)`` chunks onto ``sock`` with the
    ordinary wire codec (pooled encode — steady-state same-shape chunks
    re-serialize into one reusable buffer) and terminate with the
    ``{"end": True}`` frame.  A chunk column may be a numpy array or a CPU
    torch tensor (a ``torch.bfloat16`` one goes out under the wire dtype
    ``"bfloat16"``).  Returns the number of rows fed."""
    pool = pool or networking.BufferPool()
    rows = 0
    for x, y in chunks:
        networking.send_data(sock, {"x": _contiguous(x),
                                    "y": _contiguous(y)}, pool=pool)
        rows += len(x)
    networking.send_data(sock, {"end": True}, pool=pool)
    return rows


class StreamSource:
    """The unbounded-stream data contract the streaming trainers consume.

    ``read(n)`` returns up to ``n`` rows as freshly-owned ``(x, y)``
    arrays (or CPU tensors, for torch chunks) — blocking until they
    arrive — and ``None`` once the stream is exhausted and drained.  Two
    backends:

     - ``StreamSource(generator=gen)`` — ``gen`` yields ``(x, y)`` chunk
       pairs; chunks are pulled lazily on ``read`` (same thread, no
       sockets, no sleeps).
     - ``StreamSource(sock=...)`` / ``StreamSource(addr=(host, port))`` —
       a live socket feed: ``start()`` spawns an ingest thread that
       receives ``{"x", "y"}`` frames through the wire codec into a
       reusable ``BufferPool`` scratch (zero-copy views, no per-batch
       allocation on the ingest path) and copies the rows into the
       bounded ``StreamBuffer`` before the next receive reuses the
       scratch; a full buffer blocks the ingest thread — TCP backpressure
       toward the feed.  ``{"end": True}`` (or EOF) closes the stream.
       Use as a context manager or call ``stop()``.

    ``pool`` is injectable so tests can count scratch-buffer reuse.
    """

    def __init__(self, generator=None, sock: Optional[socket.socket] = None,
                 addr: Optional[Tuple[str, int]] = None,
                 buffer_rows: int = 8192,
                 pool: Optional[networking.BufferPool] = None):
        if sum(s is not None for s in (generator, sock, addr)) != 1:
            raise ValueError(
                "StreamSource needs exactly one of generator=, sock=, addr=")
        self._gen = iter(generator) if generator is not None else None
        self._sock = sock
        self._addr = addr
        self.buffer = StreamBuffer(buffer_rows)
        self._pool = pool if pool is not None else networking.BufferPool()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        #: ingest-side error (socket mode), re-raised at the next read()
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StreamSource":
        """Socket mode: connect (if ``addr``) and start the ingest thread.
        Generator mode: no-op (chunks are pulled on read)."""
        if self._started or self._gen is not None:
            self._started = True
            return self
        self._started = True
        if self._sock is None:
            self._sock = networking.connect(*self._addr)
        self._thread = threading.Thread(target=self._ingest, daemon=True,
                                        name="dkt-stream-ingest")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.buffer.close()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StreamSource":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- ingest (socket mode) -------------------------------------------------
    def _ingest(self) -> None:
        try:
            while True:
                # pooled receive: the frame lands in reusable scratch and
                # decodes to views over it — the ring push below copies
                # the rows out before the next receive reuses the memory
                msg = networking.recv_data(self._sock, pool=self._pool)
                if not isinstance(msg, dict) or msg.get("end"):
                    return
                self.buffer.push(msg["x"], msg["y"])
        except (ConnectionError, OSError, ValueError):
            return  # EOF/reset/torn frame: the stream ends where it broke
        except BaseException as e:  # surfaced at the consumer's next read
            self._error = e
        finally:
            self.buffer.close()

    # -- the consumer contract -----------------------------------------------
    def read(self, n: int, timeout: Optional[float] = None
             ) -> Optional[Tuple[Any, Any]]:
        """Up to ``n`` rows, blocking until available (accumulating across
        chunks); None once the stream is exhausted and drained."""
        self.start()
        if self._gen is not None:
            # synchronous pull: buffer chunks until n rows are staged (the
            # ring grows past its bound rather than deadlock — same-thread
            # producer/consumer)
            while len(self.buffer) < n and not self.buffer.closed:
                chunk = next(self._gen, None)
                if chunk is None:
                    self.buffer.close()
                    break
                self.buffer.push(chunk[0], chunk[1], block=False)
        parts_x: List[Any] = []
        parts_y: List[Any] = []
        got = 0
        while got < n:
            chunk = self.buffer.take(n - got, timeout=timeout)
            if chunk is None:
                break
            parts_x.append(chunk[0])
            parts_y.append(chunk[1])
            got += len(chunk[0])
            if self.buffer.closed and len(self.buffer) == 0:
                break
        if self._error is not None:
            raise self._error
        if not parts_x:
            return None
        if len(parts_x) == 1:
            return parts_x[0], parts_y[0]
        return _cat(parts_x), _cat(parts_y)


# ---------------------------------------------------------------------------
# row-sparse table detection (the model side of row_sparse=)
# ---------------------------------------------------------------------------

def embedding_weight_indices(model: Sequential) -> List[int]:
    """Weight-list indices of every ``Embedding`` table in ``model``.

    An ``Embedding`` layer carries exactly one leaf — its ``(vocab, dim)``
    table — and each layer's leaf count (parameters and BatchNorm
    statistics alike) advances the offset in the flat list.
    """
    out: List[int] = []
    off = 0
    for layer in model.layers:
        if isinstance(layer, Embedding):
            out.append(off)
        off += sum(1 for _ in layer_leaves(layer))
    return out


def resolve_row_sparse_tables(spec, model: Sequential) -> List[int]:
    """Resolve the trainer's ``row_sparse=`` knob to weight-list indices.

    ``True`` detects every ``Embedding`` table from the model (and refuses
    a model that has none — silently committing everything dense would be
    a no-op knob); an iterable of ints passes through validated against
    the weight list.
    """
    shapes = [tuple(p.shape) for _, p in jax_leaves(model)]
    if spec is True:
        tables = embedding_weight_indices(model)
        if not tables:
            raise ValueError(
                "row_sparse=True but the model has no Embedding layer — "
                "pass explicit weight indices or drop the knob")
        return tables
    tables = sorted({int(t) for t in spec})
    for t in tables:
        if not 0 <= t < len(shapes):
            raise ValueError(
                f"row_sparse names weight {t}; model has "
                f"{len(shapes)} weights")
        if len(shapes[t]) < 2:
            raise ValueError(
                f"row_sparse weight {t} has shape {shapes[t]} — row "
                "sparsity needs a (rows, dim...) table")
    return tables


# ---------------------------------------------------------------------------
# the horizon loop
# ---------------------------------------------------------------------------

def run_stream_training(trainer, source, on_horizon: Optional[
        Callable[[int, Any], None]] = None):
    """Train a host-PS trainer online from an unbounded ``StreamSource``.

    The epoch loop becomes a HORIZON loop: each iteration reads up to
    ``horizon_windows × communication_window × batch_size`` rows from the
    stream (blocking until they arrive; the tail horizon takes whatever is
    left), shuffles them deterministically (``default_rng(seed + 7919 ·
    horizon)``), and re-leases them through the elastic engine's
    ``LeaseLedger`` / ``WorkerSupervisor`` machinery — one ledger "epoch"
    per horizon, so elastic membership, straggler steal and the
    exactly-once completion contract apply verbatim: killing k of N
    workers mid-horizon loses zero examples within the horizon (asserted
    per horizon, once every commit that can still land has applied).

    ``on_horizon(h, model)`` (or ``trainer.on_horizon``) is called after
    each completed horizon with a ``FittedModel`` of the live center on
    the trainer's device — the accuracy-tracks-drift hook.  The trainer's
    ``_on_ps_ready(server, addr)``, when set, is called once the PS
    listens and before any worker commits (the online-deployment seam),
    and its ``_on_ps_close()``, when set, once the run is over and before
    the PS stops (the seam where a deployment detaches its engine).
    The run ends when the stream does, or after ``trainer.max_horizons``
    horizons.
    """
    from .core.model import serialize_model
    from .parameter_servers import (WORKER_CLASSES, _LeaseLoop,
                                    _worker_kwargs,
                                    allocate_parameter_server,
                                    make_socket_server, resolve_ps_hosts)
    from .ps_sharding import ShardedServerGroup
    from .resilience import ShardSupervisor

    algorithm = trainer.ALGORITHM
    if algorithm not in WORKER_CLASSES:
        raise ValueError(
            f"stream=True supports PS algorithms {sorted(WORKER_CLASSES)}, "
            f"not {algorithm!r} ({type(trainer).__name__})")
    if trainer.checkpoint_dir is not None:
        raise ValueError(
            "stream=True owns a horizon loop with no epoch waves to "
            "checkpoint between — use checkpoint_dir=None (the PS center "
            "is the live state; snapshot it via recovery=True)")
    if not isinstance(source, StreamSource):
        raise ValueError(
            f"stream=True trains from a streaming.StreamSource, got "
            f"{type(source).__name__} — wrap a generator or socket feed")

    trainer.record_training_start()
    trainer.failed_workers = []
    trainer.worker_failures = {}
    trainer.elastic_stats = {}
    trainer.stream_stats = {}

    n = trainer.num_workers * getattr(trainer, "parallelism_factor", 1)
    win_rows = trainer.communication_window * trainer.batch_size
    horizon_windows = getattr(trainer, "horizon_windows", None)
    if horizon_windows is None:
        # ~8 windows per worker per horizon: enough leases for stealing
        # and respawn pickup, small enough that the model tracks drift at
        # horizon granularity
        horizon_windows = 8 * n
    horizon_rows = horizon_windows * win_rows
    max_horizons = getattr(trainer, "max_horizons", None)

    source.start()
    first = source.read(horizon_rows)
    if first is None:
        raise ValueError("stream ended before yielding any rows")

    x0, y0 = first
    model0 = trainer._initial_params(tuple(x0.shape[1:]))
    blob = serialize_model(model0)

    ps_shards = int(getattr(trainer, "ps_shards", 1) or 1)
    recovery = bool(getattr(trainer, "recovery", False))
    ps_core = getattr(trainer, "ps_core", "event") or "event"
    coalesce = bool(getattr(trainer, "coalesce", True))
    apply_kernel = getattr(trainer, "apply_kernel", None)
    # the PS address pair: bind where the server listens, advertise what
    # workers — and any attach_ps serving engine — dial
    bind_host, advertise_host = resolve_ps_hosts(trainer)
    sharded = ps_shards > 1 or recovery
    if sharded:
        server = ShardedServerGroup(algorithm, blob, n, ps_shards,
                                    host=bind_host, ps_core=ps_core,
                                    coalesce=coalesce,
                                    apply_kernel=apply_kernel)
    else:
        ps = allocate_parameter_server(algorithm, blob, n,
                                       apply_kernel=apply_kernel)
        server = make_socket_server(ps, host=bind_host, ps_core=ps_core,
                                    coalesce=coalesce)
    supervisor = loop = None
    horizon = 0
    rows_total = 0
    workers: list = []
    t0 = time.perf_counter()
    try:
        server.start()
        if recovery:
            supervisor = ShardSupervisor(server, algorithm, n)
            supervisor.start()
        trainer._ps_supervisor = supervisor
        #: the live server object and the address a co-deployed serving
        #: engine should dial (deployment_online.py, tests)
        trainer._ps_server = server
        trainer._ps_advertise_addr = (
            advertise_host, server.ports[0] if sharded else server.port)
        ready_cb = getattr(trainer, "_on_ps_ready", None)
        if ready_cb is not None:
            # the online-deployment seam: the PS exists only inside this
            # run, so a co-deployed ServingEngine attaches here, once the
            # address is live and before any worker commits
            ready_cb(server, trainer._ps_advertise_addr)

        kw = _worker_kwargs(trainer, n, horizon_rows)
        kw.update(worker_optimizer=trainer.worker_optimizer,
                  ps_host=advertise_host,
                  ps_port=server.ports[0] if sharded else server.port,
                  device=trainer.device)
        if sharded:
            addrs = [(advertise_host, int(p)) for _, p in server.addrs]
            hook = getattr(trainer, "_shard_addr_hook", None)
            if hook is not None:
                addrs = [(str(h), int(p)) for h, p in hook(list(addrs))]
            kw.update(shard_plan=server.plan, shard_addrs=addrs)
        if recovery:
            kw.update(recovery=True,
                      retry_policy=getattr(trainer, "recovery_policy", None))
        rs = getattr(trainer, "row_sparse", None)
        if rs:
            kw.update(row_sparse_tables=resolve_row_sparse_tables(rs,
                                                                  model0))
        lease_windows = getattr(trainer, "lease_windows", None)
        if lease_windows is None:
            lease_windows = max(1, horizon_windows // (4 * n))
        loop = _LeaseLoop(trainer, n, WORKER_CLASSES[algorithm], blob, kw,
                          server, supervisor, x0, y0, lease_windows)
        on_horizon = on_horizon or getattr(trainer, "on_horizon", None)
        chunk: Optional[Tuple[Any, Any]] = (x0, y0)
        while chunk is not None:
            hx, hy = chunk
            # deterministic within-horizon shuffle: leases are contiguous
            # row ranges of this permutation, so lease boundaries resample
            # every horizon (the streaming twin of the per-epoch shuffle)
            perm = np.random.default_rng(
                trainer.seed + 7919 * horizon).permutation(len(hx))
            if isinstance(hx, torch.Tensor):
                perm = torch.from_numpy(perm)
            loop.ledger.resize(len(hx))
            # the zero-data-loss contract, asserted per horizon
            loop.run(horizon, hx[perm], hy[perm])
            rows_total += len(hx)
            horizon += 1
            if on_horizon is not None:
                on_horizon(horizon - 1,
                           server.get_model(device=trainer.device))
            if max_horizons is not None and horizon >= max_horizons:
                break
            chunk = source.read(horizon_rows)
    finally:
        if loop is not None:
            workers = loop.close(trainer)
        if supervisor is not None:
            # first: the group teardown must not read as shard deaths
            supervisor.stop()
        close_cb = getattr(trainer, "_on_ps_close", None)
        try:
            if close_cb is not None:
                close_cb()
        finally:
            server.stop()
        trainer.ps_coalesce_stats = getattr(server, "coalesce_stats", None)
        elapsed = time.perf_counter() - t0
        trainer.stream_stats = {
            "horizons": horizon,
            "rows": rows_total,
            "horizon_rows": horizon_rows,
            "examples_per_sec": (round(rows_total / elapsed, 1)
                                 if elapsed > 0 else None),
            "buffer": {"rows_in": source.buffer.rows_in,
                       "rows_out": source.buffer.rows_out,
                       "grows": source.buffer.grows},
        }

    trainer.history.clear()
    for w in workers:
        trainer.history.extend(w.history)
    fitted = server.get_model(device=trainer.device)
    trainer._fitted = fitted
    trainer.record_training_stop()
    return fitted
