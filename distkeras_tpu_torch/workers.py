"""Worker closures for the host-parameter-server execution path, port of
``distkeras_tpu/workers.py``.

Reference being replaced: ``distkeras/workers.py`` (SURVEY.md §2.1 rows
12–13) — per-partition training closures shipped to Spark executors, each
connecting back to the driver's socket PS, pulling the center model,
training local minibatches, and committing weight deltas every
``communication_window`` steps.

Here a worker is a thread (same-host, like the reference's Spark
``local[*]`` mode) whose window program runs on the trainer's device: one
loop of the port's masked steps (``core.train.make_masked_step``) per
communication window, over the epoch's windows copied to the device once
per epoch.  Host↔device traffic happens once per window, when the
algorithm needs the weights on the host anyway for the commit.  The
update-rule math mirrors ``parallel/rules.py`` (the JAX workers' too:
``tests/test_torch_host_ps_parity.py``); only the execution differs
(true asynchronous hogwild commits against a live PS, vs. deterministic
bulk-synchronous rounds).

What differs from the JAX workers:

 - **One model per worker.**  The port's step updates the module's own
   parameters in place, so no two workers may share a ``Sequential``:
   each worker builds its own from the blob and owns its optimizer state
   and its ``torch.Generator``.  ``share_compiled_state`` shares only the
   update rule (a stateless ``Transform``).
 - **One copy each way per window.**  ``_fetch`` flattens the
   leaves on the device and brings them (and the window's loss) to the
   host in one copy; ``_weights_to_params`` sends the weights in one copy
   and writes them into the existing parameters in place, which the
   optimizer state refers to.
 - **bf16 on the wire without ``ml_dtypes``.**  ``wire_dtype="bfloat16"``
   rounds each delta through ``torch.bfloat16`` (round to nearest even, as
   ``ml_dtypes`` does) and ships CPU bf16 tensors, which ``networking``
   frames under the JAX package's wire name; ``"float16"`` and ``"int8"``
   are the JAX module's numpy code.
 - **Top-k on the device, in place.**  ``wire_dtype="topk"`` on the
   delta family takes the flat f32 base before the window trains the
   parameters in place, forms ``eff = after − base + residual`` in a
   persistent device residual, selects with ``torch.topk`` (XLA's
   ``lax.top_k`` in the JAX package) and brings the loss, the scale, the k
   int32 indices and the k codes to the host in one copy of one packed
   byte tensor.  bf16 codes are CPU ``torch.bfloat16`` tensors on the
   wire; ``topk_select`` (the host twin) rounds through torch, not
   ``ml_dtypes``.
 - **Row-sparse tables** clone each table's f32 base on the device before
   the window, and the loss, the non-table leaves and the touched-row
   masks come back in one copy.
 - **Dropout** draws from a ``torch.Generator`` seeded from (seed, worker,
   epoch): its masks are not the JAX package's.
 - What waits for ROADMAP queue A item 6 raises: partition tolerance,
   reconnect-resume (``recovery``), the elastic lease loop
   (``train_leases``/``compile_windows``) and the ``'exit'``/``'hang'``
   fault kinds.

With ``comm_overlap`` the transport is *pipelined*: each window becomes one
combined ``'u'`` (commit+pull) round trip whose reply is received while the
next window's program runs on the device (``PSWorker._train_epoch_
overlapped``).  All workers launch on the device's default stream, so the
card serialises their windows, and a worker's fetch waits for every
worker's queued work.
"""

from __future__ import annotations

import socket
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import networking
from .core import optimizers as opt_lib
from .core.model import Sequential, deserialize_model
from .core.train import TrainState, batch_epoch_data, make_masked_step, \
    model_params
from .device import DeviceLike, host_to_device, resolve_device
from .parallel.spmd import _seed
from .ps_sharding import ShardedPSClient
from .resilience import (DEFAULT_CONNECT_POLICY, RETRYABLE_CONNECT,
                         RetryPolicy, dial)

#: what the workers of this slice leave to ROADMAP queue A item 6
_ITEM_6 = "is not ported yet (ROADMAP queue A item 6)"


#: injectable worker fault kinds (fault_injection): 'raise' = thread raises
#: (the legacy int form), 'exit' = the worker vanishes mid-frame (torn
#: commit + RST, then SystemExit — the wire signature of a worker host
#: dying), 'hang' = the worker wedges (stops renewing its lease) while its
#: PS connection stays open, until released at teardown.  The port's
#: workers take 'raise'; the other two wait for ROADMAP queue A item 6.
FAULT_KINDS = ("raise", "exit", "hang")


def parse_fault_injection(spec: Optional[dict]) -> Dict[int, Tuple[str, int]]:
    """Normalize a ``fault_injection`` spec to ``{worker_id: (kind, budget)}``.

    Accepts the legacy ``{id: n}`` form (= ``('raise', n)``) and the
    ``{id: (kind, n)}`` form; keys may be strings (JSON round-trip) and
    tuples may arrive as lists for the same reason.
    """
    out: Dict[int, Tuple[str, int]] = {}
    for k, v in (spec or {}).items():
        if isinstance(v, (list, tuple)):
            if len(v) != 2:
                raise ValueError(
                    f"fault_injection value for worker {k} must be "
                    f"(kind, budget), got {v!r}")
            kind, budget = str(v[0]), int(v[1])
        else:
            kind, budget = "raise", int(v)
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"fault_injection kind must be one of {FAULT_KINDS}, "
                f"got {kind!r} for worker {k}")
        out[int(k)] = (kind, budget)
    return out


def topk_select(eff: np.ndarray, k: int, code: Optional[str] = None):
    """Host-side top-k-by-magnitude selection with error feedback.

    ``eff`` is the effective flat f32 delta (this window's delta plus the
    carried residual).  Selects the ``k`` largest-magnitude coordinates
    (Aji & Heafield 2017; Lin et al., Deep Gradient Compression), optionally
    codes the values (``"bfloat16"``: rounded to nearest even through
    ``torch.bfloat16``, as ``ml_dtypes`` rounds, and returned as a CPU bf16
    tensor; ``"int8"``: one affine scale per commit, ``max|v|/127`` in f32
    or 1.0 when that is 0, ``np.rint`` clipped to ±127), and returns::

        (indices int32 sorted, wire_values, applied_f32, scale, residual)

    where ``eff == densify(indices, applied_f32) + residual`` exactly — the
    unsent mass AND any value-coding error telescope into the next window
    instead of accumulating in the center (the EF-SGD recipe).  The device
    twin lives in ``PSWorker._build_topk_window_fn``.
    """
    eff = np.ascontiguousarray(eff, np.float32)
    n = eff.size
    k = max(1, min(int(k), n))
    if k >= n:
        idx = np.arange(n, dtype=np.int32)
    else:
        part = np.argpartition(np.abs(eff), n - k)[n - k:]
        idx = np.sort(part).astype(np.int32)
    vals = eff[idx]
    scale = None
    if code == "int8":
        scale = float(np.max(np.abs(vals)) / 127.0) or 1.0
        wire = np.clip(np.rint(vals / scale), -127, 127).astype(np.int8)
        applied = wire.astype(np.float32) * np.float32(scale)
    elif code == "bfloat16":
        wire = torch.from_numpy(vals).to(torch.bfloat16)
        applied = wire.float().numpy()
    else:
        wire = vals.astype(np.float32)
        applied = wire
    residual = eff.copy()
    residual[idx] = vals - applied
    return idx, wire, applied, scale, residual


def _payload_bytes(d) -> int:
    """Bytes a commit leaf puts on the wire as tensor buffers: a dense
    array or CPU tensor, a sparse node's indices and values, a row-sparse
    node's rows and row block."""
    if isinstance(d, networking.SparseDelta):
        return d.indices.nbytes + _payload_bytes(d.values)
    if isinstance(d, networking.RowSparseDelta):
        return d.rows.nbytes + d.values.nbytes
    if isinstance(d, torch.Tensor):
        return d.numel() * d.element_size()
    return np.asarray(d).nbytes


def _wire_dtype(name: Optional[str]):
    """The dense wire coding of ``wire_dtype``: None (f32), ``"int8"``
    (handled apart), ``torch.bfloat16`` for ``"bfloat16"``, else the numpy
    dtype of the name (a bad name raises ``TypeError``, as in the JAX
    module)."""
    if name is None or name == "int8":
        return None
    if name == networking.BF16:
        return torch.bfloat16
    return np.dtype(name)


class Worker:
    """Base worker (reference: ``workers.py :: Worker``): holds the serialized
    model + training config and builds the window program over its own
    copy of the model on ``device`` (``None`` means the CUDA card)."""

    def __init__(self, model_blob: dict, worker_optimizer, loss,
                 features_col: str = "features", label_col: str = "label",
                 batch_size: int = 32, num_epoch: int = 1,
                 learning_rate: Optional[float] = None, seed: int = 0,
                 lr_schedule=None, schedule_steps: Optional[int] = None,
                 gradient_accumulation: int = 1,
                 gradient_clip_norm=None, device: DeviceLike = None):
        self.model_blob = model_blob
        self.worker_optimizer = worker_optimizer
        self.loss = loss
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.learning_rate = learning_rate
        self.lr_schedule = lr_schedule
        self.schedule_steps = schedule_steps
        self.gradient_accumulation = int(gradient_accumulation)
        self.gradient_clip_norm = gradient_clip_norm
        self.seed = seed
        self.device = resolve_device(device)
        self.history: List[float] = []
        # built lazily: this worker's own model and parameters (never
        # shared: the step updates them in place), the update rule
        # (stateless, may be shared) and the window program
        self._model: Optional[Sequential] = None
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._tx: Optional[opt_lib.Transform] = None
        self._window_fn = None

    # -- model/optimizer plumbing -------------------------------------------
    def _ensure_model(self) -> Sequential:
        if self._model is None:
            self._model = deserialize_model(self.model_blob,
                                            device=self.device)
            self._params = model_params(self._model)
            if self._tx is None:
                self._tx = opt_lib.build_tx(
                    self.worker_optimizer, self._params, self.learning_rate,
                    self.lr_schedule, self.schedule_steps,
                    self.gradient_accumulation, self.gradient_clip_norm)
        return self._model

    def _build_window_fn(self):
        """The window program: (params, opt_state, xw, yw, mw, generator)
        -> (params, opt_state, loss) over a (window, batch, ...) stack of
        minibatches on the device.  ``params`` is this worker's own
        parameter dict, trained in place; ``mw`` is the host per-example
        real/padding mask from ``_shard_to_windows``; the returned loss is
        the exact mean over real examples, left on the device."""
        if self._window_fn is not None:
            return self._window_fn
        model = self._ensure_model()
        step = make_masked_step(model, self.loss, self._tx)

        def window(params, opt_state, xw, yw, mw, generator):
            state = TrainState(params, opt_state, 0)
            weighted, wsum = [], 0.0
            for t in range(len(mw)):
                state, value, ws = step(state, xw[t], yw[t], mw[t],
                                        generator)
                weighted.append(value.to(torch.float32) * ws)
                wsum += ws
            loss = torch.stack(weighted).sum() / max(wsum, 1.0)
            return state.params, state.opt_state, loss

        self._window_fn = window
        return window

    def _generator(self, *entropy: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _seed(*entropy))

    def _weights_to_params(self, weights: List[np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
        """Write a host weight list (the JAX leaf order) into this worker's
        parameters, in place (the optimizer state refers to them): one
        host→device copy of the concatenated leaves.  ``weights`` may be
        views into a receive buffer: they are copied before returning."""
        self._ensure_model()
        flat = np.concatenate([np.asarray(w, np.float32).reshape(-1)
                               for w in weights])
        dev = host_to_device(flat, self.device)
        with torch.no_grad():
            off = 0
            for p in self._params.values():
                n = p.numel()
                p.copy_(dev[off:off + n].view(p.shape))
                off += n
        return self._params

    def _fetch(self, loss: Optional[torch.Tensor] = None):
        """(weights, loss): this worker's parameters as f32 numpy arrays in
        the JAX leaf order and the window's loss as a float, in ONE
        device→host copy of the flattened leaves (the loss rides in the
        first element)."""
        weights, loss, _ = self._fetch_leaves(loss)
        return weights, loss

    def _fetch_leaves(self, loss: Optional[torch.Tensor] = None,
                      skip=frozenset(), masks=()):
        """``_fetch`` with leaves left out and masks added: (weights with
        None at the indices in ``skip``, loss, ``masks`` as host bool
        arrays), all in one device→host copy."""
        self._ensure_model()
        leaves = list(self._params.values())
        parts = [] if loss is None else [loss.detach().reshape(1).float()]
        parts += [p.detach().reshape(-1).float()
                  for i, p in enumerate(leaves) if i not in skip]
        parts += [m.reshape(-1).float() for m in masks]
        flat = torch.cat(parts).cpu().numpy()
        off = 0 if loss is None else 1
        out: List[Optional[np.ndarray]] = []
        for i, p in enumerate(leaves):
            if i in skip:
                out.append(None)
                continue
            n = p.numel()
            out.append(flat[off:off + n].reshape(tuple(p.shape)))
            off += n
        host_masks = []
        for m in masks:
            host_masks.append(flat[off:off + m.numel()] != 0.0)
            off += m.numel()
        return out, (None if loss is None else float(flat[0])), host_masks

    def _params_to_weights(self) -> List[np.ndarray]:
        """This worker's parameters as host f32 arrays: one bulk
        device→host copy."""
        return self._fetch()[0]

    def _shard_to_windows(self, shard: Dict[str, np.ndarray], window: int,
                          epoch_seed: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Shape one epoch of this worker's shard into
        (num_windows, window, batch, ...) stacks, shuffled per epoch.

        The tail is wrap-padded to a whole window and masked (same zero-drop
        contract as the SPMD path's ``shape_epoch_data``): returns
        ``(xw, yw, mw)`` where ``mw`` is 1.0 for real rows, 0.0 for padding.
        """
        x = np.asarray(shard[self.features_col])
        y = np.asarray(shard[self.label_col])
        perm = np.random.default_rng(epoch_seed).permutation(len(x))
        return self._stack_windows(x[perm], y[perm], window)

    def _stack_windows(self, x: np.ndarray, y: np.ndarray,
                       window: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Shape already-ordered rows into (num_windows, window, batch, ...)
        stacks with the shared wrap-pad + mask contract (no shuffle)."""
        window = self.window if window is None else int(window)
        # one window = one "batch" of the shared padder, then split it
        xw, yw, mw, nwin = batch_epoch_data(x, y, window * self.batch_size)
        shape = (nwin, window, self.batch_size)
        return (xw.reshape(shape + x.shape[1:]),
                yw.reshape(shape + y.shape[1:]),
                mw.reshape(shape))

    def _to_device(self, xw: np.ndarray, yw: np.ndarray):
        """An epoch's window stacks on the device: one copy each."""
        return (host_to_device(xw, self.device),
                host_to_device(yw, self.device))

    def state_template(self):
        """(params, optimizer state) of the right structure on the device:
        the target a checkpoint restore refills."""
        self._ensure_model()
        return self._params, self._tx.init(list(self._params.values()))

    def _adopt_state(self, state):
        """Continue from ``(params, opt_state)`` (an epoch wave or a
        checkpoint restore): params not already this worker's own are
        written into its model; the optimizer state is used as given (its
        tensors on this worker's device)."""
        params, opt_state = state
        self._ensure_model()
        if params is not self._params:
            weights = [p.detach().cpu().float().numpy()
                       if isinstance(p, torch.Tensor) else np.asarray(p)
                       for p in (params.values() if isinstance(params, dict)
                                 else params)]
            self._weights_to_params(weights)
        return self._params, opt_state


class SequentialWorker(Worker):
    """Plain local training, no PS (reference: ``workers.py ::
    SequentialWorker`` — what SingleTrainer ships to its one partition)."""

    def train(self, index: int, shard: Dict[str, np.ndarray]) -> dict:
        window_fn = self._build_window_fn()
        params = self._params
        opt_state = self._tx.init(list(params.values()))
        generator = self._generator(self.seed + index)
        for epoch in range(self.num_epoch):
            # window==1: every batch is its own step
            xw, yw, mw = self._shard_to_windows(shard, 1, self.seed + epoch)
            xd, yd = self._to_device(xw, yw)
            for i in range(len(xw)):
                params, opt_state, loss = window_fn(
                    params, opt_state, xd[i], yd[i], mw[i], generator)
                self.history.append(float(loss))
        return {"weights": self._params_to_weights(),
                "history": self.history}


class PSWorker(Worker):
    """Base for PS-connected workers (reference: the ``*Worker`` family).

    Protocol (reference parity, §2.4): 1-byte opcodes on a persistent TCP
    connection — ``'p'`` pull → PS replies {weights, clock}; ``'c'`` commit →
    worker sends {delta, worker_id, clock}; ``'u'`` commit+pull; ``'q'``
    quit.
    """

    ALGORITHM = "downpour"

    def __init__(self, model_blob, worker_optimizer, loss, ps_host: str,
                 ps_port: int, communication_window: int = 5,
                 wire_dtype: Optional[str] = None,
                 wire_topk: float = 0.01,
                 wire_topk_dtype: Optional[str] = None,
                 comm_overlap: bool = False,
                 fault_injection: Optional[dict] = None,
                 shard_plan=None, shard_addrs=None,
                 recovery: bool = False,
                 retry_policy: Optional[RetryPolicy] = None,
                 row_sparse_tables=None,
                 partition_windows: int = 0, **kw):
        for knob, is_set in (("recovery=True", bool(recovery)),
                             ("partition_windows", bool(partition_windows))):
            if is_set:
                raise NotImplementedError(f"{knob} {_ITEM_6}")
        super().__init__(model_blob, worker_optimizer, loss, **kw)
        self.ps_host = ps_host
        self.ps_port = ps_port
        # PS sharding (ps_sharding.py): when the trainer partitioned the
        # center over N shard servers, the worker talks to all of them
        # through one ShardedPSClient (scatter commits / gather pulls),
        # built fresh per connect(); None keeps the single socket
        self.shard_plan = shard_plan
        self.shard_addrs = shard_addrs
        self._shard_client: Optional[ShardedPSClient] = None
        self.window = int(communication_window)
        # comm_overlap: pipeline the transport — one combined 'u'
        # (commit+pull) round trip per window, received while the NEXT
        # window's program runs on the device (see _train_epoch_overlapped
        # for the staleness contract)
        self.comm_overlap = bool(comm_overlap)
        #: messages initiated toward the PS (each 'p'/'c'/'u' counts 1, one
        #: per shard when sharded) — the transport-cost observable the
        #: smoke run and tests read
        self.transport_ops = 0
        #: bytes of delta payload committed (the leaves' buffers as the
        #: wire carries them, before any shard split: a sparse commit's
        #: indices and values; int8 scales ride in the frame header)
        self.commit_bytes = 0
        # fault injection: worker id -> (kind, budget); the worker raises
        # at its budget+1-th commit ('raise'); 'exit'/'hang' wait for the
        # elastic engine
        self.fault_injection = parse_fault_injection(fault_injection)
        for kind, _ in self.fault_injection.values():
            if kind != "raise":
                raise NotImplementedError(
                    f"fault_injection kind {kind!r} {_ITEM_6}")
        self._commits = 0
        # "bfloat16": halve commit bytes; "int8": quarter them with
        # per-tensor affine quantization + error feedback (see commit()).
        # "topk": ship only the wire_topk·n largest-magnitude coordinates of
        # the flat delta as a sparse (indices, values) commit with error
        # feedback; values optionally bf16/int8-coded on top
        # (wire_topk_dtype).  Resolved eagerly so a bad name fails at
        # construction, not mid-training in a worker thread.
        self._topk_density: Optional[float] = None
        if wire_dtype == "topk":
            density = float(wire_topk)
            if not 0.0 < density <= 1.0:
                raise ValueError(
                    f"wire_topk must be a density in (0, 1], got {density}")
            if wire_topk_dtype not in (None, "bfloat16", "int8"):
                raise ValueError(
                    "wire_topk_dtype must be None, 'bfloat16' or 'int8', "
                    f"got {wire_topk_dtype!r}")
            self._topk_density = density
            wire_dtype = None
        self.wire_topk_dtype = wire_topk_dtype
        self._quantize = wire_dtype == "int8"
        self.wire_dtype = _wire_dtype(wire_dtype)
        # row-sparse embedding commits (row_sparse= on the async trainers;
        # streaming.py resolves the knob to weight-list indices): each
        # listed table's window delta ships as an EXACT
        # networking.RowSparseDelta (touched rows only, detected on the
        # device from the delta itself, so exact for any optimizer) beside
        # dense deltas for the rest of the model in one 'u' round trip.
        # Delta family only, no lossy coding, serial loop only.
        self.row_sparse_tables: Tuple[int, ...] = ()
        self._rs_shapes: Dict[int, tuple] = {}
        self._rs_window_fn = None
        if row_sparse_tables:
            tables = sorted({int(t) for t in row_sparse_tables})
            if not self._ROW_SPARSE_OK:
                raise ValueError(
                    "row_sparse_tables applies to the delta family "
                    "(DOWNPOUR/ADAG/DynSGD); the elastic family's force "
                    f"term is dense by construction ({type(self).__name__})")
            if (self._topk_density is not None or self._quantize
                    or self.wire_dtype is not None):
                raise ValueError(
                    "row_sparse_tables is the exact sparse profile and does "
                    "not compose with lossy wire_dtype codings "
                    "(bfloat16/int8/topk) — use wire_dtype=None")
            if self.comm_overlap:
                raise ValueError(
                    "row_sparse_tables uses the serial 1-RTT 'u' window "
                    "loop; comm_overlap must be off")
            shapes = [tuple(np.shape(w)) for w in self.model_blob["weights"]]
            for t in tables:
                if not 0 <= t < len(shapes):
                    raise ValueError(
                        f"row_sparse_tables names weight {t}; model has "
                        f"{len(shapes)} weights")
                if len(shapes[t]) < 2:
                    raise ValueError(
                        f"row_sparse_tables weight {t} is {shapes[t]} — row "
                        "sparsity needs a (rows, dim...) table")
            self.row_sparse_tables = tuple(tables)
            self._rs_shapes = {t: shapes[t] for t in tables}
        self._residual: Optional[List[np.ndarray]] = None
        # top-k error-feedback state: exactly one of the two residuals is
        # live per worker — the DEVICE flat residual (delta family: the
        # selection runs on the device, only k values + indices are
        # fetched) or the HOST flat residual (elastic family / direct
        # commit() calls)
        self._residual_dev: Optional[torch.Tensor] = None
        self._residual_flat: Optional[np.ndarray] = None
        self._topk_window_fn = None
        self._wire_k: Optional[int] = None
        self._wire_total: Optional[int] = None
        self._wire_shapes: Optional[List[tuple]] = None
        #: (indices, applied f32 values) of the last in-flight 'u' commit —
        #: re-credited into the residual if a respawned PS gen-rejects it
        self._inflight = None
        #: sparse commits whose gen-rejection re-credited the residual
        self.recredits = 0
        self._sock: Optional[socket.socket] = None
        self._pool: Optional[networking.BufferPool] = None
        self._send_pool: Optional[networking.BufferPool] = None
        self._last_clock = 0
        self.retry_policy = retry_policy
        self._gen: Optional[int] = None

    # -- wire ---------------------------------------------------------------
    def _connect_policy(self, attempts: Optional[int] = None,
                        backoff: Optional[float] = None,
                        policy: Optional[RetryPolicy] = None) -> RetryPolicy:
        if policy is None:
            policy = self.retry_policy or DEFAULT_CONNECT_POLICY
        kw = {}
        if attempts is not None:
            kw["attempts"] = max(int(attempts), 1)
        if backoff is not None:
            kw["backoff"] = float(backoff)
        return policy.replace(**kw) if kw else policy

    def connect(self, attempts: Optional[int] = None,
                backoff: Optional[float] = None,
                policy: Optional[RetryPolicy] = None):
        """Dial the PS with bounded *jittered* retry-with-backoff
        (resilience.RetryPolicy): a worker that starts before the PS accept
        loop is up retries with exponential backoff (~9 s worst case at the
        defaults) instead of dying on the first handshake fault.  Retried
        faults: ``ConnectionRefusedError`` (nothing listening yet), plus
        ``ConnectionResetError`` and ``socket.timeout``.  Every fresh
        connection gets a fresh receive-buffer pool: center pulls decode
        into reusable preallocated memory.

        With ``shard_addrs`` set the worker instead dials every PS shard
        through a ``ShardedPSClient`` (same retry policy per shard; one
        socket + one buffer pool per shard)."""
        if self.shard_addrs is not None:
            self._shard_client = ShardedPSClient(
                self.shard_plan, self.shard_addrs, policy=self.retry_policy)
            self._shard_client.connect(attempts=attempts, backoff=backoff,
                                       policy=policy)
            return
        pol = self._connect_policy(attempts, backoff, policy)
        try:
            self._sock = dial(self.ps_host, self.ps_port, pol)
        except RETRYABLE_CONNECT as e:
            raise ConnectionError(
                f"PS at {self.ps_host}:{self.ps_port} refused "
                f"{pol.describe()} connection attempts") from e
        self._pool = networking.BufferPool()
        self._send_pool = networking.BufferPool()

    def _sync_reply(self, msg):
        """Fold a reply's (gen, clock) into this worker's view: generation
        follows the server (commits carry it, as the JAX workers'
        do); the clock stays monotonic."""
        g = msg.get("gen")
        if g is not None:
            self._gen = int(g)
        self._last_clock = max(self._last_clock, int(msg["clock"]))

    def disconnect(self):
        if self._shard_client is not None:
            self._shard_client.disconnect()
            return
        if self._sock is not None:
            try:
                networking.send_opcode(self._sock, b"q")
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def pull(self) -> List[np.ndarray]:
        """'p': fetch center weights + PS clock (reference: Worker.pull).

        The reply decodes through the connection's buffer pool: the returned
        weights are zero-copy VIEWS into reusable memory, valid until the
        next receive on this connection — callers move them to the device
        (or consume them arithmetically) before their next transport call.

        Sharded: one 'p' per shard (every request in flight before any reply
        is read), replies gathered into the full weight list.
        """
        if self._shard_client is not None:
            weights = self._shard_client.pull()
            self._last_clock = self._shard_client.max_clock
            self.transport_ops += self._shard_client.num_shards
            return weights
        networking.send_opcode(self._sock, b"p")
        msg = networking.recv_data(self._sock, pool=self._pool)
        self._sync_reply(msg)
        self.transport_ops += 1
        return msg["weights"]

    # -- sparse top-k compression (wire_dtype="topk") ------------------------
    #: delta-family workers select the top-k ON THE DEVICE (delta = after −
    #: base inside the window program); the elastic family computes its
    #: force term on the host and selects there
    _DEVICE_TOPK = False
    #: error feedback fits ACCUMULATIVE commits (window deltas: unsent mass
    #: stays valid to add later).  The elastic family's force e = α·(x − x̃)
    #: is recomputed from current state every window — its unsent components
    #: are still present in the next force, so a residual would double-count
    #: them; the elastic workers sparsify WITHOUT a residual instead.
    _TOPK_EF = True
    #: row-sparse embedding commits need the window delta itself to be the
    #: committed quantity (delta family); the elastic force is dense
    _ROW_SPARSE_OK = False

    # -- row-sparse embedding commits (row_sparse_tables) --------------------
    def _build_rowsparse_window_fn(self):
        """Row-sparse variant of the window program: each listed table's
        f32 base is cloned on the device BEFORE the window trains the
        parameters in place, then its window delta (``after.float() −
        base``) and touched-row mask (``delta != 0`` reduced over the
        non-leading axes) are computed on the device.  Support detection
        from the delta itself makes the profile EXACT for any optimizer,
        and only the masks plus the touched rows' O(k·dim) block ever
        reach the host.

        (params, opt_state, xw, yw, mw, generator) -> (params, opt_state,
        loss, [table deltas], [row masks]), the parameters trained in
        place as by the plain window program."""
        if self._rs_window_fn is not None:
            return self._rs_window_fn
        tables = self.row_sparse_tables
        window = self._build_window_fn()

        def rs_window(params, opt_state, xw, yw, mw, generator):
            leaves = list(params.values())
            bases = [leaves[t].detach().to(torch.float32, copy=True)
                     for t in tables]
            params, opt_state, loss = window(params, opt_state, xw, yw, mw,
                                             generator)
            leaves = list(params.values())
            with torch.no_grad():
                deltas = [leaves[t].detach().float() - b
                          for t, b in zip(tables, bases)]
                masks = [(d != 0.0).reshape(d.shape[0], -1).any(dim=1)
                         for d in deltas]
            return params, opt_state, loss, deltas, masks

        self._rs_window_fn = rs_window
        return rs_window

    def _fetch_dense_weights(self, loss: Optional[torch.Tensor] = None,
                             masks=()):
        """ONE device→host copy of every NON-table leaf: a list in weight
        order with None at table positions — the big embedding tables never
        ride the per-window fetch.  After a window the same copy carries
        its loss and the tables' row masks.  Returns (weights, loss, masks
        as host bool arrays)."""
        return self._fetch_leaves(loss, frozenset(self.row_sparse_tables),
                                  masks)

    def _rowsparse_window_step(self, params, opt_state, xw, yw, mw,
                               generator, index: int):
        """One serial window under row-sparse commits: dense non-table
        deltas + exact row-sparse table deltas, committed in ONE combined
        'u' round trip whose reply (the fresh center) re-bases the next
        window — the serial loop's commit + re-pull, atomically."""
        fn = self._build_rowsparse_window_fn()
        before, _, _ = self._fetch_dense_weights()
        params, opt_state, loss, rs_deltas, rs_masks = fn(
            params, opt_state, xw, yw, mw, generator)
        # one copy for the dense after-weights, the loss and the per-table
        # row masks; the touched rows' values follow as one O(k·dim)
        # gather per table
        after, loss, masks = self._fetch_dense_weights(loss, rs_masks)
        delta: List[Any] = []
        ti = 0
        for i, a in enumerate(after):
            if i not in self._rs_shapes:
                delta.append(a - before[i])
                continue
            rows = np.flatnonzero(masks[ti]).astype(np.int32)
            if rows.size:
                dev_rows = host_to_device(rows.astype(np.int64), self.device)
                vals = rs_deltas[ti].index_select(0, dev_rows).cpu().numpy()
            else:
                vals = np.zeros((0,) + self._rs_shapes[i][1:], np.float32)
            delta.append(networking.RowSparseDelta(
                rows, vals, self._rs_shapes[i][0]))
            ti += 1
        _applied, center = self.update(delta, index)
        return self._weights_to_params(center), opt_state, loss

    def _ensure_topk(self) -> int:
        """Resolve k and the flat layout (density · total elements, at
        least 1); indices ride as int32 on the wire.  The layout comes from
        the model blob's weight list — the wire order every pull/commit
        already uses."""
        if self._wire_k is None:
            self._wire_shapes = [tuple(np.shape(w))
                                 for w in self.model_blob["weights"]]
            total = sum(int(np.prod(s, dtype=np.int64))
                        for s in self._wire_shapes)
            if total >= 2 ** 31:
                raise ValueError(
                    "wire_dtype='topk' indexes the flat weight vector with "
                    f"int32; {total} elements overflow it")
            self._wire_total = total
            self._wire_k = max(1, min(total, int(np.ceil(
                self._topk_density * total))))
        return self._wire_k

    def _build_topk_window_fn(self):
        """The top-k variant of the window program.  The flat f32 ``base``
        is taken BEFORE the window trains the parameters in place; after
        it, ``eff = flat(after) − base + residual`` forms in the persistent
        device residual, ``torch.topk(|eff|, k)`` selects (indices then
        sorted ascending), the values are gathered and coded (bf16 cast or
        int8 with one scale) and ``applied`` is subtracted from the
        selected coordinates of the residual, in place — the residual keeps
        the unsent mass and the coding error (EF-SGD).

        (params, opt_state, residual, xw, yw, mw, generator) -> (params,
        opt_state, packed): ``packed`` is one uint8 device tensor holding
        the loss, the scale, the k int32 indices and the k codes, so the
        host fetches them in ONE copy (``_fetch_sparse``) and never the
        full delta."""
        if self._topk_window_fn is not None:
            return self._topk_window_fn
        k = self._ensure_topk()
        code = self.wire_topk_dtype
        window = self._build_window_fn()

        def flatten(params):
            return torch.cat([p.detach().reshape(-1).float()
                              for p in params.values()])

        def topk_window(params, opt_state, residual, xw, yw, mw, generator):
            base = flatten(params)
            params, opt_state, loss = window(params, opt_state, xw, yw, mw,
                                             generator)
            with torch.no_grad():
                residual.add_(flatten(params) - base)  # residual := eff
                _, ai = torch.topk(residual.abs(), k, sorted=False)
                ai = torch.sort(ai).values  # ascending: bisection friendly
                vals = residual[ai]
                scale = torch.ones((), dtype=torch.float32,
                                   device=residual.device)
                if code == "int8":
                    # a tensor divisor: a CUDA division by a Python scalar
                    # multiplies by its rounded reciprocal
                    peak = vals.abs().max()
                    scale = peak / torch.full_like(peak, 127.0)
                    scale = torch.where(scale <= 0, torch.ones_like(scale),
                                        scale)
                    codes = torch.clamp(torch.round(vals / scale),
                                        -127, 127).to(torch.int8)
                    applied = codes.float() * scale
                elif code == "bfloat16":
                    codes = vals.to(torch.bfloat16)
                    applied = codes.float()
                else:
                    codes = applied = vals
                residual.index_put_((ai,), vals - applied)
                packed = torch.cat([
                    t.reshape(-1).contiguous().view(torch.uint8)
                    for t in (loss.detach().float(), scale,
                              ai.to(torch.int32), codes)])
            return params, opt_state, packed

        self._topk_window_fn = topk_window
        return topk_window

    def _run_topk_window(self, params, opt_state, xw, yw, mw, generator):
        """Queue one top-k window on the device; returns (params,
        opt_state, packed) — the host reads ``packed`` with
        ``_fetch_sparse`` when it needs it, which lets the overlapped loop
        receive the previous reply first."""
        fn = self._build_topk_window_fn()
        if self._residual_dev is None:
            self._residual_dev = torch.zeros(
                (self._wire_total,), dtype=torch.float32, device=self.device)
        return fn(params, opt_state, self._residual_dev, xw, yw, mw,
                  generator)

    def _fetch_sparse(self, packed: torch.Tensor):
        """(SparseDelta, loss): a device selection as the wire node, from
        ONE device→host copy of (loss, scale, k indices, k codes)."""
        raw = packed.cpu().numpy()
        k = self._wire_k
        loss = float(raw[0:4].view(np.float32)[0])
        scale = float(raw[4:8].view(np.float32)[0])
        idx = raw[8:8 + 4 * k].view(np.int32)
        body = raw[8 + 4 * k:]
        if self.wire_topk_dtype == "bfloat16":
            codes = torch.from_numpy(body.view(np.int16)).view(torch.bfloat16)
        elif self.wire_topk_dtype == "int8":
            codes = body.view(np.int8)
        else:
            codes = body.view(np.float32)
        return networking.SparseDelta(
            idx, codes, self._wire_total,
            scale if self.wire_topk_dtype == "int8" else None), loss

    def _densify(self, idx, vals) -> List[np.ndarray]:
        """Sparse (idx, f32 values) → weight-shaped dense list (the
        as-applied delta ``commit`` returns, keeping elastic coupling and
        the overlap rebase exact)."""
        flat = np.zeros((self._wire_total,), np.float32)
        flat[np.asarray(idx, np.int64)] = vals
        out, off = [], 0
        for s in self._wire_shapes:
            n = int(np.prod(s, dtype=np.int64))
            out.append(flat[off:off + n].reshape(s))
            off += n
        return out

    def _recredit(self, idx: np.ndarray, vals: np.ndarray):
        """Return dropped as-applied sparse mass to the error-feedback
        residual: a respawned PS gen-rejected the commit, so the mass never
        reached the center and must ship again."""
        if not self._TOPK_EF:
            return  # elastic family: the recomputed spring force re-applies
        if self._residual_dev is not None:
            self._residual_dev.index_add_(
                0, host_to_device(np.asarray(idx, np.int64), self.device),
                host_to_device(np.asarray(vals, np.float32), self.device))
        else:
            if self._residual_flat is None:
                self._residual_flat = np.zeros((self._wire_total,),
                                               np.float32)
            np.add.at(self._residual_flat, np.asarray(idx, np.int64),
                      np.asarray(vals, np.float32))
        self.recredits += 1

    def _prepare_topk_commit(self, delta, worker_id: int):
        """Top-k wire form of a commit: either a device-selected
        ``SparseDelta`` (delta family) or a host-side ``topk_select`` over
        the dense delta + flat residual (elastic family, direct callers)."""
        k = self._ensure_topk()
        if isinstance(delta, networking.SparseDelta):
            sp = delta
            idx = np.asarray(sp.indices)
            applied_vals = sp.f32_values()
        else:
            flat = np.concatenate(
                [np.asarray(d, np.float32).reshape(-1) for d in delta])
            if flat.size != self._wire_total:
                raise ValueError(
                    f"delta carries {flat.size} elements, model has "
                    f"{self._wire_total}")
            if self._TOPK_EF:
                if self._residual_flat is None:
                    self._residual_flat = np.zeros((self._wire_total,),
                                                   np.float32)
                eff = flat + self._residual_flat
                idx, wire, applied_vals, scale, self._residual_flat = \
                    topk_select(eff, k, self.wire_topk_dtype)
            else:
                idx, wire, applied_vals, scale, _ = topk_select(
                    flat, k, self.wire_topk_dtype)
            sp = networking.SparseDelta(idx, wire, self._wire_total, scale)
        msg = {"delta": sp, "worker_id": worker_id,
               "clock": self._last_clock}
        if self._gen is not None:
            msg["gen"] = self._gen
        self._inflight = (np.array(idx, np.int64, copy=True),
                          np.array(applied_vals, np.float32, copy=True))
        self.commit_bytes += _payload_bytes(sp)
        return msg, self._densify(idx, applied_vals)

    def _inject_fault(self, worker_id: int):
        """The 'raise' fault: hard-close first (every shard socket when
        sharded) so the unwind path's disconnect() is a no-op (no graceful
        b'q'): the PS sees a plain EOF."""
        networking._hard_close(self._sock)
        self._sock = None
        if self._shard_client is not None:
            self._shard_client.abort()
        raise RuntimeError(
            f"injected fault: worker {worker_id} dies at commit "
            f"{self._commits}")

    def _prepare_commit(self, delta: List[np.ndarray], worker_id: int):
        """Fault-injection gate + wire compression shared by 'c' and 'u'.
        Returns ``(msg, applied)``: the wire message and the delta the PS
        will actually apply after decompression (see ``commit``)."""
        self._commits += 1
        fault = self.fault_injection.get(worker_id)
        if fault is not None and self._commits > fault[1]:
            self._inject_fault(worker_id)
        if self._topk_density is not None:
            return self._prepare_topk_commit(delta, worker_id)
        if self._quantize:
            if self._residual is None:
                self._residual = [np.zeros_like(d, dtype=np.float32)
                                  for d in delta]
            eff = [d.astype(np.float32) + r
                   for d, r in zip(delta, self._residual)]
            scales = [float(np.max(np.abs(e)) / 127.0) or 1.0 for e in eff]
            codes = [np.clip(np.rint(e / s), -127, 127).astype(np.int8)
                     for e, s in zip(eff, scales)]
            applied = [c.astype(np.float32) * s
                       for c, s in zip(codes, scales)]
            self._residual = [e - a for e, a in zip(eff, applied)]
            msg = {"delta": codes, "scales": scales,
                   "worker_id": worker_id, "clock": self._last_clock}
            if self._gen is not None:
                msg["gen"] = self._gen
            self.commit_bytes += sum(c.nbytes for c in codes)
            return (msg, applied)
        if self.wire_dtype is torch.bfloat16:
            # round to nearest even through torch (what ml_dtypes does);
            # the frame carries CPU bf16 tensors under the JAX wire name
            delta = [torch.from_numpy(np.array(d, np.float32))
                     .to(torch.bfloat16) for d in delta]
            applied = [d.float().numpy() for d in delta]
        else:
            if self.wire_dtype is not None:
                delta = [d.astype(self.wire_dtype) for d in delta]
            # row-sparse entries ARE their as-applied form (the profile is
            # exact); dense entries normalize to f32
            applied = [d if isinstance(d, networking.RowSparseDelta)
                       else np.asarray(d, dtype=np.float32) for d in delta]
        msg = {"delta": delta, "worker_id": worker_id,
               "clock": self._last_clock}
        if self._gen is not None:
            # generation handshake: a PS respawned since our last reply
            # rejects this commit instead of applying it to the restored
            # center
            msg["gen"] = self._gen
        self.commit_bytes += sum(_payload_bytes(d) for d in delta)
        return (msg, applied)

    def commit(self, delta: List[np.ndarray], worker_id: int):
        """'c': push a weight-shaped delta (reference: Worker.commit).

        Returns the delta the PS will actually APPLY (after any wire
        compression) so callers whose local state must stay coupled to the
        center — the elastic family subtracts what it committed — can use
        the as-applied value instead of the pre-compression one.

        ``wire_dtype="bfloat16"``: the delta is rounded to bf16 on the wire
        (half the bytes; the PS upcasts before applying).

        ``wire_dtype="int8"``: per-tensor affine quantization — each tensor
        ships as int8 codes + one f32 scale (max|d|/127), a 4x byte cut —
        with ERROR FEEDBACK: the quantization error of every window is
        carried into the next window's delta, so compression noise
        telescopes instead of accumulating in the center (the 1-bit-SGD /
        EF-SGD recipe).

        ``wire_dtype="topk"``: only the ``wire_topk``-density
        largest-magnitude coordinates of the flat delta ship
        (``networking.SparseDelta``: int32 indices + values, optionally
        bf16/int8-coded via ``wire_topk_dtype``), an O(k) commit on the
        wire and at the PS apply, with error feedback (delta family; the
        elastic force selects without a residual).  ``delta`` may also be
        an already-selected ``SparseDelta`` (the device path).
        """
        msg, applied = self._prepare_commit(delta, worker_id)
        if self._shard_client is not None:
            self._shard_client.send_commit(msg)
            self.transport_ops += self._shard_client.num_shards
            return applied
        self._send_request(b"c", msg)
        self.transport_ops += 1
        return applied

    def _send_request(self, op: bytes, msg) -> None:
        """Opcode + frame on the socket; the commit re-serializes into the
        connection's reusable send buffer (same wire bytes)."""
        networking.send_opcode(self._sock, op)
        networking.send_data(self._sock, msg, pool=self._send_pool)

    def update_begin(self, delta: List[np.ndarray], worker_id: int):
        """'u' part 1: ship the delta (same fault-injection + compression
        contract as ``commit``; returns the as-applied delta).  The PS's
        combined reply — the center *after this commit* + clock, snapshotted
        atomically — is collected by ``update_finish``; overlapped callers
        run device work between the two halves so the round trip costs no
        device idle time.  Sharded: one 'u' per shard, every shard's reply
        left in flight."""
        msg, applied = self._prepare_commit(delta, worker_id)
        if self._shard_client is not None:
            self._shard_client.send_update(msg)
            self.transport_ops += self._shard_client.num_shards
            return applied
        self._send_request(b"u", msg)
        self.transport_ops += 1
        return applied

    def update_finish(self) -> List[np.ndarray]:
        """'u' part 2: receive the center+clock reply for the
        ``update_begin`` in flight (pool-decoded views, as ``pull``;
        sharded: drain every shard's reply and gather).  A reply marked
        ``stale`` means a respawned server gen-rejected the in-flight
        sparse commit: its as-applied mass goes back into the
        error-feedback residual (per shard when sharded)."""
        if self._shard_client is not None:
            weights = self._shard_client.recv_update()
            self._last_clock = max(self._last_clock,
                                   self._shard_client.max_clock)
            if self._inflight is not None and any(
                    self._shard_client.last_stale):
                idx, vals = self._inflight
                owner = self.shard_plan.shard_of_flat(idx)
                mask = np.asarray(self._shard_client.last_stale,
                                  bool)[owner]
                if mask.any():
                    self._recredit(idx[mask], vals[mask])
            self._inflight = None
            return weights
        msg = networking.recv_data(self._sock, pool=self._pool)
        self._sync_reply(msg)
        if msg.get("stale") and self._inflight is not None:
            self._recredit(*self._inflight)
        self._inflight = None
        return msg["weights"]

    def update(self, delta: List[np.ndarray], worker_id: int):
        """Blocking combined commit+pull: ONE round trip where the serial
        'c'+'p' pair pays a send plus a full round trip.  Returns
        ``(applied_delta, center_weights)``."""
        applied = self.update_begin(delta, worker_id)
        return applied, self.update_finish()

    # -- the training loop ---------------------------------------------------
    def train(self, index: int, shard: Dict[str, np.ndarray],
              initial_state=None, epoch_range=None) -> dict:
        """Run the PS-connected minibatch loop.

        ``initial_state``: optional ``(params, opt_state)`` to continue from
        (checkpoint resume / epoch-wave execution); default is the reference
        behavior — pull the center and start a fresh optimizer.
        ``epoch_range``: optional ``(start, stop)`` slice of the epoch loop
        so the driver can checkpoint between epoch waves.  The per-epoch
        shuffle and generator derive from the epoch index, so a resumed run
        sees the same randomness as an uninterrupted one.
        """
        window_fn = self._build_window_fn()
        self.connect()
        try:
            if initial_state is None:
                center = self.pull()
                params = self._weights_to_params(center)
                opt_state = self._tx.init(list(params.values()))
            else:
                params, opt_state = self._adopt_state(initial_state)
                # sync the PS clock (DynSGD staleness baseline); the weights
                # double as the overlap loop's initial center snapshot
                center = self.pull()
            start, stop = (epoch_range if epoch_range is not None
                           else (0, self.num_epoch))
            for epoch in range(start, stop):
                xw, yw, mw = self._shard_to_windows(
                    shard, self.window, self.seed + 1000 * epoch + index)
                xd, yd = self._to_device(xw, yw)
                generator = self._generator(self.seed + 100 + index, epoch)
                if self.comm_overlap:
                    params, opt_state, center = self._train_epoch_overlapped(
                        window_fn, params, opt_state, xd, yd, mw, generator,
                        index, center)
                else:
                    for i in range(len(mw)):
                        params, opt_state, loss = self._window_step(
                            window_fn, params, opt_state, xd[i], yd[i],
                            mw[i], generator, index)
                        self.history.append(loss)
        finally:
            self.disconnect()
        return {"history": self.history, "state": (params, opt_state)}

    def _window_step(self, window_fn, params, opt_state, xw, yw, mw,
                     generator, index: int):
        """One serial window: (params, opt_state, loss as a float)."""
        raise NotImplementedError

    def compile_windows(self, x_sample, y_sample) -> float:
        raise NotImplementedError(f"the elastic lease loop {_ITEM_6}")

    def train_leases(self, worker_id: int, ledger, data_fn,
                     initial_state=None) -> dict:
        raise NotImplementedError(f"the elastic lease loop {_ITEM_6}")

    # -- overlapped (pipelined) window loop -----------------------------------
    def _train_epoch_overlapped(self, window_fn, params, opt_state, xw, yw,
                                mw, generator, index: int, center):
        """Double-buffered window loop: ONE combined 'u' round trip per
        window, received while the NEXT window's program runs.

        Per window the loop (1) issues the window program (its kernels
        queue on the device and run while the host goes on), (2) blocks on
        the *previous* window's 'u' reply — the round trip rides the wire
        while the device works, (3) fetches this window's weights (or, for
        the delta family under top-k, only its device selection), ships the
        delta with ``update_begin``, and rebases the next window's input
        via the per-algorithm ``_overlap_next`` hook.

        Staleness contract: each window trains against a center that is one
        window stale — exactly the tolerance the DOWNPOUR family is built
        on (Dean et al., NIPS 2012), and DynSGD's clock field keeps pricing
        that staleness into the PS-side scale.  The elastic family couples
        through the as-applied delta (``applied``), so x and x̃ still move
        by the same elastic term.
        """
        # wire_dtype="topk" on the delta family: the selection runs on the
        # device inside the window program — only k values + indices are
        # fetched a window, never the full delta (the elastic family
        # computes its force term on the host and selects there)
        device_topk = self._topk_density is not None and self._DEVICE_TOPK
        base = self._params_to_weights()
        pending = False
        for i in range(len(mw)):
            if device_topk:
                params, opt_state, packed = self._run_topk_window(
                    params, opt_state, xw[i], yw[i], mw[i], generator)
            else:
                params, opt_state, loss = window_fn(
                    params, opt_state, xw[i], yw[i], mw[i], generator)
            if pending:
                # the previous window's reply arrives while this window
                # computes — the transport hides behind the device
                center = self.update_finish()
                pending = False
            if device_topk:
                after = None  # the delta-family hooks never touch it
                delta, loss = self._fetch_sparse(packed)  # waits; O(k)
            else:
                after, loss = self._fetch(loss)  # waits for the window
                delta = self._overlap_delta(base, after, center)
            applied = self.update_begin(delta, index)
            pending = True
            base = self._overlap_next(base, after, applied, center)
            params = self._weights_to_params(base)
            self.history.append(loss)
        if pending:
            # drain the last reply so the epoch (and any checkpoint wave
            # joined after it) observes a center that includes every commit
            center = self.update_finish()
            params = self._weights_to_params(self._overlap_drain(base, center))
        return params, opt_state, center

    # DOWNPOUR-family overlap hooks (ADAG/DynSGD inherit; the elastic
    # family overrides below)
    def _overlap_delta(self, base, after, center):
        """Delta to ship for a window whose input weights were ``base`` and
        output weights ``after``; ``center`` is the last-received center."""
        return [a - b for a, b in zip(after, base)]

    def _overlap_next(self, base, after, applied, center):
        """Weights the next window trains from: the one-window-stale center
        plus this window's as-applied delta (the run-ahead analogue of the
        serial loop's post-commit re-pull)."""
        return [np.asarray(c, np.float32) + a
                for c, a in zip(center, applied)]

    def _overlap_drain(self, base, center):
        """Weights to finish the epoch on once the last reply landed (the
        serial loop ends every window on a fresh pull)."""
        return center


class DOWNPOURWorker(PSWorker):
    """DistBelief async SGD (reference: ``workers.py :: DOWNPOURWorker``):
    commit the raw accumulated window delta, then re-pull the center."""
    ALGORITHM = "downpour"
    _DEVICE_TOPK = True  # delta = after − base: selectable on the device
    _ROW_SPARSE_OK = True  # the committed quantity IS the window delta

    def _window_step(self, window_fn, params, opt_state, xw, yw, mw,
                     generator, index):
        if self.row_sparse_tables:
            # row-sparse embedding commit: one combined 'u' round trip,
            # table deltas shipped as exact touched-row blocks
            return self._rowsparse_window_step(params, opt_state, xw, yw,
                                               mw, generator, index)
        if self._topk_density is not None:
            # device selection: the full delta never reaches the host
            params, opt_state, packed = self._run_topk_window(
                params, opt_state, xw, yw, mw, generator)
            sparse, loss = self._fetch_sparse(packed)
            self.commit(sparse, index)
            return self._weights_to_params(self.pull()), opt_state, loss
        before = self._params_to_weights()
        params, opt_state, loss = window_fn(params, opt_state, xw, yw, mw,
                                            generator)
        after, loss = self._fetch(loss)
        delta = [a - b for a, b in zip(after, before)]
        self.commit(delta, index)
        params = self._weights_to_params(self.pull())
        return params, opt_state, loss


class ADAGWorker(DOWNPOURWorker):
    """ADAG (reference: ``workers.py :: ADAGWorker``): same commit shape as
    DOWNPOUR; the normalization lives on the PS side
    (``ADAGParameterServer`` divides by the concurrent-commit count),
    matching ``rules.adag_commit``."""
    ALGORITHM = "adag"


class DynSGDWorker(DOWNPOURWorker):
    """DynSGD (reference: ``workers.py :: DynSGDWorker``): identical loop; the
    commit's ``clock`` field (last-seen PS update count, set by ``pull``) is
    what ``DynSGDParameterServer`` uses to compute staleness."""
    ALGORITHM = "dynsgd"


class AEASGDWorker(PSWorker):
    """Elastic averaging (reference: ``workers.py :: AEASGDWorker``): keeps a
    *persistent* local model; every window computes the elastic force
    e = α·(x − x̃) against a freshly pulled center, subtracts it locally, and
    commits it (PS does x̃ += e). α = rho · learning_rate."""
    ALGORITHM = "aeasgd"
    _TOPK_EF = False  # the spring force is stateful, not accumulative

    def __init__(self, *args, rho: float = 5.0, **kw):
        super().__init__(*args, **kw)
        self.rho = float(rho)
        lr = self.learning_rate if self.learning_rate is not None else 0.1
        self.alpha = self.rho * lr

    def _window_step(self, window_fn, params, opt_state, xw, yw, mw,
                     generator, index):
        params, opt_state, loss = window_fn(params, opt_state, xw, yw, mw,
                                            generator)
        center = self.pull()
        local, loss = self._fetch(loss)
        elastic = [self.alpha * (l - c) for l, c in zip(local, center)]
        # subtract what the PS will actually APPLY (post-wire-compression,
        # a top-k commit densified): x and x-tilde must move by the same e
        # or the elastic coupling drifts under lossy wire dtypes
        applied = self.commit(elastic, index)
        local = [l - e for l, e in zip(local, applied)]
        return self._weights_to_params(local), opt_state, loss

    # overlap hooks: the elastic force is computed against the last-received
    # center (one window stale under comm_overlap — EASGD's coupling is
    # explicitly tolerant of the communication period); x keeps moving by
    # exactly the as-applied e, so x and x̃ stay coupled under lossy wire
    # dtypes, same as the serial path
    def _overlap_delta(self, base, after, center):
        return [self.alpha * (a - c) for a, c in zip(after, center)]

    def _overlap_next(self, base, after, applied, center):
        return [a - e for a, e in zip(after, applied)]

    def _overlap_drain(self, base, center):
        return base  # the elastic worker keeps its persistent local model


class EAMSGDWorker(AEASGDWorker):
    """EAMSGD (reference: ``workers.py :: EAMSGDWorker``): AEASGD whose local
    optimizer carries Nesterov momentum — the momentum state lives in the
    worker optimizer passed in by the ``EAMSGD`` trainer, so the exchange
    logic is identical."""
    ALGORITHM = "eamsgd"


def share_compiled_state(workers: List["Worker"]) -> None:
    """Build every worker's model and share what is read-only.

    The JAX package gives every worker one model, one params template,
    one optax transform and one jitted window function each for the plain,
    top-k and row-sparse windows: its params are immutable pytrees, so
    sharing is free.  The port's step trains the module's own parameters
    IN PLACE, so a shared module would have two worker threads training
    one set of weights.  Here each worker builds its own ``Sequential``
    (parameters, BatchNorm statistics) and keeps its own optimizer state,
    generator and top-k residual, and its window programs close over its
    own model; what is shared is the update rule — a stateless
    ``Transform`` of pure functions — and the top-k layout (k, the flat
    length, the leaf shapes).
    """
    if not workers:
        return
    head = workers[0]
    head._ensure_model()
    share_topk = getattr(head, "_topk_density", None) is not None
    if share_topk:
        head._ensure_topk()
    for w in workers[1:]:
        w._tx = head._tx
        w._ensure_model()
        if share_topk:
            w._wire_k = head._wire_k
            w._wire_total = head._wire_total
            w._wire_shapes = head._wire_shapes


WORKER_CLASSES = {
    "downpour": DOWNPOURWorker,
    "adag": ADAGWorker,
    "dynsgd": DynSGDWorker,
    "aeasgd": AEASGDWorker,
    "eamsgd": EAMSGDWorker,
}
