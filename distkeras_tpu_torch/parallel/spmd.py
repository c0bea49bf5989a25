"""The SPMD execution engine of the distributed trainers, port of
``distkeras_tpu/parallel/spmd.py``.

The JAX engine runs every algorithm as one bulk-synchronous program over a
mesh of workers: a *round* is ``communication_window`` local minibatch
steps on each worker followed by one exchange with the center (a
collective sum of the window deltas or elastic terms, then the rule of
``rules.py``), and an epoch is a scan of rounds.  The port keeps the same
rounds, rules and state, and runs the workers in one of two ways, by the
rule of ``mesh.py``:

 - **across ranks** (a process group of the mesh's size): one worker a
   rank, as one JAX device holds one worker.  A rank holds the replicated
   center and its own worker's params and optimizer state
   (``DistState.local`` and ``opt_state`` hold one entry), takes its
   worker's column of every round's data, and the exchange is one
   ``all_reduce`` a round over the worker axis;
 - **in one process** (a mesh that repeats one device): the workers run
   one after another on that device (a plain loop) and the exchange sums
   over the loop's results.

Both ways build the same per-worker terms and sum them elementwise, so two
ranks equal the one-process two-worker engine to the bit.  A round's
reductions (the deltas or elastic terms, BatchNorm's statistics and the
loss sum) travel as one flat buffer, one collective a round.  Vectorising
the workers (``torch.func.functional_call`` + ``vmap``) or a CUDA graph of
the round is later work (ROADMAP).

What persists across rounds, as in the JAX engine:
 - ADAG, DOWNPOUR and DynSGD start every worker's window from the center;
   AEASGD, EAMSGD and ``local`` from the worker's own params;
 - each worker's optimizer state (Adam's count and moments) persists;
 - BatchNorm's running statistics, unless the algorithm is ``local``, are
   averaged over the workers after the window and written into every
   worker and into the center before the commit, so they add exactly 0 to
   every delta.

The step updates the one model's parameters in place, so the engine loads
each worker's params (statistics included) into the model before its
window and reads them back after.  Dropout masks come from one
``torch.Generator`` per worker and round, seeded from (seed, worker,
round), the same for worker k on rank k and in the loop; they never match
the JAX package's threefry masks.  A round's loss is Σᵢ loss_sumᵢ /
max(Σᵢ wsumᵢ, 1) over the real (unpadded) examples; every process holds
the whole host mask, so the weight sum needs no collective, and the losses
stay on the device until the caller reads them.

A packed engine (``packed=True``, sequence packing, ``data/packing.py``)
also takes each round's segment ids and threads them into the masked
step's forward, so that attention keeps every document to itself.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import optimizers as opt_lib
from ..core.model import Sequential, load_jax_weights
from ..core.train import TrainState, make_masked_step, model_params
from ..data.pipeline import num_rounds, prefetch_to_device, round_block
from ..device import host_to_device
from . import collective, rules
from .mesh import (WORKER_AXIS, Mesh, across_ranks, local_workers,
                   same_device, worker_device, worker_sharded)

#: the algorithms of the engine; the first three pull the center each round
ALGORITHMS = ("adag", "downpour", "dynsgd", "aeasgd", "eamsgd", "local")
_FROM_CENTER = ("adag", "downpour", "dynsgd")

Params = Dict[str, torch.Tensor]


class DistState(NamedTuple):
    """Distributed training state.

    center:    params of the center model (path → tensor, the JAX leaf
               order; the parameter server's model)
    local:     the params of this process's workers, one dict per worker
               (every worker in one process, its own across ranks)
    opt_state: the optimizer state of the same workers
    round_idx: the round clock (the parameter server's update counter)
    """
    center: Params
    local: List[Params]
    opt_state: List[Any]
    round_idx: int


def _is_stats(path: str) -> bool:
    return "/stats/" in f"/{path}/"


def _seed(*entropy: int) -> int:
    return int(np.random.SeedSequence(
        [int(e) % (1 << 64) for e in entropy]).generate_state(1,
                                                              np.uint64)[0])


def _pack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """One flat buffer of ``tensors`` (one dtype) in order."""
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError("a packed exchange takes tensors of one dtype, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack(flat: torch.Tensor, like: List[torch.Tensor]
            ) -> List[torch.Tensor]:
    """``flat`` cut back into tensors shaped as ``like``."""
    sizes = [t.numel() for t in like]
    return [p.view(t.shape) for p, t in zip(flat.split(sizes), like)]


class SPMDEngine:
    """Runs the rounds of one algorithm over a worker mesh."""

    def __init__(self, model: Sequential, loss, worker_optimizer,
                 mesh: Mesh, algorithm: str,
                 communication_window: int = 5,
                 learning_rate: Optional[float] = None,
                 alpha: Optional[float] = None,
                 lr_schedule=None, schedule_steps: Optional[int] = None,
                 gradient_accumulation: int = 1,
                 gradient_clip_norm=None,
                 packed: bool = False):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}; known: "
                             f"{list(ALGORITHMS)}")
        if algorithm in ("aeasgd", "eamsgd") and alpha is None:
            raise ValueError(f"algorithm {algorithm!r} needs the elastic "
                             "coefficient alpha")
        self.device = worker_device(mesh)
        if not same_device(model.device, self.device):
            raise ValueError(f"the model is on {model.device}, the worker "
                             f"mesh on {self.device}")
        self.model = model
        self.loss = loss
        self.mesh = mesh
        self.algorithm = algorithm
        self.window = int(communication_window)
        self.num_workers = int(mesh.devices.size)
        #: one worker a rank (True) or every worker in this process
        self.ranks = across_ranks(mesh)
        #: the workers this process runs, by index on the worker axis
        self.workers = local_workers(mesh)
        self.alpha = alpha
        self.optimizer = opt_lib.get_optimizer(worker_optimizer, learning_rate)
        self.lr_schedule = lr_schedule
        self.schedule_steps = schedule_steps
        self.gradient_accumulation = int(gradient_accumulation)
        self.gradient_clip_norm = gradient_clip_norm
        # packed=True: the rounds also take segment ids (data/packing.py)
        self.packed = bool(packed)
        self.tx = None  # built in init_state (needs params for masking)
        self._params: Optional[Params] = None
        self._step = None

    @property
    def is_writer(self) -> bool:
        """Whether this process writes what the run writes once
        (checkpoints, the metrics file): rank 0, or the one process."""
        return not self.ranks or self.mesh.rank == 0

    # -- state --------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   input_shape=None, initial_params=None) -> DistState:
        """Build the model's parameters for ``input_shape`` from
        ``generator`` (as ``Sequential.build``), or take ``initial_params``
        (a path → tensor dict, or a flat list in the JAX leaf order);
        every worker starts from the center, with a fresh optimizer
        state.  Without either it takes the model's parameters as they
        are; a run leaves the last worker's in the model, so a second
        start from the first one's weights passes ``initial_params``.
        Across ranks every rank builds the same center, as every JAX host
        draws the same initial params."""
        if input_shape is not None or self.model.input_shape is None:
            self.model.build(input_shape, generator=generator)
        params = model_params(self.model)
        if isinstance(initial_params, dict):
            initial_params = [v.detach().cpu().numpy()
                              if isinstance(v, torch.Tensor) else v
                              for v in initial_params.values()]
        if initial_params is not None:
            load_jax_weights(self.model, initial_params)
        self._params = params
        self.tx = opt_lib.build_tx(
            self.optimizer, params, None, self.lr_schedule,
            self.schedule_steps, self.gradient_accumulation,
            self.gradient_clip_norm)
        self._step = make_masked_step(self.model, self.loss, self.tx)
        center = self._snapshot()
        local = [self._clone(center) for _ in self.workers]
        opt_state = [self.tx.init(list(p.values())) for p in local]
        return DistState(center, local, opt_state, 0)

    def put_state(self, state: DistState) -> DistState:
        """A state whose tensors are the engine's own, on its device (the
        checkpoint restore path: the leaves arrive from host arrays).
        ``state`` holds this process's workers, or every worker of the
        mesh (a checkpoint, a one-process state), of which a rank takes
        its own."""
        def own(leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.detach().to(self.device).clone()
            return leaf
        local, opt_state = list(state.local), list(state.opt_state)
        if len(local) == self.num_workers != len(self.workers):
            local = [local[i] for i in self.workers]
            opt_state = [opt_state[i] for i in self.workers]
        if len(local) != len(self.workers):
            raise ValueError(f"a state of {len(local)} workers for a "
                             f"process that runs {len(self.workers)} of "
                             f"{self.num_workers}")
        return DistState(rules.tmap(own, state.center),
                         rules.tmap(own, local), rules.tmap(own, opt_state),
                         int(state.round_idx))

    def gather_workers(self, state: DistState) -> DistState:
        """``state`` with every worker of the mesh, in worker order, on
        every process: the state itself in one process; across ranks the
        workers' params and optimizer states gathered from every rank
        (one ``all_gather`` a dtype, the optimizer's counters as
        objects).  A collective: every rank calls it."""
        if not self.ranks:
            return state
        import torch.distributed as dist
        from ..checkpoint import _refill, tree_leaves
        mine = (state.local[0], state.opt_state[0])
        leaves = tree_leaves(mine)
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        others = [x for x in leaves if not isinstance(x, torch.Tensor)]
        n = self.num_workers
        parts = [[None] * len(tensors) for _ in range(n)]
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            pos = [k for k, t in enumerate(tensors) if t.dtype == dtype]
            like = [tensors[k] for k in pos]
            flat = collective.gather_leaf(_pack(like), WORKER_AXIS, 0,
                                          self.mesh)
            for w, chunk in enumerate(flat.chunk(n)):
                for k, t in zip(pos, _unpack(chunk.clone(), like)):
                    parts[w][k] = t
        numbers = [None] * n
        dist.all_gather_object(numbers, others,
                               group=self.mesh.group(WORKER_AXIS))
        workers = []
        for w in range(n):
            it_t, it_o = iter(parts[w]), iter(numbers[w])
            workers.append(_refill(mine, iter(
                next(it_t) if isinstance(x, torch.Tensor) else next(it_o)
                for x in leaves)))
        return DistState(state.center, [w[0] for w in workers],
                         [w[1] for w in workers], state.round_idx)

    def worker_rngs(self, seed: int) -> List[int]:
        """One base seed for each of this process's workers, worker k's
        from (this seed, k): rank k and the one-process loop's worker k
        draw the same masks.  A round's generator for worker k is seeded
        from (worker k's seed, the round clock)."""
        return [_seed(seed, k) for k in self.workers]

    # -- the round ------------------------------------------------------------
    @staticmethod
    def _clone(params: Params) -> Params:
        return {k: v.clone() for k, v in params.items()}

    def _snapshot(self) -> Params:
        return {k: p.detach().clone() for k, p in self._params.items()}

    @torch.no_grad()
    def _load(self, params: Params) -> None:
        for p, v in zip(self._params.values(), params.values()):
            p.copy_(v)

    def _generator(self, base: int, round_idx: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            _seed(base, round_idx))

    def _worker_sum(self, parts: List[List[torch.Tensor]]
                    ) -> List[torch.Tensor]:
        """The elementwise sum over every worker of the mesh of each
        process worker's list of tensors (one dtype): one flat buffer,
        summed over the loop's workers in one process, by one
        ``all_reduce`` over the worker axis across ranks (the JAX
        engine's ``psum``)."""
        flats = [_pack(p) for p in parts]
        if self.ranks:
            total = collective.all_reduce_sum(flats[0], WORKER_AXIS,
                                              self.mesh)
        else:
            total = torch.stack(flats).sum(0)
        return _unpack(total, parts[0])

    def _term(self, p: Params, center: Params, worker: int,
              round_idx: int, keys: List[str]) -> Params:
        """Worker ``worker``'s part of the exchange at ``keys`` by the rules
        of ``rules.py``: its window delta (ADAG, DOWNPOUR), its delta scaled
        by 1 / (staleness + 1) (DynSGD's serialized-commit emulation:
        within a round, worker i's commit lands after (i + round) mod n
        earlier ones), or its elastic term (AEASGD, EAMSGD)."""
        p, center = {k: p[k] for k in keys}, {k: center[k] for k in keys}
        if self.algorithm in ("aeasgd", "eamsgd"):
            return rules.elastic_difference(p, center, self.alpha)
        delta = rules.tree_sub(p, center)
        if self.algorithm == "dynsgd":
            return rules.dynsgd_commit(
                rules.tmap(torch.zeros_like, center), delta,
                (worker + round_idx) % self.num_workers)
        return delta

    def _round(self, state: DistState, x, y, m, rngs, s=None
               ) -> Tuple[DistState, torch.Tensor]:
        """One round: every worker's window, then the exchange.  ``x``,
        ``y`` (``s``, packed engines: the segment ids): (window, workers,
        batch, ...) tensors on the device holding this process's workers'
        columns; ``m``: the host (window, workers, batch) real/padding
        mask of every worker."""
        if self._step is None:
            raise RuntimeError("call init_state before running rounds")
        n, algo = self.num_workers, self.algorithm
        m = np.asarray(m, np.float32)
        new_p, new_s, loss_sums = [], [], []
        for j, i in enumerate(self.workers):
            self._load(state.center if algo in _FROM_CENTER
                       else state.local[j])
            generator = self._generator(rngs[j], state.round_idx)
            ts = TrainState(self._params, state.opt_state[j], 0)
            weighted = []
            for t in range(self.window):
                ts, value, ws = self._step(
                    ts, x[t, j], y[t, j], m[t, i], generator,
                    s[t, j] if s is not None else None)
                weighted.append(value.to(torch.float32) * ws)
            new_p.append(self._snapshot())
            new_s.append(ts.opt_state)
            loss_sums.append(torch.stack(weighted).sum())
        center = state.center
        # 'local' is independent training: per-worker stats persist and
        # nothing is exchanged
        stats = ([k for k in center if _is_stats(k)]
                 if algo != "local" and self.model.has_stats() else [])
        keys = ([] if algo == "local"
                else [k for k in center if k not in stats])
        terms = [self._term(p, center, i, state.round_idx, keys)
                 for p, i in zip(new_p, self.workers)]
        summed = self._worker_sum([
            [*term.values(), *(p[k] for k in stats), loss.reshape(1)]
            for term, p, loss in zip(terms, new_p, loss_sums)])
        total = dict(zip(keys, summed))
        if stats:
            # the mean over the workers of each statistic, written into
            # every worker and into the center: evaluation of the center
            # sees real running statistics, and the statistics add exactly
            # 0 to every delta and elastic term (worker == center)
            new_p, center = [dict(p) for p in new_p], dict(center)
            for k, ssum in zip(stats, summed[len(keys):]):
                mean = ssum / n
                for p in new_p:
                    p[k] = mean
                center[k] = mean
                total[k] = torch.zeros_like(mean)
        if algo == "adag":
            center = rules.adag_commit(center, total, n)
        elif algo == "downpour":
            center = rules.delta_commit(center, total)
        elif algo == "dynsgd":
            center = rules.tree_add(center, total)
        elif algo in ("aeasgd", "eamsgd"):
            new_p = [rules.easgd_worker_update(
                p, {k: term.get(k, total[k]) for k in p})
                for p, term in zip(new_p, terms)]
            center = rules.easgd_center_update(center, total)
        # 'local': the center stays as it was
        wsum = float(m.sum())
        loss = summed[-1][0] / max(wsum, 1.0)
        return DistState(center, new_p, new_s, state.round_idx + 1), loss

    # -- epochs ---------------------------------------------------------------
    def _check_packed(self, seg) -> None:
        if self.packed and seg is None:
            raise ValueError("packed engine needs segment ids")
        if seg is not None and not self.packed:
            raise ValueError("segment ids passed to an unpacked engine — "
                             "construct SPMDEngine(packed=True)")

    def place_columns(self, a, axis: int):
        """``a`` on the device with this process's workers' columns of
        its worker dim ``axis`` (JAX's ``P(None, ..., 'workers')``): a
        rank copies only its own.  An array whose dim already holds just
        this process's workers (a placed one) goes as it is."""
        if a is None:
            return None
        if a.shape[axis] == len(self.workers):
            return host_to_device(a, self.device)
        return worker_sharded(self.mesh, axis).place(a)

    def barrier(self) -> None:
        """Across ranks, wait for every rank; in one process nothing."""
        if self.ranks:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.group(WORKER_AXIS))

    def from_writer(self, obj):
        """Rank 0's ``obj`` on every rank (a collective across ranks; in
        one process ``obj``): a decision every rank must take alike."""
        if not self.ranks:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0,
                                   group=self.mesh.group(WORKER_AXIS))
        return box[0]

    def run_round(self, state: DistState, x, y, m, rngs, s=None
                  ) -> Tuple[DistState, torch.Tensor]:
        """One round from arrays shaped (window, workers, batch, ...) with
        every worker's column (a rank takes its own), the round-granular
        checkpointing path; the same computation as a round of
        :meth:`run_epoch`.  ``s``: the segment ids of a packed engine.
        The loss comes back on the device."""
        self._check_packed(s)
        x, y, s = (self.place_columns(a, 1) for a in (x, y, s))
        return self._round(state, x, y, np.asarray(m), rngs, s)

    def run_epoch(self, state: DistState, xb, yb, mb, rngs, sb=None
                  ) -> Tuple[DistState, torch.Tensor]:
        """``xb``/``yb``: (rounds, window, workers, batch, ...) arrays with
        every worker's column, host arrays or tensors (a rank copies only
        its column to its device, once an epoch); ``mb``: the host
        real/padding mask from :func:`shape_epoch_data`; ``sb`` the segment
        ids of a packed engine, shaped as ``xb``.  The per-round losses
        come back as one tensor on the device: nothing in an epoch waits
        for the card."""
        self._check_packed(sb)
        xb, yb, sb = (self.place_columns(a, 2) for a in (xb, yb, sb))
        mb = np.asarray(mb)
        losses = []
        for r in range(len(mb)):
            state, loss = self._round(state, xb[r], yb[r], mb[r], rngs,
                                      sb[r] if sb is not None else None)
            losses.append(loss)
        return state, torch.stack(losses)

    def run_epoch_streaming(self, state: DistState, round_iter: Iterator,
                            rngs) -> Tuple[DistState, np.ndarray]:
        """An epoch from a generator of per-round host (x, y, mask) triples,
        or (x, y, seg, mask) quadruples on a packed engine, shaped (window,
        workers, batch, ...) (``data.pipeline.round_stream``; pass ``seg=``
        there iff the engine is packed), double-buffered onto the device
        by ``prefetch_to_device(shardings=)``, a rank's column only: the
        same computation as :meth:`run_epoch`, for data that cannot live
        on the device whole.  Returns the losses as host float32."""
        arity = 4 if self.packed else 3

        def checked(it):
            for item in it:
                if len(item) != arity:
                    raise ValueError(
                        f"streamed round has {len(item)} arrays, the "
                        f"{'packed' if self.packed else 'unpacked'} "
                        f"engine expects {arity} — pass seg=… to "
                        "round_stream iff the engine is packed")
                yield item

        losses = []
        # the data to its workers' devices, the whole mask to the host
        shardings = ((worker_sharded(self.mesh, 1),) * (arity - 1)
                     + (torch.device("cpu"),))
        for *data, m in prefetch_to_device(checked(round_iter),
                                           shardings=shardings):
            x, y, *s = data
            state, loss = self._round(state, x, y, m.numpy(), rngs,
                                      s[0] if s else None)
            losses.append(loss)
        return state, torch.stack(losses).cpu().numpy().astype(np.float32)


def shape_epoch_data(columns_x: np.ndarray, columns_y: np.ndarray,
                     num_workers: int, window: int, batch_size: int,
                     columns_seg: Optional[np.ndarray] = None):
    """Reshape flat (rows, ...) arrays into (rounds, window, workers, batch,
    ...) plus a per-example mask, padding the tail to a whole round (a copy
    of the JAX package's numpy function: the same arrays to the bit).

    The tail round is filled by wrapping real rows, and the mask is 1.0 for
    real rows and 0.0 for padding: padded examples add nothing to the loss
    or the gradients while BatchNorm's batch statistics stay over real
    values.  The layout (a round-robin deal of rows to workers, so padding
    never piles up on one worker) is ``data.pipeline.round_block``, shared
    with the streaming path.

    Returns ``(xb, yb, mask, rounds)``, or ``(xb, yb, sb, mask, rounds)``
    when ``columns_seg`` (sequence-packing segment ids, same row order) is
    given; every real row appears exactly once.
    """
    n, w, b = num_workers, window, batch_size
    rounds = num_rounds(len(columns_x), n, w, b)
    sel = np.empty((rounds, w, n, b), np.int64)
    mask = np.empty((rounds, w, n, b), np.float32)
    for r in range(rounds):
        sel[r], mask[r] = round_block(len(columns_x), n, w, b, r)
    if columns_seg is not None:
        return (columns_x[sel], columns_y[sel], columns_seg[sel], mask,
                rounds)
    return columns_x[sel], columns_y[sel], mask, rounds
