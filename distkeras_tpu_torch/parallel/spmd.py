"""The SPMD execution engine of the distributed trainers, port of
``distkeras_tpu/parallel/spmd.py``.

The JAX engine runs every algorithm as one bulk-synchronous program over a
mesh of workers: a *round* is ``communication_window`` local minibatch
steps on each worker followed by one exchange with the center (a
collective sum of the window deltas or elastic terms, then the rule of
``rules.py``), and an epoch is a scan of rounds.  The port keeps the same
rounds, rules and state on one device: the workers of a mesh run one after
another on the mesh's one device (a plain loop), each window through the
trainers' masked step (``core.train.make_masked_step``), and the exchange
is a sum over the loop's results.  Vectorising the workers
(``torch.func.functional_call`` + ``vmap``) or a CUDA graph of the round
is later work (ROADMAP); workers on distinct cards wait for ROADMAP queue
A item 7.

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
round); they never match the JAX package's threefry masks.  A round's loss
is Σᵢ loss_sumᵢ / max(Σᵢ wsumᵢ, 1) over the real (unpadded) examples, and
the losses stay on the device until the caller reads them.

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
from . import rules
from .mesh import Mesh, same_device, worker_device

#: the algorithms of the engine; the first three pull the center each round
ALGORITHMS = ("adag", "downpour", "dynsgd", "aeasgd", "eamsgd", "local")
_FROM_CENTER = ("adag", "downpour", "dynsgd")

Params = Dict[str, torch.Tensor]


class DistState(NamedTuple):
    """Distributed training state.

    center:    params of the center model (path → tensor, the JAX leaf
               order; the parameter server's model)
    local:     each worker's params, one dict per worker
    opt_state: each worker's optimizer state
    round_idx: the round clock (the parameter server's update counter)
    """
    center: Params
    local: List[Params]
    opt_state: List[Any]
    round_idx: int


def _is_stats(path: str) -> bool:
    return "/stats/" in f"/{path}/"


def _worker_sum(trees: List[Params]) -> Params:
    """The sum over the workers of their trees, leaf by leaf (the JAX
    engine's ``psum`` over the worker axis)."""
    return rules.tmap(lambda *xs: torch.stack(xs).sum(0), *trees)


def _seed(*entropy: int) -> int:
    return int(np.random.SeedSequence(
        [int(e) % (1 << 64) for e in entropy]).generate_state(1,
                                                              np.uint64)[0])


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

    # -- state --------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   input_shape=None, initial_params=None) -> DistState:
        """Build the model's parameters for ``input_shape`` from
        ``generator`` (as ``Sequential.build``), or take ``initial_params``
        (a path → tensor dict, or a flat list in the JAX leaf order);
        every worker starts from the center, with a fresh optimizer
        state.  Without either it takes the model's parameters as they
        are; a run leaves the last worker's in the model, so a second
        start from the first one's weights passes ``initial_params``."""
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
        local = [self._clone(center) for _ in range(self.num_workers)]
        opt_state = [self.tx.init(list(p.values())) for p in local]
        return DistState(center, local, opt_state, 0)

    def put_state(self, state: DistState) -> DistState:
        """A state whose tensors are the engine's own, on its device (the
        checkpoint restore path: the leaves arrive from host arrays)."""
        def own(leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.detach().to(self.device).clone()
            return leaf
        return DistState(rules.tmap(own, state.center),
                         rules.tmap(own, list(state.local)),
                         rules.tmap(own, list(state.opt_state)),
                         int(state.round_idx))

    def worker_rngs(self, seed: int) -> List[int]:
        """One base seed per worker; a round's generator for worker k is
        seeded from (this seed, the round clock)."""
        return [_seed(seed, k) for k in range(self.num_workers)]

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

    def _sync_stats(self, new_p: List[Params], center: Params):
        """The mean over the workers of each BatchNorm statistic, written
        into every worker's params and into the center: evaluation of the
        center sees real running statistics, and the statistics add
        exactly 0 to every delta and elastic term (worker == center)."""
        keys = [k for k in center if _is_stats(k)]
        new_p = [dict(p) for p in new_p]
        center = dict(center)
        for k in keys:
            mean = torch.stack([p[k] for p in new_p]).sum(0) / len(new_p)
            for p in new_p:
                p[k] = mean
            center[k] = mean
        return new_p, center

    def _round(self, state: DistState, x, y, m, rngs, s=None
               ) -> Tuple[DistState, torch.Tensor]:
        """One round: every worker's window, then the exchange.  ``x``,
        ``y``: (window, workers, batch, ...) tensors on the device; ``m``:
        the host (window, workers, batch) real/padding mask; ``s`` (packed
        engines): the segment ids, as ``x``."""
        if self._step is None:
            raise RuntimeError("call init_state before running rounds")
        n, algo = self.num_workers, self.algorithm
        new_p, new_s, weighted, wsum = [], [], [], 0.0
        for i in range(n):
            self._load(state.center if algo in _FROM_CENTER
                       else state.local[i])
            generator = self._generator(rngs[i], state.round_idx)
            ts = TrainState(self._params, state.opt_state[i], 0)
            for t in range(self.window):
                ts, value, ws = self._step(
                    ts, x[t, i], y[t, i], m[t, i], generator,
                    s[t, i] if s is not None else None)
                weighted.append(value.to(torch.float32) * ws)
                wsum += ws
            new_p.append(self._snapshot())
            new_s.append(ts.opt_state)
        center = state.center
        if algo != "local" and self.model.has_stats():
            # 'local' is independent training: per-worker stats persist
            new_p, center = self._sync_stats(new_p, center)

        if algo == "adag":
            center = rules.adag_commit(
                center, _worker_sum([rules.tree_sub(p, center)
                                     for p in new_p]), n)
        elif algo == "downpour":
            center = rules.delta_commit(
                center, _worker_sum([rules.tree_sub(p, center)
                                     for p in new_p]))
        elif algo == "dynsgd":
            # serialized-commit emulation: within a round, worker i's
            # commit lands after (i + round) mod n earlier ones, and its
            # delta is scaled by 1/(staleness + 1)
            zeros = rules.tmap(torch.zeros_like, center)
            center = rules.tree_add(center, _worker_sum([
                rules.dynsgd_commit(zeros, rules.tree_sub(p, center),
                                    (i + state.round_idx) % n)
                for i, p in enumerate(new_p)]))
        elif algo in ("aeasgd", "eamsgd"):
            e = [rules.elastic_difference(p, center, self.alpha)
                 for p in new_p]
            new_p = [rules.easgd_worker_update(p, ei)
                     for p, ei in zip(new_p, e)]
            center = rules.easgd_center_update(center, _worker_sum(e))
        # 'local': no exchange, the center stays as it was

        loss = torch.stack(weighted).sum() / max(wsum, 1.0)
        return DistState(center, new_p, new_s, state.round_idx + 1), loss

    # -- epochs ---------------------------------------------------------------
    def _check_packed(self, seg) -> None:
        if self.packed and seg is None:
            raise ValueError("packed engine needs segment ids")
        if seg is not None and not self.packed:
            raise ValueError("segment ids passed to an unpacked engine — "
                             "construct SPMDEngine(packed=True)")

    def _on_device(self, a):
        return None if a is None else host_to_device(a, self.device)

    def run_round(self, state: DistState, x, y, m, rngs, s=None
                  ) -> Tuple[DistState, torch.Tensor]:
        """One round from arrays shaped (window, workers, batch, ...), the
        round-granular checkpointing path; the same computation as a
        round of :meth:`run_epoch`.  ``s``: the segment ids of a packed
        engine.  The loss comes back on the device."""
        self._check_packed(s)
        return self._round(state, self._on_device(x), self._on_device(y),
                           np.asarray(m), rngs, self._on_device(s))

    def run_epoch(self, state: DistState, xb, yb, mb, rngs, sb=None
                  ) -> Tuple[DistState, torch.Tensor]:
        """``xb``/``yb``: (rounds, window, workers, batch, ...) arrays
        (tensors on the device, or host arrays copied there once); ``mb``:
        the host real/padding mask from :func:`shape_epoch_data`; ``sb``
        the segment ids of a packed engine, shaped as ``xb``.  The
        per-round losses come back as one tensor on the device: nothing in
        an epoch waits for the card."""
        self._check_packed(sb)
        xb, yb, sb = (self._on_device(a) for a in (xb, yb, sb))
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
        there iff the engine is packed), double-buffered onto the device:
        the same computation as :meth:`run_epoch`, for data that cannot
        live on the device whole.  Returns the losses as host float32."""
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
        devices = ((self.device,) * (arity - 1)) + (torch.device("cpu"),)
        for *data, m in prefetch_to_device(checked(round_iter), devices):
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
