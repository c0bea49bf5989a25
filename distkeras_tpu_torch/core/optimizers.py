"""Optimizers: Keras-style names and constructors, port of
``distkeras_tpu/core/optimizers.py``.

The JAX package backs each name with an optax transformation; the port
writes the same update rules by hand on lists of tensors, so that a step
here is optax's step, not ``torch.optim``'s (which differ: Adam's epsilon
is Keras's 1e-7 here, AdamW decays by ``lr·wd·param`` added to the update,
global-norm clipping has no ``+1e-6``, Nesterov SGD is ``g + m·trace``,
and LAMB and Lion have no ``torch.optim`` counterpart).

A transformation is an ``init(params) -> state`` and an ``update(grads,
state, params) -> (updates, new_state)`` pair over lists of tensors in one
order, as in optax; :func:`apply_updates` adds the updates to the
parameters in place (the port's parameters are the model's own tensors).
``update`` never changes its ``state`` argument, so a caller can keep the
old state (the masked step's no-op).

The rules that take norms (:func:`clip_by_global_norm`,
:func:`scale_by_trust_ratio`) take them over the tensors they are given.
A sharded step that runs the rule on slices of the logical tensors
(ZeRO-1 and FSDP, ``parallel/train_step.py``) sets :func:`mesh_squares`
around the update, and the norms are then those of the whole leaves,
summed over the ranks that hold their slices, as the JAX package's
sharded steps take them under plain ``jit``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

Tensors = List[torch.Tensor]


class Transform(NamedTuple):
    """The counterpart of ``optax.GradientTransformation``."""
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Optional[Tensors]], Any]


class Optimizer:
    """Named optimizer with its hyper-parameters (the JAX package's thin
    wrapper over an optax factory)."""

    def __init__(self, name: str, **hyper):
        self.name = name
        self.hyper = hyper

    def to_transform(self) -> Transform:
        """The update rule, as ``Optimizer.to_optax`` builds it."""
        h = self.hyper
        lr = h.get("learning_rate", _DEFAULT_LR.get(self.name, 0.01))
        eps = h.get("epsilon", 1e-7)
        b1, b2 = h.get("beta_1", 0.9), h.get("beta_2", 0.999)
        if self.name == "sgd":
            return chain(trace(h.get("momentum", 0.0),
                               h.get("nesterov", False)),
                         scale_by_learning_rate(lr))
        if self.name in ("adam", "nadam"):
            return chain(scale_by_adam(b1, b2, eps,
                                       nesterov=self.name == "nadam"),
                         scale_by_learning_rate(lr))
        if self.name == "adamw":
            return chain(scale_by_adam(b1, b2, eps),
                         add_decayed_weights(h.get("weight_decay", 1e-4)),
                         scale_by_learning_rate(lr))
        if self.name == "adagrad":
            return chain(scale_by_rss(0.1, eps), scale_by_learning_rate(lr))
        if self.name == "adadelta":
            return chain(scale_by_adadelta(h.get("rho", 0.95), eps),
                         scale_by_learning_rate(lr))
        if self.name == "rmsprop":
            return chain(scale_by_rms(h.get("rho", 0.9), eps),
                         scale_by_learning_rate(lr),
                         trace(h.get("momentum", 0.0), False))
        if self.name == "adamax":
            return chain(scale_by_adamax(b1, b2, eps),
                         scale_by_learning_rate(lr))
        if self.name == "lamb":
            # optax.lamb's own defaults: eps 1e-6, no weight decay
            return chain(scale_by_adam(0.9, 0.999, 1e-6),
                         scale_by_trust_ratio(), scale_by_learning_rate(lr))
        if self.name == "lion":
            # sign-momentum optimizer (Chen et al. 2023)
            return chain(scale_by_lion(b1, h.get("beta_2", 0.99)),
                         add_decayed_weights(h.get("weight_decay", 0.0)),
                         scale_by_learning_rate(lr))
        raise ValueError(f"Unknown optimizer {self.name!r}")

    def get_config(self):
        return {"name": self.name, **self.hyper}

    def __repr__(self):
        return f"Optimizer({self.name!r}, {self.hyper})"


_DEFAULT_LR = {
    "sgd": 0.01,
    "adam": 0.001,
    "adamw": 0.001,
    "adagrad": 0.01,
    "adadelta": 1.0,
    "rmsprop": 0.001,
    "nadam": 0.002,   # Keras-1.x Nadam/Adamax default lr
    "adamax": 0.002,
    "lamb": 0.001,
    "lion": 0.0001,
}


def SGD(learning_rate=0.01, momentum=0.0, nesterov=False):
    return Optimizer("sgd", learning_rate=learning_rate, momentum=momentum,
                     nesterov=nesterov)


def Adam(learning_rate=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-7):
    return Optimizer("adam", learning_rate=learning_rate, beta_1=beta_1,
                     beta_2=beta_2, epsilon=epsilon)


def Adagrad(learning_rate=0.01, epsilon=1e-7):
    return Optimizer("adagrad", learning_rate=learning_rate, epsilon=epsilon)


def Adadelta(learning_rate=1.0, rho=0.95, epsilon=1e-7):
    return Optimizer("adadelta", learning_rate=learning_rate, rho=rho,
                     epsilon=epsilon)


def RMSprop(learning_rate=0.001, rho=0.9, epsilon=1e-7, momentum=0.0):
    return Optimizer("rmsprop", learning_rate=learning_rate, rho=rho,
                     epsilon=epsilon, momentum=momentum)


def get_optimizer(spec: Any, learning_rate: Optional[float] = None
                  ) -> Optimizer:
    """Resolve a Keras-style optimizer spec: name string or Optimizer."""
    if isinstance(spec, Optimizer):
        return spec
    if isinstance(spec, str):
        hyper = {}
        if learning_rate is not None:
            hyper["learning_rate"] = learning_rate
        return Optimizer(spec.lower(), **hyper)
    raise TypeError(f"Cannot interpret optimizer spec {spec!r}")


# ---------------------------------------------------------------------------
# schedules (optax's formulas)
# ---------------------------------------------------------------------------

def _cosine(init_value: float, decay_steps: int, alpha: float):
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * decay + alpha)
    return schedule


def _warmup_cosine(init_value: float, peak_value: float, warmup_steps: int,
                   decay_steps: int, end_value: float):
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = _cosine(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        if warmup_steps <= 0:
            return init_value
        frac = 1 - max(count, 0) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    return schedule


def get_schedule(spec: Any, base_lr: float,
                 total_steps: Optional[int] = None):
    """Resolve an LR-schedule spec to ``count -> lr`` (or ``base_lr``).

    ``spec``: None (returns ``base_lr`` unchanged), a callable (used
    as-is), a name string, or a ``{"name": ..., ...}`` dict overriding the
    defaults.  Named schedules, as in the JAX package:

    - ``"warmup_cosine"``: linear ``init_value`` (0) → ``base_lr`` over
      ``warmup_steps`` (default 10% of ``total_steps``), cosine decay to
      ``end_value`` (0) over ``decay_steps`` (default ``total_steps``).
    - ``"cosine"``: cosine decay ``base_lr`` → ``alpha * base_lr`` over
      ``decay_steps``.
    - ``"constant"``: ``base_lr`` forever.

    ``total_steps`` is the trainer's optimizer-update count.
    """
    if spec is None:
        return base_lr
    if callable(spec):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if not isinstance(spec, dict) or "name" not in spec:
        raise TypeError(
            f"lr_schedule must be a name, {{'name': ...}} dict or callable, "
            f"got {spec!r}")
    cfg = dict(spec)
    name = cfg.pop("name")
    if name == "constant":
        if cfg:
            raise ValueError(f"unknown lr_schedule keys {sorted(cfg)}")
        return base_lr
    decay_steps = cfg.pop("decay_steps", total_steps)
    if decay_steps is None:
        raise ValueError(
            f"lr_schedule {name!r} needs decay_steps (or a trainer that "
            "knows its total step count)")
    if name == "warmup_cosine":
        warmup = cfg.pop("warmup_steps", max(int(decay_steps * 0.1), 1))
        sched = _warmup_cosine(cfg.pop("init_value", 0.0), base_lr,
                               int(warmup), int(decay_steps),
                               cfg.pop("end_value", 0.0))
    elif name == "cosine":
        sched = _cosine(base_lr, int(decay_steps), cfg.pop("alpha", 0.0))
    else:
        raise ValueError(f"unknown lr_schedule {name!r} "
                         "(warmup_cosine/cosine/constant)")
    if cfg:
        raise ValueError(f"unknown lr_schedule keys {sorted(cfg)}")
    return sched


# ---------------------------------------------------------------------------
# transformations (optax's, over lists of tensors)
# ---------------------------------------------------------------------------

#: this thread's (reduce, leaf positions) while a sharded step's update
#: runs, as torch.no_grad is a thread's
_SQUARES = threading.local()


@contextlib.contextmanager
def _squares_as(value: Optional[tuple]):
    prev = getattr(_SQUARES, "value", None)
    _SQUARES.value = value
    try:
        yield
    finally:
        _SQUARES.value = prev


def mesh_squares(reduce: Callable[[Tensors, List[int]], Tensors], n: int):
    """A context in which the norm-taking rules sum each leaf's squares
    through ``reduce(sums, positions)``: the per-leaf sums of squares of
    the slices this rank holds and the leaves' positions among the ``n``
    the step updates, to the sums over the whole leaves."""
    return _squares_as((reduce, list(range(n))))


def _leaf_squares(tensors: Tensors) -> Optional[Tensors]:
    """Each whole leaf's sum of squares under :func:`mesh_squares`, else
    None."""
    value = getattr(_SQUARES, "value", None)
    if value is None:
        return None
    reduce, positions = value
    return reduce([torch.sum(t * t) for t in tensors], positions)


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _moment(g, t, decay, order):
    """optax's ``update_moment``: (1 - decay)·g^order + decay·t."""
    return (1 - decay) * (g if order == 1 else g ** order) + decay * t


def _bias_correction(t, decay, count):
    # 1 - decay**count in f32, as optax computes it
    return t / float(1 - np.float32(decay) ** np.float32(count))


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return Transform(init, update)


def _stateless(fn) -> Transform:
    return Transform(lambda params: (),
                     lambda updates, state, params=None:
                     (fn(updates, params), state))


def trace(decay: float, nesterov: bool = False) -> Transform:
    def update(updates, state, params=None):
        new = [g + decay * t for g, t in zip(updates, state)]
        if nesterov:
            return [g + decay * t for g, t in zip(updates, new)], new
        return new, new
    return Transform(_zeros, update)


def scale_by_adam(b1: float, b2: float, eps: float,
                  nesterov: bool = False) -> Transform:
    def init(params):
        return (0, _zeros(params), _zeros(params))

    def update(updates, state, params=None):
        count, mu, nu = state
        mu = [_moment(g, m, b1, 1) for g, m in zip(updates, mu)]
        nu = [_moment(g, v, b2, 2) for g, v in zip(updates, nu)]
        count += 1
        if nesterov:
            mu_hat = [b1 * _bias_correction(m, b1, count + 1)
                      + (1 - b1) * _bias_correction(g, b1, count)
                      for m, g in zip(mu, updates)]
        else:
            mu_hat = [_bias_correction(m, b1, count) for m in mu]
        out = [m / (torch.sqrt(_bias_correction(v, b2, count)) + eps)
               for m, v in zip(mu_hat, nu)]
        return out, (count, mu, nu)
    return Transform(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``optax.adam``: Adam at optax's own epsilon of 1e-8 (the Keras
    ``Adam`` above takes 1e-7), for callers that pass an update rule
    directly, as ``ParallelTransformerLM.compile_train_step`` does."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def add_decayed_weights(weight_decay: float) -> Transform:
    return _stateless(lambda updates, params: [
        g + weight_decay * p for g, p in zip(updates, params)])


def scale_by_rss(initial_accumulator_value: float, eps: float) -> Transform:
    def init(params):
        return [torch.full_like(p, initial_accumulator_value)
                for p in params]

    def update(updates, state, params=None):
        sos = [g * g + t for g, t in zip(updates, state)]
        out = [torch.where(t > 0, torch.rsqrt(t + eps), 0.0) * g
               for t, g in zip(sos, updates)]
        return out, sos
    return Transform(init, update)


def scale_by_adadelta(rho: float, eps: float) -> Transform:
    def init(params):
        return (_zeros(params), _zeros(params))

    def update(updates, state, params=None):
        e_g, e_x = state
        e_g = [_moment(g, t, rho, 2) for g, t in zip(updates, e_g)]
        out = [torch.sqrt(x + eps) / torch.sqrt(eg + eps) * g
               for g, eg, x in zip(updates, e_g, e_x)]
        e_x = [_moment(u, t, rho, 2) for u, t in zip(out, e_x)]
        return out, (e_g, e_x)
    return Transform(init, update)


def scale_by_rms(decay: float, eps: float) -> Transform:
    def update(updates, state, params=None):
        nu = [_moment(g, t, decay, 2) for g, t in zip(updates, state)]
        return [torch.rsqrt(n + eps) * g for n, g in zip(nu, updates)], nu
    return Transform(_zeros, update)


def scale_by_adamax(b1: float, b2: float, eps: float) -> Transform:
    def init(params):
        return (0, _zeros(params), _zeros(params))

    def update(updates, state, params=None):
        count, mu, nu = state
        count += 1
        mu = [_moment(g, m, b1, 1) for g, m in zip(updates, mu)]
        nu = [torch.maximum(g.abs() + eps, b2 * v)
              for g, v in zip(updates, nu)]
        out = [_bias_correction(m, b1, count) / v for m, v in zip(mu, nu)]
        return out, (count, mu, nu)
    return Transform(init, update)


def scale_by_trust_ratio() -> Transform:
    """optax's defaults (min_norm 0, trust coefficient 1, eps 0): each
    update scaled by ‖param‖ / ‖update‖, or left as is where either norm
    is 0."""
    def scale(updates, params):
        out = []
        p_sq, u_sq = _leaf_squares(params), _leaf_squares(updates)
        if p_sq is None:
            norms = [(torch.linalg.norm(p), torch.linalg.norm(u))
                     for u, p in zip(updates, params)]
        else:
            norms = [(torch.sqrt(a), torch.sqrt(b))
                     for a, b in zip(p_sq, u_sq)]
        for u, (pn, un) in zip(updates, norms):
            ratio = torch.where((pn == 0.0) | (un == 0.0),
                                torch.ones_like(pn), pn / un)
            out.append(u * ratio)
        return out
    return _stateless(scale)


def scale_by_lion(b1: float, b2: float) -> Transform:
    def update(updates, state, params=None):
        out = [torch.sign((1.0 - b1) * g + b1 * m)
               for g, m in zip(updates, state)]
        return out, [_moment(g, m, b2, 1) for g, m in zip(updates, state)]
    return Transform(_zeros, update)


def scale_by_learning_rate(learning_rate) -> Transform:
    """Multiply by -lr; a callable lr is a schedule over the update count."""
    if not callable(learning_rate):
        return _stateless(lambda updates, params: [
            -learning_rate * g for g in updates])

    def update(updates, count, params=None):
        step = -learning_rate(count)
        return [step * g for g in updates], count + 1
    return Transform(lambda params: 0, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """Rescale by max_norm / ‖g‖ only when ‖g‖ ≥ max_norm (optax's rule:
    no epsilon in the denominator)."""
    def clip(updates, params):
        squares = _leaf_squares(updates)
        if squares is None:
            squares = [torch.sum(g * g) for g in updates]
        norm = torch.sqrt(sum(squares))
        within = norm < max_norm  # stays on the device: no host sync
        return [torch.where(within, g, (g / norm) * max_norm)
                for g in updates]
    return _stateless(clip)


def masked(inner: Transform, mask: Sequence[bool]) -> Transform:
    """``inner`` on the leaves where ``mask`` is True; the others keep
    their incoming updates, as in ``optax.masked``."""
    keep = [i for i, m in enumerate(mask) if m]
    pick = lambda xs: [xs[i] for i in keep]

    def update(updates, state, params=None):
        outer = getattr(_SQUARES, "value", None)
        # the inner rule's leaves are the picked ones
        with _squares_as(outer and (outer[0], pick(outer[1]))):
            new, state = inner.update(pick(updates), state,
                                      None if params is None
                                      else pick(params))
        out = list(updates)
        for i, u in zip(keep, new):
            out[i] = u
        return out, state
    return Transform(lambda params: inner.init(pick(params)), update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """``optax.MultiSteps``: average ``every_k`` mini-step gradients and
    apply ``inner`` once on the k-th; the other mini-steps update by 0."""
    def init(params):
        return (0, inner.init(params), _zeros(params))

    def update(updates, state, params=None):
        mini_step, inner_state, acc = state
        acc = [a + (g - a) / (mini_step + 1) for g, a in zip(updates, acc)]
        if mini_step < every_k - 1:
            return _zeros(updates), (mini_step + 1, inner_state, acc)
        out, inner_state = inner.update(acc, inner_state, params)
        return out, (0, inner_state, _zeros(acc))
    return Transform(init, update)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))


def _trainable_mask(params: Dict[str, torch.Tensor]) -> List[bool]:
    """False for BatchNorm running ``stats`` leaves (by path), True for
    every other parameter."""
    return ["/stats/" not in f"/{path}/" for path in params]


def build_tx(spec: Any, params: Dict[str, torch.Tensor],
             learning_rate: Optional[float] = None, lr_schedule: Any = None,
             total_steps: Optional[int] = None,
             gradient_accumulation: int = 1,
             gradient_clip_norm: Optional[float] = None) -> Transform:
    """The update rule for ``params`` (path → tensor, in the JAX leaf
    order): optional global-norm clip → named optimizer (optionally
    LR-scheduled) → non-trainable masking → optional gradient accumulation
    (``gradient_accumulation`` mini-step gradients averaged per update)."""
    opt = get_optimizer(spec, learning_rate)
    if lr_schedule is not None:
        base = opt.hyper.get("learning_rate",
                             _DEFAULT_LR.get(opt.name, 0.01))
        opt = Optimizer(opt.name, **{
            **opt.hyper,
            "learning_rate": get_schedule(lr_schedule, base, total_steps)})
    inner = opt.to_transform()
    if gradient_clip_norm is not None:
        if gradient_clip_norm <= 0:
            raise ValueError(
                f"gradient_clip_norm must be > 0, got {gradient_clip_norm}")
        inner = chain(clip_by_global_norm(float(gradient_clip_norm)), inner)
    tx = masked(inner, _trainable_mask(params))
    k = int(gradient_accumulation)
    if k < 1:
        raise ValueError(f"gradient_accumulation must be >= 1, got {k}")
    if k > 1:
        tx = multi_steps(tx, k)
    return tx


def build(spec: Any, params: Dict[str, torch.Tensor],
          learning_rate: Optional[float] = None, lr_schedule: Any = None,
          total_steps: Optional[int] = None, gradient_accumulation: int = 1,
          gradient_clip_norm: Optional[float] = None):
    """(transformation, its initial state) for ``params``."""
    tx = build_tx(spec, params, learning_rate, lr_schedule, total_steps,
                  gradient_accumulation, gradient_clip_norm)
    return tx, tx.init(list(params.values()))
