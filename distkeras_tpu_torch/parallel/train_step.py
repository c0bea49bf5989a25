"""The model-parallel train step, port of
``distkeras_tpu/parallel/train_step.py``.

The JAX step is ``value_and_grad`` of the model's loss, the optax update
and ``apply_updates``, jitted under ``shard_map``, where JAX inserts the
gradient reductions of replicated parameters itself.  Here each rank
takes ``torch.autograd.grad`` over its shards (or the model's own
``loss_and_grads``, the 1F1B pipeline's hand-built backward), sums each
gradient over the axes that ``grad_axes`` names for its parameter (one
all-reduce per set of axes, over the gradients flattened together), and
runs the update rule (a ``core.optimizers.Transform``, e.g.
``core.optimizers.adam``) in place on its shards, as ``core/train.py``
does.

ZeRO-1 (``zero_axis``) and FSDP (``fsdp_axis``) slice each leaf once
more over the data axis, by the rule of :func:`shard_specs_over_axis`:
the first dim that the leaf's spec leaves unsharded and that the axis
size divides.  JAX states them as sharding annotations and lets GSPMD
place the collectives; here they are explicit:

- ZeRO-1: the gradients as in the plain step; each data rank then runs
  the rule on its slice of every gradient, parameter and moment (a leaf
  with no such dim whole, alike on every data rank) and all-gathers the
  updated slices over the data axis into its parameters, in place, in
  one collective.  The moments hold 1/dp of each sliced leaf.
- FSDP (supersedes ``zero_axis``): the parameters rest as their slices.
  A step all-gathers them into this rank's full local shards (one
  collective), takes the gradients there, sums each over its other axes
  and reduce-scatters it over the data axis (one collective), and runs
  the rule on the slices it owns, the moments in the same layout.  As in
  JAX, the first call takes the parameters in the full local layout and
  leaves them sliced: each tensor's data is replaced in the same dict.

JAX runs the plain step's update on local shards inside ``shard_map``,
and the ZeRO and FSDP updates under plain ``jit`` on the logical whole
tensors.  The port follows: under ZeRO and FSDP the rules that take
norms (global-norm clipping, the trust ratio) sum each leaf's squares
over the ranks that hold its slices (``core.optimizers.mesh_squares``);
the plain step's norms are those of the local shards.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import optimizers as opt_lib
from .collective import all_reduce_sum, gather_leaf, reduce_scatter_sum
from .mesh import Mesh

#: a PartitionSpec as a plain tuple: one entry per leading dim, a mesh
#: axis name, a tuple of names or None (missing trailing entries: None)
Spec = Tuple


def reduce_grads(grads: List[torch.Tensor], axes: Sequence[Sequence[str]],
                 mesh: Mesh) -> List[torch.Tensor]:
    """Each gradient summed over its axes (``axes[i]`` for ``grads[i]``):
    the gradients of one set of axes flattened into one buffer and
    all-reduced once, in the order of their first appearance."""
    out = list(grads)
    sets: Dict[tuple, List[int]] = {}
    for i, a in enumerate(axes):
        key = mesh.sized_axes(a)
        if key:
            sets.setdefault(key, []).append(i)
    for key, idx in sets.items():
        flat = all_reduce_sum(torch.cat([grads[i].reshape(-1) for i in idx]),
                              key, mesh)
        for i, g in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = g.view_as(grads[i])
    return out


# -- the spec rules --------------------------------------------------------------
def _is_shape(x: Any) -> bool:
    return (hasattr(x, "shape") or isinstance(x, torch.Size)
            or (isinstance(x, tuple) and len(x) > 0
                and all(isinstance(i, int) for i in x)))


def _map_specs(fn: Callable[[Spec, Tuple[int, ...]], Spec], specs: Any,
               shapes: Any) -> Any:
    """``fn(spec, shape)`` at every leaf of ``shapes`` (objects with a
    ``.shape``, tuples of ints, or Python scalars), with the spec at the
    same place of ``specs``, in the structure of ``shapes``."""
    if isinstance(shapes, dict):
        return {k: _map_specs(fn, specs[k], v) for k, v in shapes.items()}
    if _is_shape(shapes) or isinstance(shapes, (int, float)):
        shape = (tuple(shapes.shape) if hasattr(shapes, "shape")
                 else () if isinstance(shapes, (int, float))
                 else tuple(shapes))
        return fn(tuple(specs), shape)
    return type(shapes)(_map_specs(fn, s, x) for s, x in zip(specs, shapes))


def _spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec names, in its order."""
    out: List[str] = []
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and a not in out:
                out.append(a)
    return tuple(out)


def shard_specs_over_axis(specs: Any, shapes: Any, mesh: Mesh,
                          axis: str) -> Any:
    """Partition each leaf's spec over ``axis`` where a dim allows it.

    For every leaf, the first dim that is (a) unsharded in the inherited
    spec and (b) divisible by the axis size takes ``axis``; a leaf with
    no such dim (scalars, odd shapes), or already partitioned over
    ``axis``, keeps its spec, with no error.  ``shapes`` mirrors
    ``specs`` (tensors, meta tensors, or shapes as tuples of ints) and
    holds the logical (global) shapes."""
    n_shards = mesh.shape[axis]

    def shard_leaf(spec: Spec, shape: Tuple[int, ...]) -> Spec:
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if axis in _spec_axes(entries):
            return spec  # already partitioned over this axis
        for i, (e, n) in enumerate(zip(entries, shape)):
            if e is None and n % n_shards == 0 and n > 0:
                entries[i] = axis
                return tuple(entries)
        return spec

    return _map_specs(shard_leaf, specs, shapes)


def zero_shard_specs(opt_specs: Any, opt_shapes: Any, mesh: Mesh,
                     zero_axis: str) -> Any:
    """ZeRO-1: partition each optimizer-state leaf's spec over
    ``zero_axis`` (the rule of :func:`shard_specs_over_axis`)."""
    return shard_specs_over_axis(opt_specs, opt_shapes, mesh, zero_axis)


def opt_partition_specs(optimizer: opt_lib.Transform,
                        params: Dict[str, torch.Tensor],
                        param_specs: Dict[str, Spec]) -> Tuple[Any, Any]:
    """(specs, shapes) of ``optimizer``'s state over ``params`` (logical
    shapes), in the state's structure: the state of a ``Transform`` holds
    its moments as lists in the parameters' order, so a list whose
    tensors have the parameters' shapes, one for one, inherits their
    specs; every other leaf (step counters, scalars) replicates.  The
    shapes are meta tensors, counters included (as 0-d)."""
    plist = list(params.values())
    specs = [tuple(param_specs.get(n, ())) for n in params]
    state = optimizer.init([torch.empty(tuple(p.shape), dtype=p.dtype,
                                        device="meta") for p in plist])
    want = [tuple(p.shape) for p in plist]

    def walk(x):
        if isinstance(x, torch.Tensor):
            return (), x
        if isinstance(x, (int, float)):
            return (), torch.empty((), device="meta")
        if isinstance(x, dict):
            pairs = {k: walk(v) for k, v in x.items()}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if (isinstance(x, list) and len(x) == len(plist)
                and all(isinstance(t, torch.Tensor) for t in x)
                and [tuple(t.shape) for t in x] == want):
            return list(specs), list(x)
        pairs = [walk(v) for v in x]
        return (type(x)(p[0] for p in pairs), type(x)(p[1] for p in pairs))

    return walk(state)


# -- the slices of ZeRO and FSDP -------------------------------------------------
def _added_dim(spec: Spec, sharded: Spec, axis: str) -> Optional[int]:
    """The dim at which ``sharded`` adds ``axis`` to ``spec``, or None."""
    if axis in _spec_axes(spec):
        return None
    for i, e in enumerate(sharded):
        if e == axis:
            return i
    return None


class _Slices:
    """Each leaf's slice over ``axis`` at this rank's index (``dims[i]``
    the sliced dim, None: the leaf whole)."""

    def __init__(self, dims: List[Optional[int]], axis: str, mesh: Mesh):
        self.n = mesh.shape[axis]
        # on an axis of size 1 every slice is the whole leaf
        self.dims = dims if self.n > 1 else [None] * len(dims)
        self.axis, self.mesh = axis, mesh
        self.idx = mesh.axis_index(axis)

    def part(self, t: torch.Tensor, i: int) -> torch.Tensor:
        d = self.dims[i]
        if d is None:
            return t
        size = t.shape[d] // self.n
        return t.narrow(d, self.idx * size, size)

    def sliced(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d is not None]

    def gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sliced leaves' parts, all-gathered whole over the axis in
        one collective (the others as they are)."""
        idx = self.sliced()
        out = list(parts)
        if not idx:
            return out
        flat = torch.cat([parts[i].reshape(-1) for i in idx])
        every = gather_leaf(flat, self.axis, 0, self.mesh).view(self.n, -1)
        for i, piece in zip(idx, every.split([parts[i].numel()
                                              for i in idx], dim=1)):
            pieces = piece.reshape((self.n,) + tuple(parts[i].shape))
            out[i] = torch.cat(pieces.unbind(0), dim=self.dims[i])
        return out

    def scatter(self, grads: List[torch.Tensor],
                summed: List[bool]) -> List[torch.Tensor]:
        """Each sliced leaf's gradient cut to this rank's slice: summed
        over the axis first where ``summed[i]`` (one reduce-scatter for
        them all), else its own slice."""
        out = [self.part(g, i) for i, g in enumerate(grads)]
        idx = [i for i in self.sliced() if summed[i]]
        if not idx:
            return out
        rows = torch.cat([torch.stack(grads[i].chunk(self.n, self.dims[i]))
                          .reshape(self.n, -1) for i in idx], dim=1)
        mine = reduce_scatter_sum(rows, self.axis, 0, self.mesh).reshape(-1)
        for i, g in zip(idx, mine.split([out[i].numel() for i in idx])):
            out[i] = g.view(out[i].shape)
        return out


def _mesh_reduce(leaf_axes: List[Tuple[str, ...]], mesh: Mesh):
    """The ``reduce`` of ``core.optimizers.mesh_squares``: each leaf's sum
    of squares summed over the axes it is partitioned over (the sums of
    one set of axes stacked into one all-reduce)."""
    def reduce(squares: List[torch.Tensor],
               positions: List[int]) -> List[torch.Tensor]:
        return reduce_grads(squares, [leaf_axes[p] for p in positions],
                            mesh)
    return reduce


def build_train_step(mesh: Mesh, local_loss: Callable,
                     optimizer: opt_lib.Transform,
                     params: Dict[str, torch.Tensor],
                     zero_axis: Optional[str] = None,
                     fsdp_axis: Optional[str] = None,
                     grad_axes: Optional[Dict[str, Sequence[str]]] = None,
                     param_specs: Optional[Dict[str, Spec]] = None,
                     loss_and_grads: Optional[Callable] = None):
    """(opt_state, step): ``step(params, opt_state, tokens, labels) ->
    (params, opt_state, loss)``.

    ``local_loss(params, tokens, labels)`` is the model's scalar loss on
    this rank; ``params`` a name → tensor dict of this rank's shards to
    train, updated in place by every step (the returned dict is the same
    object); ``grad_axes`` the axes over which each parameter's gradient
    is summed (none: no sum); ``param_specs`` each parameter's spec (a
    plain tuple; none: replicated), which ZeRO and FSDP slice further.
    ``loss_and_grads(params, tokens, labels) -> (loss, gradients in the
    order of params)`` supplies the gradients another way than
    ``torch.autograd.grad`` of ``local_loss`` (the 1F1B pipeline's
    backward); they are summed by ``grad_axes`` all the same.  The loss
    comes back detached, on the device: a step waits for nothing on the
    host."""
    if fsdp_axis is not None:
        if fsdp_axis not in mesh.shape:
            raise ValueError(f"fsdp_axis {fsdp_axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        mode, axis = "fsdp", fsdp_axis
    elif zero_axis is not None:
        if zero_axis not in mesh.shape:
            raise ValueError(f"zero_axis {zero_axis!r} not in mesh axes "
                             f"{tuple(mesh.shape)}")
        mode, axis = "zero", zero_axis
    else:
        mode, axis = "plain", None
    if loss_and_grads is None:
        def loss_and_grads(params, tokens, labels):
            loss = local_loss(params, tokens, labels)
            # a parameter the loss does not reach on this rank (the head
            # before the last pipeline stage) gets a zero gradient
            return loss, list(torch.autograd.grad(
                loss, list(params.values()), allow_unused=True,
                materialize_grads=True))
    names = list(params)
    axes = [tuple((grad_axes or {}).get(n, ())) for n in names]

    if mode == "plain":
        opt_state = optimizer.init(list(params.values()))

        def step(params, opt_state, tokens, labels):
            plist = list(params.values())
            loss, grads = loss_and_grads(params, tokens, labels)
            grads = reduce_grads(list(grads), axes, mesh)
            with torch.no_grad():
                updates, opt_state = optimizer.update(list(grads), opt_state,
                                                      plist)
                opt_lib.apply_updates(plist, updates)
            return params, opt_state, loss.detach()

        return opt_state, step

    # the logical shapes: this rank's shards times the sizes of their axes
    specs = [tuple((param_specs or {}).get(n, ())) for n in names]
    full = {}
    for n, sp, p in zip(names, specs, params.values()):
        shape = list(p.shape)
        for d, e in enumerate(sp):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    shape[d] *= mesh.shape[a]
        full[n] = tuple(shape)
    sharded = shard_specs_over_axis(dict(zip(names, specs)), full, mesh, axis)
    slices = _Slices([_added_dim(sp, sharded[n], axis)
                      for n, sp in zip(names, specs)], axis, mesh)
    # the axes each leaf's slice is partitioned over, for the rule's norms
    squares = _mesh_reduce([_spec_axes(sharded[n]) for n in names], mesh)
    local = [tuple(p.shape) for p in params.values()]
    opt_state = optimizer.init([slices.part(p.detach(), i)
                                for i, p in enumerate(params.values())])

    def update(parts: List[torch.Tensor], grads: List[torch.Tensor],
               opt_state):
        with torch.no_grad(), opt_lib.mesh_squares(squares, len(parts)):
            updates, opt_state = optimizer.update(grads, opt_state, parts)
            opt_lib.apply_updates(parts, updates)
        return opt_state

    if mode == "zero":
        def zero_step(params, opt_state, tokens, labels):
            plist = list(params.values())
            loss, grads = loss_and_grads(params, tokens, labels)
            grads = reduce_grads(list(grads), axes, mesh)
            parts = [slices.part(p, i) for i, p in enumerate(plist)]
            opt_state = update(parts, [slices.part(g, i) for i, g in
                                       enumerate(grads)], opt_state)
            with torch.no_grad():  # the updated slices back into place
                for p, whole in zip(plist, slices.gather(
                        [t.contiguous() for t in parts])):
                    if whole is not p:
                        p.copy_(whole)
            return params, opt_state, loss.detach()

        return opt_state, zero_step

    # FSDP: over the data axis the gradient is reduce-scattered, not
    # all-reduced; a leaf left whole is all-reduced with its other axes
    other = [tuple(a for a in ax if a != axis)
             if slices.dims[i] is not None else ax
             for i, ax in enumerate(axes)]
    summed = [axis in mesh.sized_axes(ax) for ax in axes]

    def fsdp_step(params, opt_state, tokens, labels):
        plist = list(params.values())
        with torch.no_grad():
            for i, p in enumerate(plist):
                if tuple(p.shape) == local[i] and slices.dims[i] is not None:
                    p.data = slices.part(p.data, i).clone()  # to rest
            wholes = slices.gather([p.detach() for p in plist])
        leaves = [w.requires_grad_() for w in wholes]
        loss, grads = loss_and_grads(dict(zip(names, leaves)), tokens,
                                     labels)
        grads = slices.scatter(reduce_grads(list(grads), other, mesh),
                               summed)
        opt_state = update(plist, grads, opt_state)
        return params, opt_state, loss.detach()

    return opt_state, fsdp_step
