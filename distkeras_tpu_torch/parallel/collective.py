"""Collectives over the axes of a :class:`~.mesh.Mesh`, the port's
counterpart of the ``jax.lax`` collectives that the JAX model-parallel
layer calls inside ``shard_map``: ``psum``, ``pmean``, ``all_gather``,
``all_to_all``, ``ppermute``, and ``pvary``; outside autograd, the
tiled reduce-scatter of FSDP's gradient (:func:`reduce_scatter_sum`) and
one rank's part of a ``ppermute`` step, the pipeline's transfer
(:func:`send_recv`).

Each is a ``torch.autograd.Function`` over ``torch.distributed`` whose
backward is stated here.  JAX derives the backward of a collective from
the varying-axes type of its operands; the port has no such types and
keeps one convention instead: **every rank seeds its loss with cotangent
1, a value that every rank of an axis holds alike carries the whole
cotangent on each of them, and a value that differs from rank to rank
carries its own part.**  Hence:

- ``psum`` (parts → a whole every rank holds): backward the identity.
  With ``pvary`` it is Megatron's pair: ``pvary`` is the identity forward
  with an all-reduce backward (where a value every rank holds enters a
  sharded product), ``psum`` the all-reduce forward with an identity
  backward (where the partial products leave it).
- ``pmean`` of parts: backward ``ct / n`` to each rank.
- tiled ``all_gather`` (parts → a whole every rank holds): backward this
  rank's slice of the cotangent.  A reduce-scatter there would count it n
  times.
- ``all_to_all`` and ``ppermute`` move parts: backward the inverse move.

What the convention leaves out is the gradient of a parameter that every
rank of an axis holds while each uses it on its own part (the batch over
'data', the sequence over 'seq', the MoE router over 'model'): the train
step sums those over their axes (``train_step.py``).

On an axis of size 1 every collective is the identity and touches no
process group.  Where the backend cannot take a CUDA tensor for an
operation, the tensor is staged through pinned host memory
(:func:`staged`): a rule about the backend, the operation and the
tensor's device, never a retry after a failure.  Each mesh counts, in
``mesh.comm_stats``, every operation's calls, the bytes this rank handed
to it and the host seconds it took (staging copies included).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .mesh import Mesh

Axes = Union[str, Sequence[str]]

#: the operations gloo runs on CUDA tensors (on the H100 machine's torch
#: 2.11, tools/gloo_device_ops.py: right answers on device memory, the
#: reduce-scatter in both its list and its tensor form); its send and
#: recv there abort the process on CUDA tensors, so ppermute and the
#: pipeline's transfers go through host memory
GLOO_DEVICE_OPS = frozenset({"all_reduce", "broadcast", "all_gather",
                             "all_to_all", "reduce_scatter"})

def _backend() -> str:
    import torch.distributed as dist
    return str(dist.get_backend()).lower()


def staged(op: str, backend: str, device: torch.device) -> bool:
    """Whether ``op`` on a tensor on ``device`` goes through pinned host
    memory under ``backend``: gloo takes device memory only for
    :data:`GLOO_DEVICE_OPS`; NCCL takes every operation on the card."""
    return (device.type == "cuda" and backend == "gloo"
            and op not in GLOO_DEVICE_OPS)


class _Run:
    """One operation on ``x``: the tensor the backend sees (a pinned host
    copy where :func:`staged` says so) and the way back to ``x``'s
    device, with the operation's calls, bytes and seconds counted in
    ``mesh.comm_stats``."""

    def __init__(self, op: str, x: torch.Tensor, mesh: Mesh):
        self.device = x.device
        self.t0 = time.perf_counter()
        self.stage = staged(op, _backend(), x.device)
        self.stats = s = mesh.comm_stats.setdefault(
            op, {"calls": 0, "bytes": 0, "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += x.numel() * x.element_size()
        x = x.contiguous()
        if self.stage:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            x = host.copy_(x)
        self.x = x

    def empty(self) -> torch.Tensor:
        """A buffer like the tensor the backend sees."""
        return torch.empty(self.x.shape, dtype=self.x.dtype,
                           device=self.x.device, pin_memory=self.stage)

    def back(self, y: torch.Tensor) -> torch.Tensor:
        if self.stage:
            y = y.to(self.device, non_blocking=True)
        self.stats["seconds"] += time.perf_counter() - self.t0
        return y


# -- the raw operations (no autograd) ------------------------------------------
def all_reduce_sum(x: torch.Tensor, axes: Axes,
                   mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, a new tensor."""
    if mesh is None or not mesh.sized_axes(axes):
        return x
    import torch.distributed as dist
    group = mesh.group(axes)  # binds the mesh to its process group
    run = _Run("all_reduce", x, mesh)
    y = run.x.clone() if run.x is x else run.x
    dist.all_reduce(y, group=group)
    return run.back(y)


def _all_gather(x: torch.Tensor, axis_name: str, dim: int,
                mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist
    n, group = mesh.shape[axis_name], mesh.group(axis_name)
    run = _Run("all_gather", x, mesh)
    parts = [run.empty() for _ in range(n)]
    dist.all_gather(parts, run.x, group=group)
    return run.back(torch.cat(parts, dim=dim))


def _all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
                concat_axis: int, mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist
    n, group = mesh.shape[axis_name], mesh.group(axis_name)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_axis))   # piece j goes to rank j
    run = _Run("all_to_all", send, mesh)
    recv = run.empty()
    dist.all_to_all_single(recv, run.x, group=group)
    recv = run.back(recv)
    return torch.cat(recv.unbind(0), dim=concat_axis)  # by source rank


def reduce_scatter_sum(x: torch.Tensor, axis_name: str, dim: int,
                       mesh: Optional[Mesh]) -> torch.Tensor:
    """The tiled reduce-scatter (``lax.psum_scatter(tiled=True)``): the
    sum of ``x`` over the ranks of ``axis_name``, cut into n equal parts
    along ``dim``, of which this rank keeps the part at its axis index.
    Outside autograd (FSDP's gradient, ``train_step.py``)."""
    if _trivial(mesh, axis_name):
        return x
    import torch.distributed as dist
    n, group = mesh.shape[axis_name], mesh.group(axis_name)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    pieces = x.chunk(n, dim=dim)                # piece j is rank j's sum
    # flat: the backend cuts the input into n runs along its first dim
    run = _Run("reduce_scatter", torch.stack(pieces).reshape(-1), mesh)
    out = torch.empty(run.x.numel() // n, dtype=run.x.dtype,
                      device=run.x.device, pin_memory=run.stage)
    dist.reduce_scatter_tensor(out, run.x, group=group)
    return run.back(out).view(pieces[0].shape)


def send_recv(x: Optional[torch.Tensor], axis_name: str,
              dst: Optional[int], src: Optional[int], like: torch.Tensor,
              mesh: Mesh, tag: int = 0) -> Optional[torch.Tensor]:
    """This rank's part of one ``ppermute`` step along ``axis_name``:
    ``x`` sent to axis position ``dst`` and a tensor shaped like ``like``
    received from ``src`` (either may be None: the pipeline's ends and
    its skipped bubble ticks), both posted before either is waited on.
    Returns what arrived, or None.  Counted as a ``ppermute`` call with
    the bytes sent; ``tag`` keeps each ring's messages apart."""
    if dst is None and src is None:
        return None
    import torch.distributed as dist
    t0 = time.perf_counter()
    stage = staged("ppermute", _backend(), like.device)
    stats = mesh.comm_stats.setdefault(
        "ppermute", {"calls": 0, "bytes": 0, "seconds": 0.0})
    stats["calls"] += 1
    works, out = [], None
    if dst is not None:
        buf = x.contiguous()
        stats["bytes"] += buf.numel() * buf.element_size()
        if stage:
            buf = torch.empty(buf.shape, dtype=buf.dtype,
                              pin_memory=True).copy_(buf)
        works.append(dist.isend(buf, mesh.rank_at(**{axis_name: dst}),
                                tag=tag))
    if src is not None:
        out = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if stage else like.device,
                          pin_memory=stage)
        works.append(dist.irecv(out, mesh.rank_at(**{axis_name: src}),
                                tag=tag))
    for work in works:
        work.wait()
    if out is not None and stage:
        out = out.to(like.device, non_blocking=True)
    stats["seconds"] += time.perf_counter() - t0
    return out


def _ppermute(x: torch.Tensor, axis_name: str,
              perm: Sequence[Tuple[int, int]], mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist
    me = mesh.axis_index(axis_name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    run = _Run("ppermute", x, mesh)
    out = run.empty()
    ops = ([dist.isend(run.x, mesh.rank_at(**{axis_name: dst[0]}))]
           if dst else [])
    if src:
        ops.append(dist.irecv(out, mesh.rank_at(**{axis_name: src[0]})))
    for op in ops:
        op.wait()
    y = run.back(out)
    return y if src else torch.zeros_like(x)  # no source: zeros, as JAX


# -- the differentiable collectives --------------------------------------------
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce_sum(x, axes, mesh)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        n = 1
        for a in mesh.sized_axes(axes):
            n *= mesh.shape[a]
        ctx.n = n
        return all_reduce_sum(x, axes, mesh) / n

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ct, ctx.axes, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim, mesh):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.idx = mesh.axis_index(axis_name)
        return _all_gather(x, axis_name, dim, mesh)

    @staticmethod
    def backward(ctx, ct):
        return (ct.narrow(ctx.dim, ctx.idx * ctx.n, ctx.n), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, mesh):
        ctx.args = (axis_name, concat_axis, split_axis, mesh)
        return _all_to_all(x, axis_name, split_axis, concat_axis, mesh)

    @staticmethod
    def backward(ctx, ct):
        return (_all_to_all(ct, *ctx.args), None, None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm, mesh):
        ctx.args = (axis_name, [(d, s) for s, d in perm], mesh)
        return _ppermute(x, axis_name, perm, mesh)

    @staticmethod
    def backward(ctx, ct):
        return _ppermute(ct, *ctx.args), None, None, None


def _trivial(mesh: Optional[Mesh], axes: Axes) -> bool:
    return mesh is None or not mesh.sized_axes(axes)


def psum(x: torch.Tensor, axes: Axes,
         mesh: Optional[Mesh]) -> torch.Tensor:
    """``lax.psum``: the sum over the ranks of ``axes``, which every one
    of them then holds; backward the identity."""
    return x if _trivial(mesh, axes) else _Psum.apply(x, axes, mesh)


def pmean(x: torch.Tensor, axes: Axes,
          mesh: Optional[Mesh]) -> torch.Tensor:
    """``lax.pmean`` of each rank's part; backward ``ct / n``."""
    return x if _trivial(mesh, axes) else _Pmean.apply(x, axes, mesh)


def pvary(x: torch.Tensor, axes: Axes,
          mesh: Optional[Mesh]) -> torch.Tensor:
    """``lax.pvary``: ``x``, held alike by the ranks of ``axes``, used by
    each on its own part; the identity forward, its backward the sum of
    the ranks' cotangents."""
    return x if _trivial(mesh, axes) else _Pvary.apply(x, axes, mesh)


def all_gather(x: torch.Tensor, axis_name: str, mesh: Optional[Mesh],
               axis: int = 0) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: the ranks' ``x`` concatenated along
    ``axis`` in axis order; backward this rank's slice."""
    if _trivial(mesh, axis_name):
        return x
    return _AllGather.apply(x, axis_name, axis, mesh)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``x`` split in n along
    ``split_axis``, piece j sent to rank j, the pieces received
    concatenated along ``concat_axis`` by source rank; backward the
    inverse.  (The JAX ``tiled=False`` call with ``split_axis ==
    concat_axis == 0`` on a leading axis of size n is this one.)"""
    if _trivial(mesh, axis_name):
        return x
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis, mesh)


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]],
             mesh: Optional[Mesh]) -> torch.Tensor:
    """``lax.ppermute``: rank ``s`` of the axis sends ``x`` to ``d`` for
    each ``(s, d)`` of ``perm``; a rank that receives nothing gets zeros;
    backward the inverse permutation."""
    if _trivial(mesh, axis_name):
        return x
    return _Ppermute.apply(x, axis_name, [tuple(p) for p in perm], mesh)


def gather_leaf(x: torch.Tensor, axis_name: str, dim: int,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """The tiled ``all_gather`` of a tensor outside autograd (shards of a
    parameter or a gradient back into the whole)."""
    if _trivial(mesh, axis_name):
        return x
    with torch.no_grad():
        return _all_gather(x.detach(), axis_name, dim, mesh)


__all__: List[str] = ["psum", "pmean", "pvary", "all_gather", "all_to_all",
                      "ppermute", "all_reduce_sum", "reduce_scatter_sum",
                      "send_recv", "gather_leaf", "staged",
                      "GLOO_DEVICE_OPS"]
