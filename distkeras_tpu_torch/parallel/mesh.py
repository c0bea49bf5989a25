"""The device meshes of the port, counterpart of
``distkeras_tpu/parallel/mesh.py`` (``initialize``, ``get_mesh``, the
placement helpers ``replicated``, ``worker_sharded``, ``put_replicated``,
``put_worker_sharded``) and of ``jax.sharding.Mesh``.

:class:`Mesh` is an array of devices with one axis name per dimension,
whose ``shape`` maps each name to its size.  A JAX program runs one
process over every device of its mesh; the port runs one process per mesh
position, a *rank* of a ``torch.distributed`` process group
(:func:`initialize`), which holds its own shard of the parameters and
calls the collectives of ``collective.py`` explicitly.  Rank ``r`` sits
at ``np.unravel_index(r, shape)``: the order of
``Mesh(np.array(devs).reshape(shape), axes)``, so a rank's shards are the
JAX mesh's shards at the same position.  A mesh of one device needs no
process group, and every collective over it is the identity.

A mesh of more than one entry binds to the process group the first time a
rank asks for its position (:meth:`Mesh.rank`, :meth:`Mesh.device`,
:meth:`Mesh.axis_index`, :meth:`Mesh.group`): the group's world size must
be the mesh's size, each entry names the device of the rank at that
position, and every rank then creates the subgroups of every set of axes
in one fixed order (``new_group`` is collective).  Two ranks on one CUDA
device cannot run NCCL: such a mesh under ``"nccl"`` raises before any
collective, naming ``backend="gloo"``.

:func:`get_mesh` builds the 1-D worker mesh of the distributed trainers
(axis :data:`WORKER_AXIS`).  Without ``devices`` it is one worker per
rank of the initialized process group, rank ``r`` on card ``r %
device_count`` (on a one-card machine every rank shares ``cuda:0``), and
without a group one worker per visible card.  An explicit ``devices``
list may name one device N times, the port's counterpart of
``--xla_force_host_platform_device_count``.

The rule that picks how a worker mesh runs (:func:`across_ranks`,
:func:`worker_device`, :func:`local_workers`):
 - across ranks, one worker a rank, when a process group is initialized
   and its world size equals the mesh's size;
 - otherwise a mesh that repeats one device runs its N workers one after
   another in this process (never bound to a group);
 - a mesh over distinct devices without such a group raises: start one
   process a worker and call :func:`initialize` (or
   ``job_deployment.initialize_from_env``) in each.

A :class:`Placement` says where a leaf goes on a worker mesh, as
``NamedSharding`` over ``P()`` (:func:`replicated`: the whole array on
this process's device) or over ``P(..., 'workers')``
(:func:`worker_sharded`: across ranks this rank's part of that axis,
kept as an axis, the block JAX's ``shard_map`` hands the position; in
one process every worker's part, i.e. the whole array).
"""

from __future__ import annotations

import atexit
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, host_to_device, resolve_device
from .rules import tmap

#: the axes of ParallelTransformerLM's mesh, in the JAX package's order
LM_AXES = ("data", "seq", "model")
#: the one axis of the distributed trainers' mesh
WORKER_AXIS = "workers"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the group of ``num_processes`` ranks whose
    rank 0 listens at ``coordinator_address`` (``host:port``), as rank
    ``process_id``: ``torch.distributed.init_process_group`` over TCP.
    ``backend`` defaults to ``"nccl"`` where a CUDA device is visible and
    to ``"gloo"`` on the CPU.  Without an address it does nothing (a
    one-process run), as the JAX ``initialize`` does."""
    if coordinator_address is None:
        return
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    atexit.register(_leave_group)


def _leave_group() -> None:
    """Destroy the process group before the interpreter exits, as the JAX
    ``initialize`` shuts its client down: a gloo group still alive at exit
    is torn down with its threads running, which can abort the process
    ("terminate called without an active exception")."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def check_backend(backend: str, devices: Sequence[torch.device]) -> None:
    """The rule about a mesh and its backend: NCCL runs one rank a CUDA
    device, so a mesh that places two ranks on one CUDA device under
    ``"nccl"`` raises (one card's ranks run over ``"gloo"``)."""
    if str(backend).lower() != "nccl":
        return
    seen = set()
    for dev in devices:
        if dev.type != "cuda":
            continue
        key = dev.index if dev.index is not None else 0
        if key in seen:
            raise ValueError(
                f"mesh places two ranks on {dev} under backend 'nccl', "
                "which runs one rank a CUDA device; initialize the group "
                "with backend=\"gloo\" to run several ranks on one card")
        seen.add(key)


class Mesh:
    """Devices laid out on named axes.

    ``devices``: an array (any nesting of lists) of devices or device
    names, one dimension per axis name; ``None`` is the one default device
    (``cuda``, which raises without a card) on every axis."""

    def __init__(self, devices: Optional[Union[np.ndarray, Sequence]] = None,
                 axis_names: Sequence[str] = LM_AXES,
                 device: DeviceLike = None):
        self.axis_names = tuple(axis_names)
        if devices is None:
            devices = np.empty((1,) * len(self.axis_names), dtype=object)
            devices.flat[0] = resolve_device(device)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {arr.ndim} dims for axis names "
                             f"{self.axis_names}")
        self.devices = np.vectorize(resolve_device, otypes=[object])(arr)
        self._rank: Optional[int] = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        #: per collective over this mesh: calls, bytes this rank handed to
        #: it, host seconds (``collective.py``)
        self.comm_stats: Dict[str, Dict[str, float]] = {}

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    # -- this rank's place -----------------------------------------------------
    def _bind(self) -> int:
        if self._rank is not None:
            return self._rank
        if self.size == 1:
            self._rank = 0
            return 0
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a mesh of {self.size} devices runs one rank a position "
                f"over torch.distributed: start {self.size} processes and "
                "call parallel.mesh.initialize (or job_deployment."
                "initialize_from_env) in each before using it")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a mesh of {self.size} devices needs a "
                             f"process group of {self.size} ranks, got "
                             f"{world}")
        check_backend(dist.get_backend(), list(self.devices.flat))
        rank = dist.get_rank()
        # every rank creates every subgroup, in one order
        sized = [a for a in self.axis_names if self.shape[a] > 1]
        ranks = np.arange(self.size).reshape(self.devices.shape)
        for k in range(1, len(sized) + 1):
            for axes in itertools.combinations(sized, k):
                if k == len(sized):
                    self._groups[axes] = None  # the whole group
                    continue
                keep = [self.axis_names.index(a) for a in axes]
                moved = np.moveaxis(ranks, keep, list(range(len(keep))))
                members = moved.reshape(-1, moved[(0,) * len(keep)].size)
                for col in members.T:
                    group = dist.new_group(sorted(int(r) for r in col))
                    if rank in col:
                        self._groups[axes] = group
        self._rank = rank
        return rank

    @property
    def rank(self) -> int:
        """This process's rank (0 on a mesh of one device)."""
        return self._bind()

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's position, one index per axis."""
        return tuple(int(i) for i in
                     np.unravel_index(self.rank, self.devices.shape))

    def axis_index(self, axis_name: str) -> int:
        """This rank's index along ``axis_name`` (``lax.axis_index``)."""
        if self.shape[axis_name] == 1:
            return 0
        return self.coords[self.axis_names.index(axis_name)]

    def sized_axes(self, axis_names: Union[str, Sequence[str]]
                   ) -> Tuple[str, ...]:
        """``axis_names`` without the axes of size 1, in mesh order."""
        names = ((axis_names,) if isinstance(axis_names, str)
                 else tuple(axis_names))
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh axes "
                                 f"{self.axis_names}")
        return tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)

    def group(self, axis_names: Union[str, Sequence[str]]):
        """The process group of the ranks that share this rank's place on
        every axis but ``axis_names`` (``None``: the whole group, or no
        group where every axis of ``axis_names`` has size 1); its ranks in
        group order are the axes' positions in row-major order."""
        axes = self.sized_axes(axis_names)
        self._bind()
        return self._groups[axes] if axes else None

    def rank_at(self, **coords: int) -> int:
        """The rank at this rank's place with the given axes moved."""
        pos = list(self.coords)
        for a, i in coords.items():
            pos[self.axis_names.index(a)] = int(i)
        return int(np.ravel_multi_index(pos, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """This rank's device: the mesh's entry at its position."""
        return self.devices.flat[self.rank]


def axis_size(mesh: Optional[Mesh], axis_name: str) -> int:
    """The size of ``axis_name`` (1 without a mesh: a one-device program)."""
    return 1 if mesh is None else mesh.shape[axis_name]


def axis_index(mesh: Optional[Mesh], axis_name: str) -> int:
    """This rank's index along ``axis_name`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.axis_index(axis_name)


def group_size() -> int:
    """The world size of this process's ``torch.distributed`` group (0
    without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def get_mesh(num_workers: Optional[int] = None,
             axis_name: str = WORKER_AXIS,
             devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D data-parallel mesh over ``num_workers`` devices.

    ``devices`` defaults, in a process group of more than one rank, to
    one entry a rank (rank ``r`` on ``cuda:(r % device_count)``), and
    otherwise to every visible CUDA card (none raises: the port never
    drops to the CPU); ``num_workers`` defaults to all of them.  Fewer
    workers than devices is allowed; more raises.  Pass ``devices`` to run
    several workers on one device, e.g. ``get_mesh(8,
    devices=["cpu"] * 8)``."""
    if devices is None:
        resolve_device("cuda")
        count, world = torch.cuda.device_count(), group_size()
        devices = ([torch.device("cuda", r % count) for r in range(world)]
                   if world > 1 else
                   [torch.device("cuda", i) for i in range(count)])
    devs = list(devices)
    n = num_workers or len(devs)
    if n > len(devs):
        raise ValueError(
            f"num_workers={n} exceeds the mesh's devices ({len(devs)}); to "
            f"run {n} workers on one device pass "
            f"get_mesh({n}, devices=[device] * {n})")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr, (axis_name,))


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` and ``cuda:0`` are, when card
    0 is the current one)."""
    index = lambda d: (d.index if d.index is not None
                       else torch.cuda.current_device()
                       if d.type == "cuda" else None)
    return a.type == b.type and index(a) == index(b)


def across_ranks(mesh: Mesh) -> bool:
    """Whether the workers of ``mesh`` run one a rank: a mesh of more than
    one entry in a process group of exactly its size."""
    return mesh.size > 1 and group_size() == mesh.size


def worker_device(mesh: Mesh) -> torch.device:
    """The device of this process's workers: across ranks this rank's
    entry; otherwise the one device a repeated-device mesh names.  A mesh
    over distinct devices without a process group of its size raises."""
    if across_ranks(mesh):
        return mesh.device
    devs = list(mesh.devices.flat)
    if not all(same_device(d, devs[0]) for d in devs[1:]):
        raise RuntimeError(
            f"a worker mesh over distinct devices {devs} runs one worker a "
            f"rank: start {mesh.size} processes and call parallel.mesh."
            "initialize (or job_deployment.initialize_from_env) in each, "
            f"with a world size of {mesh.size}, before building it")
    return devs[0]


def local_workers(mesh: Mesh) -> List[int]:
    """The workers this process runs, by index on the worker axis: its
    rank's across ranks, all of them in one process."""
    worker_device(mesh)
    return [mesh.rank] if across_ranks(mesh) else list(range(mesh.size))


class Placement:
    """Where a leaf goes on a worker mesh: the counterpart of a
    ``NamedSharding`` over ``P()`` (``axis`` None) or over ``P(None, ...,
    'workers')`` with the worker axis at dim ``axis``."""

    def __init__(self, mesh: Mesh, axis: Optional[int] = None):
        self.mesh, self.axis = mesh, axis

    def __repr__(self) -> str:
        return f"Placement(axis={self.axis}, mesh={dict(self.mesh.shape)})"

    def place(self, a, non_blocking: bool = False) -> torch.Tensor:
        """``a`` (a host array or a tensor) on this process's device: whole
        when replicated or in one process, else this rank's part of dim
        ``axis`` (an equal split in mesh order, the dim kept)."""
        dev = worker_device(self.mesh)
        if self.axis is not None and across_ranks(self.mesh):
            n, size = self.mesh.size, a.shape[self.axis]
            if size % n:
                raise ValueError(f"dim {self.axis} of {tuple(a.shape)} does "
                                 f"not split over {n} workers")
            part, r = size // n, self.mesh.rank
            a = a[(slice(None),) * self.axis
                  + (slice(r * part, (r + 1) * part),)]
        return host_to_device(a, dev, non_blocking=non_blocking)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh)


def worker_sharded(mesh: Mesh, axis: int = 0) -> Placement:
    return Placement(mesh, axis)


def put_replicated(tree, mesh: Mesh):
    """Place a tree (dicts, lists, tuples of arrays) replicated across the
    mesh: the whole of every leaf on this process's device."""
    s = replicated(mesh)
    return tmap(s.place, tree)


def put_worker_sharded(tree, mesh: Mesh):
    """Place a tree whose leaves have a leading 'workers' axis: across
    ranks this rank's slice (a leading axis of 1), in one process the
    whole leaf."""
    s = worker_sharded(mesh)
    return tmap(s.place, tree)
