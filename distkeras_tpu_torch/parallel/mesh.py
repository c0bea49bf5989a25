"""The device meshes of the port, counterpart of the part of
``distkeras_tpu/parallel/mesh.py`` that one card needs.

:class:`Mesh` is the counterpart of ``jax.sharding.Mesh``: an array of
devices with one axis name per dimension, whose ``shape`` maps each name
to its size.  The port runs the model-parallel programs on one card, where
every mesh axis has size 1 and every collective over it is the identity:
:func:`collective` is that identity, and raises for an axis of any other
size.

:func:`get_mesh` builds the 1-D worker mesh of the distributed trainers
(axis :data:`WORKER_AXIS`): one worker per visible card by default.  An
explicit ``devices`` list may name one device N times, the port's
counterpart of ``--xla_force_host_platform_device_count``: the SPMD engine
runs such a mesh as N workers on that one device (:func:`worker_device`).
Collectives across cards (``torch.distributed``), the worker mesh across
cards, ``initialize`` and the placement helpers (``replicated``,
``worker_sharded``, ``put_*``) wait for ROADMAP queue A item 7.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

#: the axes of ParallelTransformerLM's mesh, in the JAX package's order
LM_AXES = ("data", "seq", "model")
#: the one axis of the distributed trainers' mesh
WORKER_AXIS = "workers"


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

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The mesh's one device (the port's programs run on one card)."""
        if self.size != 1:
            raise NotImplementedError(
                f"a mesh of {self.size} devices: programs across cards are "
                "not ported yet (ROADMAP queue A item 7)")
        return self.devices.flat[0]


def axis_size(mesh: Optional[Mesh], axis_name: str) -> int:
    """The size of ``axis_name`` (1 without a mesh: a one-device program)."""
    return 1 if mesh is None else mesh.shape[axis_name]


def collective(name: str, x, axis_names: Union[str, Sequence[str]],
               mesh: Optional[Mesh]):
    """A collective (``psum``, ``all_to_all``, ``ppermute``...) of ``x``
    over ``axis_names``: the identity where each axis has size 1; any
    other size raises."""
    names = (axis_names,) if isinstance(axis_names, str) else axis_names
    for axis in names:
        n = axis_size(mesh, axis)
        if n != 1:
            raise NotImplementedError(
                f"{name} over mesh axis {axis!r} of size {n}: collectives "
                "across cards are not ported yet (ROADMAP queue A item 7)")
    return x


def get_mesh(num_workers: Optional[int] = None,
             axis_name: str = WORKER_AXIS,
             devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D data-parallel mesh over ``num_workers`` devices.

    ``devices`` defaults to every visible CUDA card (none raises: the port
    never drops to the CPU); ``num_workers`` defaults to all of them.
    Fewer workers than devices is allowed; more raises.  Pass ``devices``
    to run several workers on one device, e.g. ``get_mesh(8,
    devices=["cpu"] * 8)``."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
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


def worker_device(mesh: Mesh) -> torch.device:
    """The one device on which every worker of a worker mesh runs; a mesh
    whose workers sit on distinct devices raises."""
    devs = list(mesh.devices.flat)
    if not all(same_device(d, devs[0]) for d in devs[1:]):
        raise NotImplementedError(
            f"a worker mesh over distinct devices {devs}: the SPMD engine "
            "across cards is not ported yet (ROADMAP queue A item 7)")
    return devs[0]
