"""Socket transport, a copy of ``distkeras_tpu/networking.py`` (numpy
only, kept in the port so that it imports nothing of the JAX package).

It keeps the JAX module's wire byte for byte (its frames, opcodes,
``KVBlocks`` and PS payload nodes), with two changes:

 - **the port's own native codec**: ``_native`` is the port's build of
   ``csrc/wirecodec.cpp`` (``native.load("wirecodec")``), resolved at the
   first frame rather than at import, and never the JAX package's
   module.  Setting ``_native = None`` pins the pure-Python codec, which
   the JAX module's own contract makes byte-identical to the native one;
 - **bf16 without ``ml_dtypes``**: a CPU ``torch.Tensor`` leaf of dtype
   ``torch.bfloat16`` goes out as its raw bytes under the wire dtype name
   ``"bfloat16"`` (the name the JAX package gives an ``ml_dtypes``
   bfloat16 array), and a ``"bfloat16"`` descriptor comes back as a
   ``torch.bfloat16`` tensor over the same bytes.  A ``SparseDelta``'s
   bfloat16 values (``wire_topk_dtype="bfloat16"``) travel the same way.
   Other torch leaves go out as their numpy arrays.

The JAX module's description follows.

DCN host transport — the socket backend for the host-parameter-server path.
Reference being replaced: ``distkeras/networking.py`` (SURVEY.md §2.4), which
frames **pickled** Python objects over TCP with a length prefix.  This module
keeps the same four-function API — ``determine_host_address()``,
``connect()``, ``send_data()``, ``recv_data()`` — but replaces pickle with a
typed binary wire format:

 - a JSON header describes the message *structure* (nested dicts/lists/
   scalars) with ndarray leaves replaced by (buffer-index, dtype, shape)
   descriptors;
 - tensor payloads follow as raw contiguous buffers, written/read directly
   with zero copies on the encode side beyond ``np.ascontiguousarray``.

Rationale: (a) no arbitrary-code-execution surface (pickle's classic flaw),
(b) ndarray bulk bytes skip pickle's memo machinery — weight-delta messages
are the entire traffic of the PS path, so tensor framing is the fast path.

On TPU pods the *primary* transport is ICI collectives inside the XLA program
(``parallel/spmd.py``); this socket layer exists for the semantically-exact
async algorithms (``execution='host_ps'``) whose hogwild interleaving cannot
be expressed in a bulk-synchronous SPMD program, and it rides DCN between
hosts exactly where the reference rode the Spark driver network.
"""

from __future__ import annotations

import collections
import heapq
import json
import logging
import os
import random
import select
import selectors
import signal
import socket
import struct
import threading
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

logger = logging.getLogger(__name__)

MAGIC = b"DKT1"
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

#: maximum header size we will accept (sanity bound against garbage frames)
MAX_HEADER_BYTES = 64 * 1024 * 1024

# Native C++ codec (the port's copy of csrc/wirecodec.cpp, built by
# native.py at first use): byte-identical wire format, single-allocation
# encode and zero-copy decode.  _UNRESOLVED until the first frame loads it
# (a build that fails raises: no silent fallback); None pins the
# pure-Python path below.
_UNRESOLVED = object()
_native: Any = _UNRESOLVED


def _codec():
    """The native codec module, or None when the pure-Python codec is
    pinned."""
    global _native
    if _native is _UNRESOLVED:
        from . import native
        _native = native.load("wirecodec")
    return _native


# ---------------------------------------------------------------------------
# structure encoding
# ---------------------------------------------------------------------------

class ProtocolError(ValueError):
    """A frame that decodes structurally but violates the wire CONTRACT —
    duplicate/negative/out-of-range sparse indices, mis-shaped row blocks.

    Distinct from the codec's own ``ValueError``s (bad magic, truncated
    buffers) only in type: both mean the peer is corrupt or hostile, and
    every server handler already drops the connection on ``ValueError``.
    The typed subclass exists so the PS can validate a sparse commit at the
    transport boundary and reject it *before* any scatter-add could write
    through a bad index into the center (or a neighbouring tensor).
    """


def _sparse_values(values):
    """A sparse node's values as the wire carries them: numpy, or for
    bfloat16 codes a CPU ``torch.bfloat16`` tensor (the form dense bf16
    leaves take here, without ``ml_dtypes``); any other torch tensor is
    held as its numpy array.  Values on a card raise: the wire carries
    host memory only."""
    if not isinstance(values, torch.Tensor):
        return np.asarray(values)
    if values.device.type != "cpu":
        raise ValueError(f"sparse values must be host tensors, got one on "
                         f"{values.device}")
    values = values.detach()
    return values if values.dtype == torch.bfloat16 else values.numpy()


class SparseDelta:
    """A k-sparse view of a flat float32 vector of dense length ``length``.

    The wire form of a top-k-compressed commit (``wire_dtype="topk"`` —
    workers.PSWorker): ``indices`` (int32, sorted ascending, unique) name the
    selected coordinates of the *concatenated* flat weight vector and
    ``values`` carry their magnitudes.  ``values`` may additionally be coded
    (``wire_topk_dtype``): bfloat16 (cast) or int8 (one affine ``scale`` for
    the whole commit, ``value = code * scale``).  On the wire this is a
    dedicated payload node (two tensor buffers + scalars in the header), so
    both the native and pure-Python codecs carry it unchanged — the codecs
    frame buffers, the tree layer interprets them.

    A commit costs O(k) bytes and O(k) apply work instead of O(n); the PS
    applies it with a scatter-add (``parameter_servers._scatter_add``).
    """

    __slots__ = ("indices", "values", "length", "scale")

    def __init__(self, indices, values, length: int,
                 scale: Optional[float] = None):
        self.indices = np.asarray(indices)
        self.values = _sparse_values(values)
        self.length = int(length)
        self.scale = None if scale is None else float(scale)
        if self.indices.ndim != 1 or self.values.ndim != 1:
            raise ValueError("SparseDelta indices/values must be 1-D")
        if tuple(self.indices.shape) != tuple(self.values.shape):
            raise ValueError(
                f"SparseDelta carries {self.indices.shape[0]} indices but "
                f"{self.values.shape[0]} values")

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def f32_values(self) -> np.ndarray:
        """Decode the (possibly coded) values to float32: a bfloat16 code is
        a CPU ``torch.bfloat16`` tensor, widened exactly with ``.float()``
        (what ``astype(np.float32)`` does to ``ml_dtypes`` bfloat16)."""
        vals = self.values
        if isinstance(vals, torch.Tensor):
            vals = vals.float().numpy()
        if self.scale is not None:
            return vals.astype(np.float32) * np.float32(self.scale)
        return vals.astype(np.float32, copy=False)

    def decoded(self) -> "SparseDelta":
        """A defensively-copied, f32-valued twin (safe across pooled
        receives; int64 indices would be rejected downstream, keep int32)."""
        return SparseDelta(np.array(self.indices, np.int32, copy=True),
                           np.array(self.f32_values(), np.float32, copy=True),
                           self.length)

    def to_dense(self) -> np.ndarray:
        """Materialize the dense flat f32 vector (tests / densify helpers)."""
        out = np.zeros((self.length,), np.float32)
        np.add.at(out, self.indices.astype(np.int64), self.f32_values())
        return out

    def validate(self) -> "SparseDelta":
        """Enforce the wire contract on a DECODED commit: integer indices,
        sorted strictly ascending (unique), all within ``[0, length)``.
        Raises ``ProtocolError`` — the PS calls this at the transport
        boundary so a corrupt or hostile frame is rejected (connection
        dropped) instead of scatter-adding through a bad index into the
        center.  Every legitimate encoder (device/host top-k selection,
        the shard splitter) emits sorted unique indices, so this is a
        pure guard, not a normalization."""
        idx = self.indices
        if not np.issubdtype(idx.dtype, np.integer):
            raise ProtocolError(
                f"sparse commit indices must be integers, got {idx.dtype}")
        if idx.size:
            d = np.diff(idx.astype(np.int64, copy=False))
            if np.any(d < 0):
                raise ProtocolError("sparse commit indices are unsorted")
            if np.any(d == 0):
                raise ProtocolError("sparse commit carries duplicate indices")
            if int(idx[0]) < 0 or int(idx[-1]) >= self.length:
                raise ProtocolError(
                    f"sparse commit index out of range for dense length "
                    f"{self.length}")
        return self


class RowSparseDelta:
    """A row-sparse view of ONE tensor with ``num_rows`` leading rows.

    The wire form of an embedding-table commit (``row_sparse=`` on the
    async PS trainers): ``rows`` (int32, sorted ascending, unique) name the
    touched leading-axis rows and ``values`` is the ``(k,) + row_shape``
    block of their deltas.  Unlike the flat top-k ``SparseDelta`` this
    profile is **exact, not lossy**: the untouched rows of an embedding
    delta are exactly zero (only gathered rows move), so shipping the
    touched rows ships the whole delta — no selection, no error-feedback
    residual.  A commit costs O(k·dim) bytes and O(k·dim) apply work
    instead of O(V·dim).

    On the wire this is a dedicated payload node (two tensor buffers +
    the dense row count in the header), carried unchanged by both the
    native and the pure-Python codec — the codecs frame buffers, the tree
    layer interprets them.  The PS applies it with a per-row scatter-add
    (``parameter_servers._row_scatter_add``); shard splits are by row
    range (``slice_rows``).
    """

    __slots__ = ("rows", "values", "num_rows")

    def __init__(self, rows, values, num_rows: int):
        self.rows = np.asarray(rows)
        self.values = np.asarray(values)
        self.num_rows = int(num_rows)
        if self.rows.ndim != 1:
            raise ValueError("RowSparseDelta rows must be 1-D")
        if self.values.ndim < 2:
            raise ValueError(
                "RowSparseDelta values must be a (k, ...) row block")
        if self.values.shape[0] != self.rows.size:
            raise ValueError(
                f"RowSparseDelta carries {self.rows.size} rows but "
                f"{self.values.shape[0]} value rows")

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def row_shape(self) -> tuple:
        return tuple(self.values.shape[1:])

    def f32_values(self) -> np.ndarray:
        return self.values.astype(np.float32, copy=False)

    def decoded(self) -> "RowSparseDelta":
        """A defensively-copied f32 twin (safe across pooled receives)."""
        return RowSparseDelta(
            np.array(self.rows, np.int32, copy=True),
            np.array(self.f32_values(), np.float32, copy=True),
            self.num_rows)

    def to_dense(self) -> np.ndarray:
        """The dense ``(num_rows,) + row_shape`` f32 delta (tests)."""
        out = np.zeros((self.num_rows,) + self.row_shape, np.float32)
        np.add.at(out, self.rows.astype(np.int64), self.f32_values())
        return out

    def validate(self) -> "RowSparseDelta":
        """The wire contract (see ``SparseDelta.validate``): integer rows,
        sorted strictly ascending, within ``[0, num_rows)``.  Raises
        ``ProtocolError`` so the PS rejects the frame at the transport
        boundary instead of writing through a bad row index."""
        rows = self.rows
        if not np.issubdtype(rows.dtype, np.integer):
            raise ProtocolError(
                f"row-sparse commit rows must be integers, got {rows.dtype}")
        if rows.size:
            d = np.diff(rows.astype(np.int64, copy=False))
            if np.any(d < 0):
                raise ProtocolError("row-sparse commit rows are unsorted")
            if np.any(d == 0):
                raise ProtocolError(
                    "row-sparse commit carries duplicate rows")
            if int(rows[0]) < 0 or int(rows[-1]) >= self.num_rows:
                raise ProtocolError(
                    f"row-sparse commit row out of range for {self.num_rows} "
                    "rows")
        return self

    def slice_rows(self, start: int, stop: int) -> "RowSparseDelta":
        """The sub-commit owned by leading-axis range ``[start, stop)`` in
        that range's LOCAL row coordinates (the shard splitter — rows are
        sorted, so one bisection selects the run)."""
        rows64 = self.rows.astype(np.int64, copy=False)
        lo = int(np.searchsorted(rows64, start, side="left"))
        hi = int(np.searchsorted(rows64, stop, side="left"))
        return RowSparseDelta(
            (rows64[lo:hi] - start).astype(self.rows.dtype, copy=False),
            self.values[lo:hi], stop - start)


class KVBlocks:
    """ONE request's paged-KV blocks in flight between a prefill engine and
    a decode engine (disaggregated serving, ``SERVING_OP_KVBLOCKS``).

    ``layers`` mirrors the model's layer list: ``None`` for layers without
    a KV cache, else a dict of flat arena slices in LOGICAL block order —
    ``{"k", "v"}`` of shape ``(num_blocks * block_size, Hkv, Dh)`` (plus
    ``{"ks", "vs"}`` per-entry scales of shape ``(num_blocks * block_size,
    Hkv)`` when the arena is int8-quantized).  Logical order
    replaces the sender's block table on the wire: the receiver allocates
    its OWN physical blocks (``_PagedKVPool.admit``) and scatters row i of
    the payload into its i-th block — physical ids never cross engines.
    ``positions`` is the number of valid prompt tokens written (the decode
    engine resumes at this position) and ``key`` the request's RNG key
    data (uint32), so sampling folds identically on both engines.  The
    port's payload leaves are numpy arrays (f32, int8 codes, scales) or,
    for a bfloat16 arena, CPU ``torch.bfloat16`` tensors.

    Like :class:`RowSparseDelta` this is a dedicated payload node
    (``__kvb__``): the codecs frame buffers, the tree layer interprets
    them — the native codec needs no change.  ``validate()`` is the
    transport-boundary contract: a hostile/torn frame raises
    :class:`ProtocolError` BEFORE the receiving pool allocates or any
    arena write happens.
    """

    __slots__ = ("layers", "block_size", "num_blocks", "positions", "key")

    def __init__(self, layers, block_size: int, num_blocks: int,
                 positions: int, key):
        self.layers = list(layers)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.positions = int(positions)
        self.key = np.asarray(key)

    @property
    def nbytes(self) -> int:
        """Payload bytes shipped (the bench's transfer accounting)."""
        return sum(int(a.nbytes) for c in self.layers if c is not None
                   for a in c.values())

    def validate(self) -> "KVBlocks":
        """The wire contract: raises :class:`ProtocolError` unless every
        layer's arrays agree with the declared block geometry — the
        receiver rejects the frame at the transport boundary instead of
        scattering a lie into its arena."""
        if self.block_size < 1 or self.num_blocks < 1:
            raise ProtocolError(
                f"kv-block transfer declares block_size={self.block_size}, "
                f"num_blocks={self.num_blocks}")
        rows = self.num_blocks * self.block_size
        if not (0 < self.positions <= rows):
            raise ProtocolError(
                f"kv-block transfer positions={self.positions} outside "
                f"(0, {rows}]")
        if (not np.issubdtype(self.key.dtype, np.unsignedinteger)
                or self.key.size == 0 or self.key.size > 4):
            raise ProtocolError(
                f"kv-block transfer RNG key must be a small unsigned "
                f"array, got dtype={self.key.dtype} size={self.key.size}")
        if not any(c is not None for c in self.layers):
            raise ProtocolError("kv-block transfer carries no KV layers")
        for i, c in enumerate(self.layers):
            if c is None:
                continue
            if not isinstance(c, dict) or "k" not in c or "v" not in c:
                raise ProtocolError(
                    f"kv-block transfer layer {i} missing k/v payloads")
            extra = set(c) - {"k", "v", "ks", "vs"}
            if extra:
                raise ProtocolError(
                    f"kv-block transfer layer {i} carries unknown "
                    f"payloads {sorted(extra)}")
            k, v = c["k"], c["v"]
            if (type(k) is not type(v) or k.ndim != 3
                    or tuple(k.shape) != tuple(v.shape)
                    or k.dtype != v.dtype):
                raise ProtocolError(
                    f"kv-block transfer layer {i} k/v disagree: "
                    f"{tuple(k.shape)}/{k.dtype} vs "
                    f"{tuple(v.shape)}/{v.dtype}")
            if k.shape[0] != rows:
                raise ProtocolError(
                    f"kv-block transfer layer {i} carries {k.shape[0]} "
                    f"arena rows, geometry declares {rows}")
            if isinstance(k, torch.Tensor) and k.device.type != "cpu":
                raise ProtocolError(
                    f"kv-block transfer layer {i} payload lies on "
                    f"{k.device}, not in host memory")
            if ("ks" in c) != ("vs" in c):
                raise ProtocolError(
                    f"kv-block transfer layer {i} ships one of ks/vs "
                    "without the other")
            if "ks" in c:
                if not isinstance(k, np.ndarray) or k.dtype != np.int8:
                    raise ProtocolError(
                        f"kv-block transfer layer {i} ships scales for "
                        f"non-int8 codes ({k.dtype})")
                for s in ("ks", "vs"):
                    if tuple(c[s].shape) != tuple(k.shape[:2]):
                        raise ProtocolError(
                            f"kv-block transfer layer {i} {s} shape "
                            f"{tuple(c[s].shape)} != {tuple(k.shape[:2])}")
        return self

    def decoded(self) -> "KVBlocks":
        """A defensive copy with owned buffers — pooled receives hand out
        VIEWS into a reusable recv buffer (the :class:`RowSparseDelta`
        precedent), so anything queued past the next ``recv_data`` must
        copy first."""
        return KVBlocks(
            [None if c is None
             else {k: _copy_leaf(v) for k, v in c.items()}
             for c in self.layers],
            self.block_size, self.num_blocks, self.positions,
            np.array(self.key, copy=True))


#: the wire name of a bfloat16 leaf (the name ``ml_dtypes`` registers, which
#: the JAX package ships); the port carries such leaves as torch tensors
BF16 = "bfloat16"


def _dtype_str(dt: np.dtype) -> str:
    """Wire name for a numpy dtype (bfloat16 leaves are torch tensors and
    never reach this)."""
    return dt.str


def _itemsize(name: str) -> int:
    """Bytes per element of a wire dtype name."""
    if name == BF16:
        return 2
    try:
        return np.dtype(name).itemsize
    except TypeError:
        raise ValueError(f"unsupported wire dtype {name!r}") from None


def _leaf(buf, name: str, shape, copy: bool):
    """One ndarray leaf from its wire bytes: a numpy array, or for
    ``"bfloat16"`` a torch tensor over the same bytes (read through int16,
    so that no ``ml_dtypes`` is needed).  ``copy=False`` returns views
    over ``buf`` where it is writable."""
    if name == BF16:
        arr = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        if copy or not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
    return arr.copy() if copy else arr


def _host_array(t: torch.Tensor):
    """A CPU tensor as the numpy array the codec frames: bf16 as its raw
    bytes (int16) with the wire name ``"bfloat16"``, any other dtype as
    its own numpy array (a tensor on a card raises: the wire carries host
    memory only)."""
    if t.device.type != "cpu":
        raise ValueError(f"only host tensors go on the wire, got one on "
                         f"{t.device}")
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16
    arr = t.numpy()
    return arr, _dtype_str(arr.dtype)


def _copy_leaf(v):
    """An owned copy of one payload leaf (numpy array or torch tensor)."""
    return v.clone() if isinstance(v, torch.Tensor) else np.array(v,
                                                                  copy=True)


def _encode_node(obj: Any, buffers: List[np.ndarray]):
    """Recursively replace ndarray leaves with buffer descriptors."""
    if isinstance(obj, SparseDelta):
        vals = obj.values
        if not isinstance(vals, torch.Tensor):
            vals = np.ascontiguousarray(vals)
        # a bf16 tensor goes through _host_array: int16 bytes named
        # "bfloat16", as the JAX encoder frames an ml_dtypes array
        node = {"i": _encode_node(np.ascontiguousarray(obj.indices), buffers),
                "v": _encode_node(vals, buffers),
                "n": int(obj.length)}
        if obj.scale is not None:
            node["s"] = float(obj.scale)
        return {"__sp__": node}
    if isinstance(obj, RowSparseDelta):
        return {"__rsp__": {
            "r": _encode_node(np.ascontiguousarray(obj.rows), buffers),
            "v": _encode_node(np.ascontiguousarray(obj.values), buffers),
            "n": int(obj.num_rows)}}
    if isinstance(obj, KVBlocks):
        return {"__kvb__": {
            "p": int(obj.block_size),
            "n": int(obj.num_blocks),
            "q": int(obj.positions),
            "k": _encode_node(np.ascontiguousarray(obj.key), buffers),
            "L": [None if c is None else
                  {k: _encode_node(c[k] if isinstance(c[k], torch.Tensor)
                                   else np.ascontiguousarray(c[k]), buffers)
                   for k in sorted(c)}
                  for c in obj.layers]}}
    if isinstance(obj, torch.Tensor):
        arr, name = _host_array(obj)
        idx = len(buffers)
        buffers.append(np.ascontiguousarray(arr))
        return {"__nd__": idx, "dtype": name, "shape": list(obj.shape)}
    if isinstance(obj, np.ndarray):
        idx = len(buffers)
        buffers.append(np.ascontiguousarray(obj))
        return {"__nd__": idx, "dtype": _dtype_str(obj.dtype),
                "shape": list(obj.shape)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {"__dict__": {str(k): _encode_node(v, buffers)
                             for k, v in obj.items()}}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode_node(v, buffers) for v in obj]}
    if isinstance(obj, list):
        return [_encode_node(v, buffers) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"Cannot encode {type(obj)} on the wire")


def _decode_node(node: Any, buffers: List[bytes], copy: bool = True):
    """``copy=False`` returns ndarray *views* over ``buffers`` (the pooled
    receive path) — valid only until the backing buffer is reused."""
    if isinstance(node, dict):
        if "__nd__" in node:
            return _leaf(buffers[node["__nd__"]], node["dtype"],
                         node["shape"], copy)
        if "__sp__" in node:
            sp = node["__sp__"]
            return SparseDelta(_decode_node(sp["i"], buffers, copy),
                               _decode_node(sp["v"], buffers, copy),
                               int(sp["n"]), sp.get("s"))
        if "__rsp__" in node:
            rsp = node["__rsp__"]
            return RowSparseDelta(_decode_node(rsp["r"], buffers, copy),
                                  _decode_node(rsp["v"], buffers, copy),
                                  int(rsp["n"]))
        if "__kvb__" in node:
            kvb = node["__kvb__"]
            layers = [None if c is None else
                      {k: _decode_node(v, buffers, copy)
                       for k, v in c.items()}
                      for c in kvb["L"]]
            return KVBlocks(layers, int(kvb["p"]), int(kvb["n"]),
                            int(kvb["q"]),
                            _decode_node(kvb["k"], buffers, copy))
        if "__dict__" in node:
            return {k: _decode_node(v, buffers, copy)
                    for k, v in node["__dict__"].items()}
        if "__tuple__" in node:
            return tuple(_decode_node(v, buffers, copy)
                         for v in node["__tuple__"])
        raise ValueError(f"Malformed wire node: {node!r}")
    if isinstance(node, list):
        return [_decode_node(v, buffers, copy) for v in node]
    return node


def encode_message(obj: Any) -> bytes:
    """Serialize a message (nested dict/list/tuple/scalars/ndarrays)."""
    buffers: List[np.ndarray] = []
    header = json.dumps(
        {"tree": _encode_node(obj, buffers), "nbuf": len(buffers)}
    ).encode()
    codec = _codec()
    if codec is not None:
        return codec.encode_frames(header, buffers)
    parts = [MAGIC, _U32.pack(len(header)), header]
    for b in buffers:
        raw = b.tobytes()
        parts.append(_U64.pack(len(raw)))
        parts.append(raw)
    return b"".join(parts)


def encode_message_into(obj: Any, pool: "BufferPool") -> memoryview:
    """``encode_message`` into a reusable pooled buffer (the send-path twin
    of the pooled receive): steady-state commits of a fixed wire layout
    re-serialize into the same preallocated memory instead of allocating a
    fresh output blob per window.  The returned view is valid until the next
    ``encode_message_into`` on the same pool — callers ``sendall`` it
    immediately (the PS protocol is strictly request/reply, so at most one
    encoded frame is live per connection)."""
    buffers: List[np.ndarray] = []
    header = json.dumps(
        {"tree": _encode_node(obj, buffers), "nbuf": len(buffers)}
    ).encode()
    total = 8 + len(header) + sum(8 + b.nbytes for b in buffers)
    buf = pool.get(total)
    buf[0:4] = MAGIC
    _U32.pack_into(buf, 4, len(header))
    off = 8
    buf[off:off + len(header)] = header
    off += len(header)
    out_u8 = np.frombuffer(buf, dtype=np.uint8)
    for b in buffers:
        _U64.pack_into(buf, off, b.nbytes)
        off += 8
        # byte-level copy straight into the pooled buffer — no intermediate
        # tobytes() allocation (reshape(-1) handles 0-d, view(uint8) any
        # itemsize on contiguous data)
        out_u8[off:off + b.nbytes] = b.reshape(-1).view(np.uint8)
        off += b.nbytes
    return memoryview(buf)[:total]


def _expected_buffer_sizes(tree: Any, out: dict):
    """Collect idx → byte-size for every ndarray descriptor in a header tree,
    so buffer lengths on the wire can be validated *before* allocation."""
    if isinstance(tree, dict):
        if "__nd__" in tree:
            size = _itemsize(tree["dtype"])
            for d in tree["shape"]:
                size *= int(d)
            out[int(tree["__nd__"])] = size
        elif "__sp__" in tree:
            _expected_buffer_sizes(tree["__sp__"]["i"], out)
            _expected_buffer_sizes(tree["__sp__"]["v"], out)
        elif "__rsp__" in tree:
            _expected_buffer_sizes(tree["__rsp__"]["r"], out)
            _expected_buffer_sizes(tree["__rsp__"]["v"], out)
        elif "__kvb__" in tree:
            _expected_buffer_sizes(tree["__kvb__"]["k"], out)
            for c in tree["__kvb__"]["L"]:
                if c is not None:
                    for v in c.values():
                        _expected_buffer_sizes(v, out)
        elif "__dict__" in tree:
            for v in tree["__dict__"].values():
                _expected_buffer_sizes(v, out)
        elif "__tuple__" in tree:
            for v in tree["__tuple__"]:
                _expected_buffer_sizes(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _expected_buffer_sizes(v, out)


def decode_message(data: bytes) -> Any:
    codec = _codec()
    if codec is not None:
        raw_header, views = codec.decode_frames(data)
        header = json.loads(raw_header.decode())
        expected: dict = {}
        _expected_buffer_sizes(header["tree"], expected)
        if len(views) != header["nbuf"]:
            raise ValueError(
                f"{len(views)} buffers on wire, header declares "
                f"{header['nbuf']}")
        for i, v in enumerate(views):
            if v.nbytes != expected.get(i, -1):
                raise ValueError(
                    f"buffer {i} carries {v.nbytes} bytes, header expects "
                    f"{expected.get(i)}")
        return _decode_node(header["tree"], views)
    if data[:4] != MAGIC:
        raise ValueError("Bad magic on wire message")
    (hlen,) = _U32.unpack_from(data, 4)
    header = json.loads(data[8:8 + hlen].decode())
    expected = {}
    _expected_buffer_sizes(header["tree"], expected)
    off = 8 + hlen
    buffers: List[bytes] = []
    for i in range(header["nbuf"]):
        (blen,) = _U64.unpack_from(data, off)
        if blen != expected.get(i, -1):
            raise ValueError(
                f"buffer {i} declares {blen} bytes, header expects "
                f"{expected.get(i)}")
        off += 8
        buffers.append(data[off:off + blen])
        off += blen
    return _decode_node(header["tree"], buffers)


def _decode_payload_py(data) -> List[memoryview]:
    """Pure-Python twin of the native ``decode_payload``: split a run of
    ``u64 len | raw bytes`` frames into zero-copy memoryviews over ``data``.
    Used by the pooled receive path, where the payload (everything after the
    header) was read into a reusable buffer in one recv pass."""
    view = memoryview(data)
    n = len(view)
    out: List[memoryview] = []
    off = 0
    while off < n:
        if n - off < 8:
            raise ValueError("Truncated buffer length")
        (blen,) = _U64.unpack_from(view, off)
        off += 8
        if blen > n - off:
            raise ValueError("Truncated buffer payload")
        out.append(view[off:off + blen])
        off += blen
    return out


def decode_payload(data) -> List[memoryview]:
    """Split length-prefixed tensor frames (native codec unless the
    pure-Python one is pinned)."""
    codec = _codec()
    if codec is not None:
        return codec.decode_payload(data)
    return _decode_payload_py(data)


class BufferPool:
    """Reusable receive buffers for one connection's request/reply stream.

    The PS protocol is strictly request/reply per connection — at most one
    frame is in flight — so one buffer per payload size is enough: repeated
    same-shape weight pulls land in the same preallocated memory instead of
    allocating fresh weight-sized buffers every round trip.  Arrays decoded
    through a pool are **views** into it, valid only until the next
    ``recv_data(..., pool=...)`` call on the same pool; callers that keep
    weights across a receive must copy (the workers move them to device
    immediately, which copies).

    Growth is capped: a buffer that goes ``max_idle`` consecutive
    acquisitions without being the requested size is evicted, so a client
    holding one pool per PS shard doesn't pin N full weight-sized buffers
    forever after a pull-size change (e.g. a resumed run with a different
    wire layout).  ``max_idle=None`` disables eviction.

    ``get`` (and the hit/miss/eviction bookkeeping) is thread-safe: the
    serving server's per-connection reuse pattern has handler threads and
    the engine thread alive at once, and the pure-Python dict bookkeeping
    here is not atomic under concurrent mutation.  Thread-safety of
    acquisition does NOT extend the buffer-lifetime contract — two threads
    that acquire the SAME size still share one buffer, so a pool may be
    shared across threads only when at most one frame per pool is live at
    a time (per-connection pools, the pattern both servers use).
    """

    def __init__(self, max_idle: Optional[int] = 32):
        self._bufs: Dict[int, bytearray] = {}
        self._last_used: Dict[int, int] = {}
        self._acquisitions = 0
        self._get_lock = threading.Lock()
        self.max_idle = max_idle
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, size: int) -> bytearray:
        with self._get_lock:
            self._acquisitions += 1
            buf = self._bufs.get(size)
            if buf is None:
                buf = bytearray(size)
                self._bufs[size] = buf
                self.misses += 1
            else:
                self.hits += 1
            self._last_used[size] = self._acquisitions
            if self.max_idle is not None:
                stale = [s for s, last in self._last_used.items()
                         if self._acquisitions - last >= self.max_idle]
                for s in stale:
                    del self._bufs[s]
                    del self._last_used[s]
                    self.evictions += 1
            return buf


# ---------------------------------------------------------------------------
# socket API (reference-parity surface: networking.py module functions)
# ---------------------------------------------------------------------------

def determine_host_address() -> str:
    """Best-effort routable address of this host (reference:
    ``networking.determine_host_address``).  Uses the UDP-connect trick; falls
    back to loopback in isolated sandboxes."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))  # no packets are actually sent (UDP)
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def connect(host: str, port: int, disable_nagle: bool = True,
            timeout: float = 60.0) -> socket.socket:
    """TCP connect with Nagle disabled (reference: ``networking.connect`` —
    TCP_NODELAY matters because commits are latency-sensitive small-ish
    bursts, and the reference sets it too)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    if disable_nagle:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


class ClientPool:
    """Router-side connection pooling: a bounded per-address free list of
    reusable client objects (anything with a ``close()``), so a
    :class:`serving.ServingRouter` streaming thousands of requests to a
    handful of replica addresses re-dials only on growth or after a
    transport fault instead of once per request.

    ``factory(addr)`` builds a fresh client for an address (the router
    passes ``lambda a: ServingClient(*a)``).  ``acquire`` pops an idle
    client for the address or dials a new one; ``release`` returns it to
    the free list (closed instead once ``max_idle_per_addr`` are already
    parked — the pool bounds idle sockets, not concurrency); ``discard``
    closes a client whose connection is suspect (any transport fault —
    a pooled client is only reusable while its request/reply stream is
    in a clean between-frames state).  ``close`` empties every free list.

    The free lists are lock-protected; the clients themselves are NOT
    made thread-safe by pooling — one acquirer uses one client at a time,
    which is exactly the borrow/return discipline the pool enforces.
    Eviction (a ``release`` past ``max_idle_per_addr``) and ``close`` both
    decide under the lock and close OUTSIDE it; a ``release`` racing
    ``close`` cannot re-park a client into a closed pool (the ``_closed``
    latch closes it instead — regression-tested in
    tests/test_serving_event.py, where the leak was an unclosed socket per
    race won).
    """

    def __init__(self, factory, max_idle_per_addr: int = 4):
        self._factory = factory
        self._idle: Dict[Any, List[Any]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.max_idle_per_addr = int(max_idle_per_addr)
        self.dials = 0     # fresh clients built
        self.reuses = 0    # acquisitions served from the free list
        self.discards = 0  # clients dropped on suspicion

    def acquire(self, addr):
        with self._lock:
            free = self._idle.get(addr)
            if free:
                self.reuses += 1
                return free.pop()
            self.dials += 1
        return self._factory(addr)

    def release(self, addr, client) -> None:
        with self._lock:
            if not self._closed:
                free = self._idle.setdefault(addr, [])
                if len(free) < self.max_idle_per_addr:
                    free.append(client)
                    return
        self._close_one(client)

    def discard(self, client) -> None:
        with self._lock:
            self.discards += 1
        self._close_one(client)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            clients = [c for free in self._idle.values() for c in free]
            self._idle.clear()
        for c in clients:
            self._close_one(c)

    @staticmethod
    def _close_one(client) -> None:
        try:
            client.close()
        except OSError:
            pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Receive exactly len(view) bytes directly into preallocated memory."""
    while view:
        n = sock.recv_into(view, min(len(view), 1 << 20))
        if not n:
            raise ConnectionError("socket closed mid-frame")
        view = view[n:]


def send_data(sock: socket.socket, obj: Any,
              pool: Optional[BufferPool] = None) -> None:
    """Frame and send one message (reference: ``networking.send_data``).

    With ``pool``, the frame is serialized into a reusable per-connection
    buffer (``encode_message_into``) — the steady-state commit/reply path
    allocates no fresh output blob.  Wire bytes are identical either way.
    """
    if pool is not None:
        sock.sendall(encode_message_into(obj, pool))
        return
    sock.sendall(encode_message(obj))


def recv_data(sock: socket.socket, pool: Optional[BufferPool] = None) -> Any:
    """Receive one full message (reference: ``networking.recv_data`` — loop
    until the declared byte count arrives).

    With ``pool``, the tensor payload is received into a reusable
    per-connection buffer and decoded **zero-copy** (ndarray views over the
    pooled memory) — the steady-state weight-pull path allocates nothing.
    The returned arrays are only valid until the next pooled receive; see
    ``BufferPool``.
    """
    head = _recv_exact(sock, 8)
    if head[:4] != MAGIC:
        raise ValueError("Bad magic on wire message")
    (hlen,) = _U32.unpack(head[4:])
    if hlen > MAX_HEADER_BYTES:
        raise ValueError(f"Header too large: {hlen}")
    header = json.loads(_recv_exact(sock, hlen).decode())
    # buffer lengths must match the dtype*shape the header declares — a
    # corrupt/malicious frame cannot drive unbounded allocation
    expected: dict = {}
    _expected_buffer_sizes(header["tree"], expected)
    nbuf = header["nbuf"]
    if pool is not None:
        # one recv pass into preallocated memory; the per-buffer u64 length
        # prefixes are validated after the read (a lie means the stream is
        # already desynchronized — callers drop the connection on ValueError,
        # exactly as on any other corrupt frame)
        payload_len = 0
        for i in range(nbuf):
            if i not in expected:
                raise ValueError(f"header declares {nbuf} buffers but "
                                 f"describes no buffer {i}")
            payload_len += 8 + expected[i]
        buf = pool.get(payload_len)
        _recv_exact_into(sock, memoryview(buf))
        views = decode_payload(buf)
        if len(views) != nbuf:
            raise ValueError(f"{len(views)} buffers on wire, header "
                             f"declares {nbuf}")
        for i, v in enumerate(views):
            if v.nbytes != expected[i]:
                raise ValueError(
                    f"buffer {i} carries {v.nbytes} bytes, header expects "
                    f"{expected[i]}")
        return _decode_node(header["tree"], views, copy=False)
    buffers: List[bytes] = []
    for i in range(nbuf):
        (blen,) = _U64.unpack(_recv_exact(sock, 8))
        if blen != expected.get(i, -1):
            raise ValueError(
                f"buffer {i} declares {blen} bytes, header expects "
                f"{expected.get(i)}")
        buffers.append(_recv_exact(sock, blen))
    return _decode_node(header["tree"], buffers)


def read_frame(sock: socket.socket) -> bytes:
    """Read one complete wire frame and return its raw bytes, undecoded.

    Used by ``ChaosProxy`` to relay whole messages so faults land on exact
    message boundaries (deterministic injection points) instead of arbitrary
    byte offsets.  Trusts the stream's own length prefixes — this is a relay
    for traffic the endpoints already validate, not a decoder.
    """
    head = _recv_exact(sock, 8)
    if head[:4] != MAGIC:
        raise ValueError("Bad magic on wire message")
    (hlen,) = _U32.unpack(head[4:])
    if hlen > MAX_HEADER_BYTES:
        raise ValueError(f"Header too large: {hlen}")
    raw_header = _recv_exact(sock, hlen)
    header = json.loads(raw_header.decode())
    parts = [head, raw_header]
    for _ in range(int(header["nbuf"])):
        lenb = _recv_exact(sock, 8)
        (blen,) = _U64.unpack(lenb)
        parts.append(lenb)
        parts.append(_recv_exact(sock, blen))
    return b"".join(parts)


class FrameParser:
    """Incremental parser for the PS opcode byte stream (the event-loop
    server's receive path — ``parameter_servers.SocketParameterServer``).

    A non-blocking connection hands every ``recv`` chunk to ``feed``;
    ``messages()`` then yields each COMPLETE ``(opcode, message)`` pair
    buffered so far (``message`` is None for frameless opcodes) and leaves
    any trailing partial frame buffered for the next feed.

    Zero-copy fast path: frames that arrive COMPLETE inside one fed chunk
    (the steady state — a worker's whole commit in one recv) decode
    straight over that chunk, so the decoded ndarrays are *views* into the
    caller's receive buffer with the same lifetime contract as the pooled
    ``recv_data`` path: valid until the caller reuses that memory (the
    event loop consumes every drained commit before the connection's next
    recv, so a per-connection pooled scratch is safe).  Only a frame torn
    across chunks pays copies — its pieces accumulate in ``buf`` and the
    reassembled frame is promoted to immutable bytes before decoding.

    Validation mirrors ``recv_data``: magic, bounded header, and per-buffer
    lengths checked against the dtype×shape the header declares — a
    corrupt or hostile frame raises ``ValueError`` *before* any oversized
    allocation, and the server drops the connection exactly as it does on
    a torn frame today.

    ``frame_ops=None`` selects the BARE-frame mode: the stream carries no
    opcode bytes, every message is a codec frame back to back (the
    server→client half of the serving protocol — reply/chunk frames), and
    ``messages()`` yields ``(None, message)`` pairs.  Same zero-copy /
    reassembly / validation machinery, one byte less of framing.
    """

    __slots__ = ("buf", "frame_ops", "_filled", "_need", "_src", "_off",
                 "_retired")

    def __init__(self, frame_ops: Optional[bytes] = b"cu"):
        self.frame_ops = frame_ops
        # reassembly buffer for a frame torn across chunks: preallocated to
        # the frame's total size as soon as the header has arrived, so a
        # large frame streams into place (``writable``/``advance``) instead
        # of growing a bytearray chunk by chunk
        self.buf = bytearray()
        self._filled = 0  # valid bytes in buf
        self._need: Optional[int] = None  # total frame size, once measured
        self._src = None  # current fast-path chunk (bytes or memoryview)
        self._off = 0
        # the last handed-off frame buffer, recycled for the next torn
        # frame (steady-state same-size commits reassemble into the same
        # memory — no per-frame allocate-and-zero).  Reuse rides the same
        # lifetime contract as the fast path: the caller consumed the
        # previous frame's views before feeding more bytes.
        self._retired: Optional[bytearray] = None

    def feed(self, data) -> None:
        if self._src is not None:
            # unconsumed fast-path tail from an abandoned messages() walk:
            # fall back to reassembly before taking new bytes.  The tail
            # may alias the retired buffer — drop that from the recycle
            # slot so _append cannot be handed its own source memory.
            tail = memoryview(self._src)[self._off:]
            if len(tail):
                self._retired = None
                self._append(tail)
            self._src = None
        if self._filled:
            self._append(data)
        else:
            self._src = data
            self._off = 0

    def writable(self) -> Optional[memoryview]:
        """Direct-fill continuation: once a torn frame's total size is
        known, the writable tail of the preallocated frame buffer —
        ``recv_into`` it and report with ``advance(n)``, and the frame
        streams kernel→buffer with no intermediate chunk copy (the
        event-loop twin of ``_recv_exact_into``).  None while no torn
        frame is pending (use ``feed``)."""
        if (self._src is None and self._need is not None
                and self._filled < self._need):
            return memoryview(self.buf)[self._filled:self._need]
        return None

    def advance(self, n: int) -> None:
        """Account ``n`` bytes received into the ``writable()`` view."""
        self._filled += n

    def messages(self):
        while True:
            item = self._next()
            if item is None:
                return
            yield item

    @property
    def midframe(self) -> bool:
        """True when a partial frame is buffered — EOF now is a torn
        frame (the blocking path's ``recv_data`` raising mid-recv), not a
        clean close.  Meaningful between ``messages()`` drains."""
        return bool(self._filled) or self._src is not None or \
            self._need is not None

    def _take_buffer(self, capacity: int) -> bytearray:
        """A frame buffer of at least ``capacity`` bytes — the retired
        previous frame buffer when it fits (its views were consumed before
        this parser was fed again), else a fresh allocation."""
        buf = self._retired
        if buf is not None and len(buf) >= capacity:
            self._retired = None
            return buf
        return bytearray(capacity)

    def _append(self, data) -> None:
        n = len(data)
        need = self._filled + n
        if len(self.buf) < need:
            # allocate-and-swap (never resize in place: decoded views may
            # still be keeping a previously handed-off buffer alive, and a
            # preallocation below covers the whole frame in one step)
            new = self._take_buffer(max(need, self._need or 0))
            new[:self._filled] = memoryview(self.buf)[:self._filled]
            self.buf = new
        self.buf[self._filled:need] = data
        self._filled = need

    def _next(self):
        if self._src is not None:
            item, end = self._parse_one(memoryview(self._src), self._off)
            if item is not None:
                self._off = end
                return item
            # incomplete: keep only the torn tail, release the chunk (the
            # caller is free to reuse its memory once messages() returns)
            tail = memoryview(self._src)[self._off:]
            if len(tail):
                self._append(tail)
            self._src = None
            # fall through to measure the torn frame (sets _need so the
            # caller can switch to the direct-fill path)
        return self._next_reassembled()

    def _next_reassembled(self):
        """Reassembly path: measure the torn frame's total size from its
        header (preallocating ``buf`` to it), and once complete hand the
        buffer off to the fast path — ownership moves with it, so decoded
        views never alias a buffer this parser will write to again."""
        if not self._filled:
            return None
        buf = self.buf
        if self.frame_ops is None:
            pre = 0  # bare-frame mode: no opcode byte before the frame
        else:
            op = bytes(buf[:1])
            if op not in self.frame_ops:
                del buf[:1]
                self._filled -= 1
                return op, None
            pre = 1
        if self._need is None:
            if self._filled < pre + 8:
                return None
            if buf[pre:pre + 4] != MAGIC:
                raise ValueError("Bad magic on wire message")
            (hlen,) = _U32.unpack_from(buf, pre + 4)
            if hlen > MAX_HEADER_BYTES:
                raise ValueError(f"Header too large: {hlen}")
            if self._filled < pre + 8 + hlen:
                return None
            header = json.loads(bytes(buf[pre + 8:pre + 8 + hlen]).decode())
            self._need = pre + 8 + hlen + self._payload_size(header)
            if len(buf) < self._need:
                new = self._take_buffer(self._need)
                new[:self._filled] = memoryview(buf)[:self._filled]
                self.buf = new
        if self._filled < self._need:
            return None
        # complete: hand the buffer off and continue on the fast path.
        # Retire it for recycling only when it holds nothing past this
        # frame — a trailing next-frame fragment still aliases it (and
        # will be copied out through _append, which must not be handed
        # the same memory as its source).
        self._src = memoryview(self.buf)[:self._filled]
        self._off = 0
        if self._filled == self._need:
            self._retired = self.buf
        self.buf = bytearray()
        self._filled = 0
        self._need = None
        return self._next()

    @staticmethod
    def _payload_size(header: dict) -> int:
        expected: dict = {}
        _expected_buffer_sizes(header["tree"], expected)
        payload = 0
        for i in range(int(header["nbuf"])):
            if i not in expected:
                raise ValueError(
                    f"header declares {header['nbuf']} buffers but "
                    f"describes no buffer {i}")
            payload += 8 + expected[i]
        return payload

    def _parse_one(self, mv, off):
        """Parse one frame starting at ``off`` in immutable/stable memory.
        Returns ``((op, msg), end)`` or ``(None, off)`` when incomplete;
        raises ``ValueError`` on corruption.  Decoded ndarrays are views
        over ``mv`` — no intermediate frame copy."""
        n = len(mv)
        if off >= n:
            return None, off
        if self.frame_ops is None:
            op = None  # bare-frame mode: the frame starts at ``off``
            fo = off
        else:
            op = bytes(mv[off:off + 1])
            if op not in self.frame_ops:
                return (op, None), off + 1
            fo = off + 1
        if n - fo < 8:
            return None, off
        if bytes(mv[fo:fo + 4]) != MAGIC:
            raise ValueError("Bad magic on wire message")
        (hlen,) = _U32.unpack_from(mv, fo + 4)
        if hlen > MAX_HEADER_BYTES:
            raise ValueError(f"Header too large: {hlen}")
        hdr_end = fo + 8 + hlen
        if n < hdr_end:
            return None, off
        header = json.loads(bytes(mv[fo + 8:hdr_end]).decode())
        expected: dict = {}
        _expected_buffer_sizes(header["tree"], expected)
        payload = 0
        nbuf = int(header["nbuf"])
        for i in range(nbuf):
            if i not in expected:
                raise ValueError(
                    f"header declares {nbuf} buffers but describes no "
                    f"buffer {i}")
            payload += 8 + expected[i]
        end = hdr_end + payload
        if n < end:
            return None, off
        views = decode_payload(mv[hdr_end:end])
        if len(views) != nbuf:
            raise ValueError(
                f"{len(views)} buffers on wire, header declares {nbuf}")
        for i, v in enumerate(views):
            if v.nbytes != expected.get(i, -1):
                raise ValueError(
                    f"buffer {i} carries {v.nbytes} bytes, header expects "
                    f"{expected.get(i)}")
        return (op, _decode_node(header["tree"], views, copy=False)), end


class EventLoop:
    """ONE selector thread shared by N I/O endpoints — the serving-side
    event transport's substrate (the ``SocketParameterServer`` I/O-loop
    shape, factored out so the :class:`serving.ServingServer` event core,
    the :class:`serving.ServingRouter` stream relay, and the
    :class:`serving.DisaggPair` hand-off can all multiplex their sockets,
    timers, and cross-thread wakeups on one loop instead of holding a
    thread per connection or per in-flight request).

    Surface:

     - ``add(sock, callback, mask)`` / ``set_mask`` / ``remove`` — fd
       registration.  ON-LOOP ONLY (call from a callback/timer, or get
       there via ``call_soon``): mutating a selector under a concurrent
       ``select`` is not portable.
     - ``call_soon(fn)`` — thread-safe: enqueue ``fn`` on the loop and
       wake it (the socketpair waker; this is how an engine thread's
       token push reaches the loop without a per-connection thread).
     - ``call_later(delay_s, fn)`` — thread-safe one-shot timer.  Timers
       are never cancelled; a stale timer's ``fn`` is expected to re-check
       state and no-op.
     - ``start()`` / ``stop(join_timeout)`` / ``wake()``.

    Socket callbacks are invoked as ``callback(mask)``; ``call_soon`` /
    ``call_later`` callables take no arguments.  All of them run on the
    loop thread, so state touched only by callbacks needs no lock.  An
    exception out of a callback is logged and the loop SURVIVES — one
    hostile peer or lost race must not take down every other stream
    multiplexed on the loop.
    """

    def __init__(self, name: str = "dkt-event-loop"):
        self.name = str(name)
        self._sel: Optional[selectors.BaseSelector] = None
        self._waker: Optional[tuple] = None  # (recv side, send side)
        self._thread: Optional[threading.Thread] = None
        self._pending: collections.deque = collections.deque()
        self._timers: List[tuple] = []  # heap of (when, seq, fn)
        self._seq = 0
        self._lock = threading.Lock()  # guards: _running, _timers, _seq
        self._running = False
        #: callables run ON the loop thread as it exits (before the
        #: selector and waker close) — owners hang their connection
        #: teardown/flush here so stop() drains through the loop itself
        self.stop_hooks: List[Callable[[], None]] = []

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "EventLoop":
        r, w = socket.socketpair()
        r.setblocking(False)
        self._waker = (r, w)
        self._sel = selectors.DefaultSelector()
        self._sel.register(r, selectors.EVENT_READ, None)
        with self._lock:
            self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> bool:
        """Ask the loop to exit and join it.  Returns False when the loop
        thread outlived ``join_timeout`` (wedged inside a callback — the
        loop itself never blocks on a socket); the caller owns any
        force-close escalation, exactly like the PS core's ``stop``."""
        with self._lock:
            self._running = False
        self.wake()
        t = self._thread
        if t is None or t is threading.current_thread():
            return True
        t.join(timeout=join_timeout)
        return not t.is_alive()

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def thread(self) -> Optional[threading.Thread]:
        """The loop thread — owners expose it where callers expect a
        per-server I/O thread handle (supervisor liveness probes)."""
        return self._thread

    def wake(self) -> None:
        w = self._waker
        if w is not None:
            try:
                w[1].send(b"\0")
            except OSError:
                pass

    # -- cross-thread scheduling --------------------------------------------
    def call_soon(self, fn: Callable[[], None]) -> None:
        self._pending.append(fn)  # deque.append is atomic
        self.wake()

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> None:
        with self._lock:
            self._seq += 1
            heapq.heappush(
                self._timers,
                (time.monotonic() + float(delay_s), self._seq, fn))
        self.wake()

    # -- fd registration (ON-LOOP ONLY) -------------------------------------
    def add(self, sock, callback: Callable[[int], None],
            mask: int = selectors.EVENT_READ) -> None:
        self._sel.register(sock, mask, callback)

    def set_mask(self, sock, mask: int) -> None:
        key = self._sel.get_key(sock)
        if key.events != mask:
            self._sel.modify(sock, mask, key.data)

    def remove(self, sock) -> None:
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            pass

    def registered(self) -> int:
        """Registered endpoint count, waker excluded (test surface for the
        zero-leaked-fd assertions)."""
        sel = self._sel
        if sel is None:
            return 0
        try:
            fd_map = sel.get_map()
        except RuntimeError:
            return 0
        if fd_map is None:  # selector closed
            return 0
        return max(0, len(fd_map) - 1)

    # -- the loop -----------------------------------------------------------
    def _invoke(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception:
            logger.exception("event-loop callback failed on %s", self.name)

    def _run(self) -> None:
        sel = self._sel
        try:
            while True:
                with self._lock:
                    if not self._running:
                        return
                    timeout = (max(0.0, self._timers[0][0]
                                   - time.monotonic())
                               if self._timers else None)
                try:
                    events = sel.select(timeout=timeout)
                except OSError:
                    continue  # fds hard-closed under us; re-check and go on
                for key, mask in events:
                    if (self._waker is not None
                            and key.fileobj is self._waker[0]):
                        try:
                            self._waker[0].recv(4096)
                        except OSError:
                            pass
                        continue
                    if key.data is not None:
                        self._invoke(key.data, mask)
                now = time.monotonic()
                due = []
                with self._lock:
                    while self._timers and self._timers[0][0] <= now:
                        due.append(heapq.heappop(self._timers)[2])
                for fn in due:
                    self._invoke(fn)
                while True:
                    try:
                        fn = self._pending.popleft()
                    except IndexError:
                        break
                    self._invoke(fn)
        finally:
            self._shutdown()

    def _shutdown(self) -> None:
        for hook in list(self.stop_hooks):
            try:
                hook()
            except Exception:
                logger.exception("event-loop stop hook failed on %s",
                                 self.name)
        if self._sel is not None:
            try:
                self._sel.close()
            except OSError:
                pass
        if self._waker is not None:
            for s in self._waker:
                try:
                    s.close()
                except OSError:
                    pass
            self._waker = None


#: Serving-protocol opcodes (``serving.ServingServer`` — its OWN opcode
#: namespace on its own port; the PS protocol's ``'q'`` quit is unrelated):
#: ``'q'`` enqueue request (frame follows; server acks or backpressures),
#: ``'r'`` stream reply (frame ``{"id"}`` follows; server streams chunk
#: frames until ``done``), ``'x'`` cancel (frame ``{"id"}`` follows;
#: server acks — or, sent mid-stream, cancels unacked and the stream's
#: final frame carries ``finish="cancel"``).  All ride the ordinary codec —
#: request/reply bodies are plain trees, so the native and pure-Python
#: codecs carry them unchanged (round-trip-tested in
#: tests/test_wirecodec.py).
SERVING_OP_ENQUEUE = b"q"
SERVING_OP_STREAM = b"r"
SERVING_OP_CANCEL = b"x"
#: ``'k'`` kv-block transfer (disaggregated serving): a prefill engine —
#: or a ``DisaggPair`` router on its behalf — ships one request's filled
#: paged-KV blocks (a ``KVBlocks`` node + the request metadata) to a
#: decode-role engine, which admits it straight into the token loop; the
#: server acks ``{"ok", "id"}`` exactly like an enqueue and the reply
#: stream rides the ordinary ``'r'`` opcode.
SERVING_OP_KVBLOCKS = b"k"
#: ``'s'`` load/stats probe (fleet routing): the server replies with the
#: engine's lock-free :meth:`serving.ServingEngine.load` snapshot (queue
#: depth, free slots, trie-cached block count, draining/dead flags) — the
#: signal a :class:`serving.ServingRouter` dispatches on.  Read-only, no
#: request body; deliberately NOT ``'h'`` (the PS heartbeat byte) so the
#: two protocols' namespaces stay collision-free where possible.
SERVING_OP_STATS = b"s"

#: PS-protocol opcodes (``parameter_servers.*SocketParameterServer`` —
#: reference protocol ``'p'`` pull / ``'c'`` commit, plus ``'u'`` update
#: (commit+pull in one round trip), ``'h'`` heartbeat, ``'q'`` quit.
#: ``PS_OP_QUIT`` and ``SERVING_OP_ENQUEUE`` share the byte ``'q'``: safe
#: only because the two protocols never share a socket (each server owns
#: its port) — dklint's wire-opcode rule flags the collision and
#: analysis/baseline.toml records exactly that justification.
PS_OP_PULL = b"p"
PS_OP_COMMIT = b"c"
PS_OP_UPDATE = b"u"
PS_OP_HEARTBEAT = b"h"
PS_OP_QUIT = b"q"


def send_opcode(sock: socket.socket, op: bytes) -> None:
    """Send a 1-byte action opcode (reference protocol: ``'p'`` pull /
    ``'c'`` commit; we add ``'u'`` update = commit+pull in one round trip,
    ``'h'`` heartbeat, and ``'q'`` quit; the serving protocol reuses this
    framing with its own namespace — ``SERVING_OP_ENQUEUE`` /
    ``SERVING_OP_STREAM``)."""
    assert len(op) == 1
    sock.sendall(op)


def recv_opcode(sock: socket.socket) -> bytes:
    """Receive a 1-byte opcode; returns b'' on clean EOF (worker hung up)."""
    try:
        op = sock.recv(1)
    except socket.timeout:
        # an idle_deadline elapsed on a socket with settimeout() armed —
        # half-open peer detection, not EOF; let the server's handler reap
        raise
    except (ConnectionError, OSError):
        return b""
    return op


# ---------------------------------------------------------------------------
# deterministic network fault injection
# ---------------------------------------------------------------------------

def _hard_close(sock: Optional[socket.socket]) -> None:
    """Close with SO_LINGER=0 so the peer sees an RST (connection reset),
    not a graceful FIN — the signature of a host falling over."""
    if sock is None:
        return
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ChaosFault(NamedTuple):
    """One scripted fault: on connection ``conn`` (accept order on the
    proxy; -1 = every connection), at the ``op_index``-th opcode the worker
    sends on that connection, perform ``action``:

    - ``"reset"``  — drop the request on the floor and RST both sides;
    - ``"tear"``   — forward the opcode plus roughly half of its payload
      frame, then RST (a torn frame at the server, a reset at the worker);
    - ``"delay"``  — sleep ``arg`` seconds before forwarding (stall);
    - ``"stall"``  — stop relaying this connection entirely while holding
      it OPEN (no forward, no reply, no reset) until the proxy stops: the
      worker wedges inside its recv — the deterministic stand-in for a
      hung worker/host, so wedged-worker detection is testable without
      real timeouts;
    - ``"dup_reply"`` — relay the request and its reply, then send the
      reply a second time (a duplicated in-flight reply);
    - ``"call"``   — invoke ``arg()`` before forwarding (the deterministic
      trigger for out-of-band chaos, e.g. ``ShardSupervisor.kill_shard``);
    - ``"cut_stream"`` (serving protocol only, on an ``'r'`` opcode) —
      relay the stream request, forward ``arg`` reply chunk frames
      (default 1), then RST both sides: the deterministic client-reset
      MID-stream, driving the server's disconnect-reclamation path.

    WAN-grade actions (simulated-DCN chaos — docs/DEPLOY.md §2):

    - ``"partition"`` — a network partition between every worker behind
      this proxy and the upstream: the request is dropped, EVERY live
      relay pair is RST in both directions, and for ``arg`` seconds
      (default 0.5) new connections through the proxy are refused with an
      RST — then the partition HEALS and relaying resumes.  A worker's
      reconnect-resume keeps re-dialing into the partition (refused
      dials are retryable) and succeeds on heal; the injection point is
      scripted, the heal is the wall clock.
    - ``"delay_up"`` / ``"delay_down"`` — asymmetric per-direction
      latency: sleep before forwarding the *request* upstream
      (``delay_up``) or before relaying the *reply* back down
      (``delay_down``).  ``arg`` is seconds, or ``(base, jitter)`` where
      the actual delay is ``base + jitter * u`` with ``u`` drawn from the
      connection's seeded rng stream — jittered yet reproducible.
    - ``"bandwidth"`` — shape this op's request frame and its reply to
      ``arg`` bytes/second (default 1 MiB/s) by relaying in paced chunks,
      the deterministic stand-in for a thin cross-DC link.
    """

    conn: int
    op_index: int
    action: str
    arg: Any = None


class ChaosProxy:
    """Deterministic TCP fault-injection proxy for the framed opcode
    protocols (PS by default; ``protocol="serving"`` speaks the serving
    opcodes).

    Sits between workers and one PS (or one PS shard) and relays the real
    byte stream **message by message** (opcode + frame via ``read_frame``),
    so chaos tests drive the actual socket stack — connects, torn frames,
    resets, stalls — instead of monkeypatching transport functions.  Faults
    are scripted per (connection, opcode index) with ``ChaosFault`` entries
    (exact, reproducible injection points), optionally combined with a
    seeded random mode: ``auto={"reset": p, "delay": (p, seconds),
    "dup_reply": p}`` draws per-opcode from a ``random.Random`` stream
    seeded by ``(seed, connection index)``, so a given connection's fault
    sequence is a pure function of the seed and its opcode count.

    ``protocol="serving"`` relays the serving wire
    (``serving.ServingServer``): every client opcode (``'q'`` enqueue,
    ``'r'`` stream, ``'x'`` cancel, ``'k'`` kv-block transfer) carries a
    request frame; ``'q'``/``'x'``/``'k'`` get one reply frame (so
    tear/delay/reset scripts compose with a mid-transfer block frame
    exactly as with an enqueue), ``'r'`` a STREAM of chunk frames relayed
    full-duplex (a mid-stream client cancel or EOF still reaches the
    server) until the ``done`` frame — plus the serving-only
    ``"cut_stream"`` action for a deterministic client reset mid-stream.

    ``injected`` records every fault as ``(conn, op_index, action)``.
    Usable as a context manager; ``stop()`` hard-closes everything.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1", seed: int = 0,
                 faults: Sequence[ChaosFault] = (),
                 auto: Optional[Dict[str, Any]] = None,
                 protocol: str = "ps"):
        if protocol not in ("ps", "serving"):
            raise ValueError(f"protocol must be 'ps' or 'serving', "
                             f"got {protocol!r}")
        self.upstream = (upstream_host, int(upstream_port))
        self.protocol = protocol
        self.seed = int(seed)
        self.faults = [ChaosFault(*f) for f in faults]
        self.auto = dict(auto or {})
        self.injected: List[tuple] = []
        self.connections = 0
        self._lock = threading.Lock()  # guards: _pairs, connections, _partition_until
        self._partition_until = 0.0  # monotonic deadline; 0 = healed
        self._running = True
        self._stall = threading.Event()  # released by stop(): frees 'stall'
        self._pairs: List[tuple] = []  # live (client, upstream) socket pairs
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, 0))
        self._server.listen(64)
        self.host, self.port = self._server.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dkt-chaos-accept")
        self._accept_thread.start()

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def addr(self):
        return (self.host, self.port)

    def stop(self):
        self._running = False
        self._stall.set()  # unblock connections wedged on a 'stall' fault
        try:  # closing an fd does not reliably interrupt a blocked accept()
            # on Linux — wake it with a self-connection; the loop sees
            # _running=False and returns instead of serving it
            wake = socket.create_connection((self.host, self.port),
                                            timeout=1.0)
            wake.close()
        except OSError:
            pass  # listener already dead — accept has returned
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            pairs = list(self._pairs)
            self._pairs.clear()
        for a, b in pairs:
            _hard_close(a)
            _hard_close(b)
        self._accept_thread.join(timeout=5.0)

    # -- relay ---------------------------------------------------------------
    def _accept_loop(self):
        while True:
            try:
                client, _ = self._server.accept()
            except OSError:
                return
            if not self._running:
                _hard_close(client)
                return
            with self._lock:
                idx = self.connections
                self.connections += 1
            threading.Thread(target=self._serve, args=(idx, client),
                             daemon=True, name=f"dkt-chaos-conn-{idx}").start()

    def _fault_for(self, conn: int, op_index: int,
                   rng: random.Random) -> Optional[ChaosFault]:
        for f in self.faults:
            if f.conn in (-1, conn) and f.op_index == op_index:
                return f
        for action, spec in self.auto.items():
            p, arg = (spec if isinstance(spec, (tuple, list))
                      else (spec, None))
            if rng.random() < float(p):
                return ChaosFault(conn, op_index, action, arg)
        return None

    def _partitioned(self) -> bool:
        with self._lock:
            return time.monotonic() < self._partition_until

    def _begin_partition(self, heal_after: float):
        """Drop both directions: RST every live relay pair and refuse new
        connections until the heal deadline."""
        with self._lock:
            self._partition_until = max(
                self._partition_until, time.monotonic() + heal_after)
            pairs = list(self._pairs)
            self._pairs.clear()
        for a, b in pairs:
            _hard_close(a)
            _hard_close(b)

    @staticmethod
    def _jittered(arg, rng: random.Random, default: float = 0.05) -> float:
        if isinstance(arg, (tuple, list)):
            base, jitter = arg
            return float(base) + float(jitter) * rng.random()
        return float(arg if arg is not None else default)

    @staticmethod
    def _send_shaped(sock: socket.socket, data, rate: float,
                     chunk: int = 4096) -> None:
        """Relay ``data`` at ``rate`` bytes/second in paced chunks."""
        mv = memoryview(data)
        for i in range(0, len(mv), chunk):
            piece = mv[i:i + chunk]
            sock.sendall(piece)
            time.sleep(len(piece) / max(rate, 1.0))

    def _serve(self, idx: int, client: socket.socket):
        if self._partitioned():
            _hard_close(client)  # dials into the partition are refused
            return
        try:
            upstream = socket.create_connection(self.upstream, timeout=10.0)
        except OSError:
            _hard_close(client)
            return
        client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        upstream.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            self._pairs.append((client, upstream))
        rng = random.Random((self.seed << 20) ^ idx)
        serving = self.protocol == "serving"
        frame_ops = ((SERVING_OP_ENQUEUE, SERVING_OP_STREAM,
                      SERVING_OP_CANCEL, SERVING_OP_KVBLOCKS) if serving
                     else (PS_OP_COMMIT, PS_OP_UPDATE))
        reply_ops = ((SERVING_OP_ENQUEUE, SERVING_OP_CANCEL,
                      SERVING_OP_KVBLOCKS, SERVING_OP_STATS) if serving
                     else (PS_OP_PULL, PS_OP_UPDATE, PS_OP_HEARTBEAT))
        op_index = 0
        try:
            while True:
                op = client.recv(1)
                if not op:
                    return
                if self._partitioned():
                    return  # mid-partition: finally RSTs both sides
                frame = read_frame(client) if op in frame_ops else None
                fault = self._fault_for(idx, op_index, rng)
                op_index += 1
                if fault is not None:
                    self.injected.append((idx, op_index - 1, fault.action))
                    if fault.action == "delay":
                        time.sleep(float(fault.arg or 0.05))
                    elif fault.action == "delay_up":
                        time.sleep(self._jittered(fault.arg, rng))
                    elif fault.action == "partition":
                        self._begin_partition(float(fault.arg or 0.5))
                        return  # this pair was just hard-closed
                    elif fault.action == "stall":
                        # hold the connection open but relay nothing more:
                        # the worker wedges in its recv until the proxy
                        # stops (the finally then RSTs both sides)
                        self._stall.wait()
                        return
                    elif fault.action == "call":
                        fault.arg()
                    elif fault.action == "reset":
                        return  # finally RSTs both sides
                    elif fault.action == "tear":
                        upstream.sendall(op)
                        if frame is not None:
                            upstream.sendall(frame[:max(9, len(frame) // 2)])
                        return
                shaped = (fault is not None and fault.action == "bandwidth")
                rate = (self._jittered(fault.arg, rng, default=1 << 20)
                        if shaped else 0.0)
                upstream.sendall(op)
                if frame is not None:
                    if shaped:
                        self._send_shaped(upstream, frame, rate)
                    else:
                        upstream.sendall(frame)
                if serving and op == b"r":
                    cut_after = (max(int(fault.arg or 1), 1)
                                 if fault is not None
                                 and fault.action == "cut_stream" else None)
                    self._relay_stream(client, upstream, cut_after)
                    if cut_after is not None:
                        return  # finally RSTs both sides mid-stream
                elif op in reply_ops:
                    reply = read_frame(upstream)
                    if fault is not None and fault.action == "delay_down":
                        time.sleep(self._jittered(fault.arg, rng))
                    if shaped:
                        self._send_shaped(client, reply, rate)
                    else:
                        client.sendall(reply)
                    if fault is not None and fault.action == "dup_reply":
                        client.sendall(reply)
        except (ConnectionError, OSError, ValueError):
            return
        finally:
            with self._lock:
                if (client, upstream) in self._pairs:
                    self._pairs.remove((client, upstream))
            _hard_close(client)
            _hard_close(upstream)

    def _relay_stream(self, client: socket.socket, upstream: socket.socket,
                      cut_after: Optional[int] = None) -> None:
        """Relay a serving ``'r'`` reply stream full-duplex: chunk frames
        upstream→client until the ``done`` frame, while any client bytes
        (a mid-stream ``'x'`` cancel, or EOF) pass through / propagate —
        the proxy never deadlocks a cancel behind the stream it is meant
        to abort.  With ``cut_after=n``, returns after relaying ``n``
        chunk frames (the caller then RSTs both sides)."""
        relayed = 0
        while True:
            readable, _, _ = select.select([client, upstream], [], [], 0.05)
            if client in readable:
                data = client.recv(1 << 16)
                if not data:
                    raise ConnectionError("client hung up mid-stream")
                upstream.sendall(data)
            if upstream in readable:
                reply = read_frame(upstream)
                client.sendall(reply)
                relayed += 1
                if cut_after is not None and relayed >= cut_after:
                    return
                msg = decode_message(reply)
                if isinstance(msg, dict) and msg.get("done"):
                    return


# ---------------------------------------------------------------------------
# deterministic process-level fault injection
# ---------------------------------------------------------------------------

class ProcessFault(NamedTuple):
    """One scripted process fault: ``at_s`` seconds after
    :meth:`ProcessChaos.start`, send ``action`` to the process slot named
    ``target``:

    - ``"kill"`` — SIGKILL: the abrupt process death (no atexit, no final
      flush, a half-written frame left on the wire);
    - ``"stop"`` — SIGSTOP: the process freezes (connections stay OPEN,
      no EOF, no RST — the wire signature of a wedged host);
    - ``"cont"`` — SIGCONT: thaw a stopped process (schedule one after
      every ``"stop"`` unless the test tears the process down itself).
    """

    target: str
    at_s: float
    action: str


class ProcessChaos:
    """Seeded SIGKILL/SIGSTOP/SIGCONT schedules over real OS processes —
    the process-level twin of :class:`ChaosProxy` (ROADMAP item 1: chaos
    for the ``ps_worker_main`` / PS-shard process rail).

    ``targets`` maps slot names to the process behind them: an ``int``
    pid, a ``subprocess.Popen``, or a zero-arg callable returning either
    (or None) — the callable form tracks a supervised slot whose pid
    changes across respawns.  Resolution happens at FIRE time, so a fault
    always lands on the slot's *current* process.

    The schedule is deterministic like the proxy's: explicit
    :class:`ProcessFault` entries, plus an optional seeded auto mode —
    ``auto={"kill": p, "stop": (p, freeze_s)}`` draws per (tick, target)
    from one ``random.Random(seed)`` stream over ``horizon_s`` seconds of
    ``tick_s`` ticks, a pure function of the constructor arguments (every
    ``"stop"`` it draws schedules its own ``"cont"`` ``freeze_s`` later).
    Execution is wall-clock best effort on a daemon thread; ``injected``
    records ``(target, at_s, action, pid)`` per delivered signal, and
    signals to already-dead slots are recorded with ``pid=None`` and
    skipped.
    """

    _SIGNALS = {"kill": signal.SIGKILL, "stop": signal.SIGSTOP,
                "cont": signal.SIGCONT}

    def __init__(self, targets: Dict[str, Any],
                 faults: Sequence[ProcessFault] = (),
                 seed: int = 0,
                 auto: Optional[Dict[str, Any]] = None,
                 tick_s: float = 0.25,
                 horizon_s: float = 5.0):
        self.targets = dict(targets)
        self.seed = int(seed)
        self.injected: List[tuple] = []
        self._schedule = [ProcessFault(*f) for f in faults]
        rng = random.Random(self.seed)
        for spec_action, spec in sorted((auto or {}).items()):
            p, arg = (spec if isinstance(spec, (tuple, list))
                      else (spec, None))
            if spec_action not in self._SIGNALS:
                raise ValueError(
                    f"auto action must be one of {sorted(self._SIGNALS)}, "
                    f"got {spec_action!r}")
            t = float(tick_s)
            while t <= float(horizon_s):
                for name in sorted(self.targets):
                    if rng.random() < float(p):
                        self._schedule.append(
                            ProcessFault(name, t, spec_action))
                        if spec_action == "stop":
                            self._schedule.append(ProcessFault(
                                name, t + float(arg or tick_s), "cont"))
                t += float(tick_s)
        self._schedule.sort(key=lambda f: (f.at_s, f.target, f.action))
        for f in self._schedule:
            if f.action not in self._SIGNALS:
                raise ValueError(
                    f"action must be one of {sorted(self._SIGNALS)}, "
                    f"got {f.action!r}")
            if f.target not in self.targets:
                raise ValueError(f"unknown target {f.target!r} "
                                 f"(have {sorted(self.targets)})")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def schedule(self) -> List[ProcessFault]:
        """The resolved (scripted + auto) schedule, fire order — a pure
        function of the constructor arguments, assertable by tests."""
        return list(self._schedule)

    def _pid_of(self, name: str) -> Optional[int]:
        tgt = self.targets.get(name)
        if callable(tgt):
            tgt = tgt()
        if tgt is None:
            return None
        pid = getattr(tgt, "pid", tgt)
        if getattr(tgt, "poll", None) is not None and tgt.poll() is not None:
            return None  # already reaped: the pid may be reused
        return int(pid)

    def _fire(self, fault: ProcessFault) -> None:
        pid = self._pid_of(fault.target)
        if pid is not None:
            try:
                os.kill(pid, self._SIGNALS[fault.action])
            except (ProcessLookupError, PermissionError):
                pid = None
        self.injected.append((fault.target, fault.at_s, fault.action, pid))

    def start(self) -> "ProcessChaos":
        t0 = time.monotonic()

        def run():
            for fault in self._schedule:
                delay = fault.at_s - (time.monotonic() - t0)
                if delay > 0 and self._stop.wait(delay):
                    return
                if self._stop.is_set():
                    return
                self._fire(fault)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="dkt-process-chaos")
        self._thread.start()
        return self

    def stop(self, thaw: bool = True) -> None:
        """Cancel undelivered faults.  ``thaw`` (default) sends SIGCONT to
        every target so no test leaves a stopped process behind."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if thaw:
            for name in sorted(self.targets):
                pid = self._pid_of(name)
                if pid is not None:
                    try:
                        os.kill(pid, signal.SIGCONT)
                    except (ProcessLookupError, PermissionError):
                        pass

    def __enter__(self) -> "ProcessChaos":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
