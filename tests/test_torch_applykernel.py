"""The numpy-path legs of tests/test_applykernel.py on the port's
``applykernel``: the apply primitives (axpy, scatter-add, row scatter-add)
fuzzed over both buffer alignments against the JAX module's numpy path
bit for bit; the full PS apply path (dense, bf16, int8, sparse, a
coalesced drain of them) through every server class; and ``resolve`` for
each spelling — ``"native"`` raises (the port's build of
``csrc/applykernel.cpp`` waits for ROADMAP queue A item 8), ``"auto"``,
``"numpy"`` and None give the numpy path."""

import numpy as np
import pytest
import torch

from distkeras_tpu import applykernel as japply
from distkeras_tpu_torch import applykernel
from distkeras_tpu_torch.networking import SparseDelta
from distkeras_tpu_torch.parameter_servers import (ADAGParameterServer,
                                                   DeltaParameterServer,
                                                   DynSGDParameterServer,
                                                   _decode_commit_msg,
                                                   _scatter_add)


def _unaligned_f32(n, rng=None):
    """A writable float32 array at a 1-byte offset (flags.aligned is
    False), the pooled-view worst case."""
    raw = bytearray(4 * n + 1)
    arr = np.frombuffer(raw, dtype=np.float32, count=n, offset=1)
    if rng is not None:
        arr[:] = rng.standard_normal(n).astype(np.float32)
    return arr


@pytest.mark.parametrize("alignment", ["aligned", "unaligned"])
@pytest.mark.parametrize("scale", [1.0, 0.25, 1.0 / 3.0, -2.7183, 0.0])
def test_axpy_bit_equal_fuzz(alignment, scale):
    rng = np.random.default_rng(hash((alignment, scale)) % (2 ** 31))
    for n in (0, 1, 7, 128, 1023):
        if alignment == "aligned":
            dst = rng.standard_normal(n).astype(np.float32)
            src = rng.standard_normal(n).astype(np.float32)
        else:
            dst = _unaligned_f32(n, rng)
            src = _unaligned_f32(n, rng)
        want = dst.copy()
        japply.axpy(None, want, src, scale)
        applykernel.axpy(None, dst, src, scale)
        np.testing.assert_array_equal(dst, want)
        assert dst.dtype == np.float32


@pytest.mark.parametrize("alignment", ["aligned", "unaligned"])
def test_scatter_add_bit_equal_fuzz(alignment):
    rng = np.random.default_rng(5 if alignment == "aligned" else 6)
    for n, k in ((1, 1), (64, 7), (512, 200), (300, 900)):
        dst = (rng.standard_normal(n).astype(np.float32)
               if alignment == "aligned" else _unaligned_f32(n, rng))
        want = dst.copy()
        # duplicates on purpose: per-coordinate accumulation ORDER is part
        # of the bit-equality contract
        idx = rng.integers(0, n, size=k).astype(np.int64)
        vals = (rng.standard_normal(k)
                * 10.0 ** rng.integers(-6, 6, k)).astype(np.float32)
        np.add.at(want, idx, vals)
        applykernel.scatter_add(None, dst, idx, vals)
        np.testing.assert_array_equal(dst, want)


def test_row_scatter_add_matches_the_jax_module():
    rng = np.random.default_rng(7)
    dst = rng.standard_normal((10, 6)).astype(np.float32)
    want = dst.copy()
    rows = np.array([0, 3, 3, 9], np.int32)
    vals = rng.standard_normal((4, 6)).astype(np.float32)
    japply.row_scatter_add(None, want, rows, vals, 0.5)
    applykernel.row_scatter_add(None, dst, rows, vals, 0.5)
    np.testing.assert_array_equal(dst, want)


SHAPES = [(33,), (8, 5), (), (64,)]
TOTAL = sum(int(np.prod(s, dtype=np.int64)) for s in SHAPES)


def _blob():
    return {"model": "{}",
            "weights": [np.zeros(s, np.float32) for s in SHAPES]}


def _wire_msgs(rng):
    """One commit per wire form, decoded as the transport boundary decodes
    them before the apply rule sees the message."""
    dense = [rng.standard_normal(s).astype(np.float32) * 0.1
             for s in SHAPES]
    bf16 = [torch.from_numpy(np.array(d)).to(torch.bfloat16) for d in dense]
    scales = [float(np.max(np.abs(d)) / 127.0) or 1.0 for d in dense]
    codes = [np.clip(np.rint(d / s), -127, 127).astype(np.int8)
             for d, s in zip(dense, scales)]
    k = 17
    idx = np.sort(rng.choice(TOTAL, k, replace=False)).astype(np.int32)
    vals = rng.standard_normal(k).astype(np.float32)
    sp_scale = float(np.max(np.abs(vals)) / 127.0) or 1.0
    sp_int8 = SparseDelta(idx, np.clip(np.rint(vals / sp_scale), -127, 127)
                          .astype(np.int8), TOTAL, sp_scale)
    return [
        {"delta": dense, "clock": 0},
        {"delta": bf16, "clock": 0},
        _decode_commit_msg({"delta": codes, "scales": scales, "clock": 0}),
        {"delta": SparseDelta(idx, vals, TOTAL), "clock": 0},
        _decode_commit_msg({"delta": sp_int8, "clock": 0}),
    ]


def _expected(msgs, scale):
    """The same commits applied by hand: f32 axpys and np.add.at."""
    center = [np.zeros(s, np.float32) for s in SHAPES]
    offs = np.concatenate(([0], np.cumsum([int(np.prod(s)) for s in SHAPES])))
    for m in msgs:
        d = m["delta"]
        if isinstance(d, SparseDelta):
            flat = np.concatenate([c.reshape(-1) for c in center])
            np.add.at(flat, d.indices.astype(np.int64),
                      d.f32_values() * np.float32(scale)
                      if scale != 1.0 else d.f32_values())
            center = [flat[offs[i]:offs[i + 1]].reshape(s)
                      for i, s in enumerate(SHAPES)]
        else:
            for c, x in zip(center, d):
                x = (x.float().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x, np.float32))
                c += x if scale == 1.0 else scale * x
    return center


@pytest.mark.parametrize("make_ps,scale", [
    (lambda kern: DeltaParameterServer(_blob(), apply_kernel=kern), 1.0),
    (lambda kern: ADAGParameterServer(_blob(), 3, apply_kernel=kern),
     1.0 / 3),
    (lambda kern: DynSGDParameterServer(_blob(), apply_kernel=kern), None),
], ids=["delta", "adag", "dynsgd"])
@pytest.mark.parametrize("kern", [None, "numpy", "auto"])
def test_apply_path_numpy(make_ps, scale, kern):
    msgs = _wire_msgs(np.random.default_rng(9))
    ps = make_ps(kern)
    assert ps._kernel is None
    for m in msgs:
        ps.handle_commit(dict(m))
    drained = make_ps(kern)
    drained.apply_drain([dict(m) for m in msgs])
    assert ps.num_updates == drained.num_updates == len(msgs)
    for a, b in zip(ps.center, drained.center):
        np.testing.assert_array_equal(a, b)
    if scale is not None:  # DynSGD's scale moves with the clock
        for a, b in zip(ps.center, _expected(msgs, scale)):
            np.testing.assert_array_equal(a, b)


def test_scatter_add_helper_scaled():
    rng = np.random.default_rng(11)
    center = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    flat = np.concatenate([c.reshape(-1) for c in center])
    idx = np.sort(rng.choice(TOTAL, 29, replace=False)).astype(np.int32)
    vals = rng.standard_normal(29).astype(np.float32)
    _scatter_add(center, SparseDelta(idx, vals, TOTAL), 0.5, kernel=None)
    np.add.at(flat, idx.astype(np.int64), vals * np.float32(0.5))
    np.testing.assert_array_equal(
        np.concatenate([c.reshape(-1) for c in center]), flat)
    with pytest.raises(ValueError, match="dense length"):
        _scatter_add(center, SparseDelta(idx, vals, TOTAL + 1))


def test_python_path_serves_applies_when_native_absent():
    """With no native module (the port's state until ROADMAP queue A item
    8), 'auto' resolves to the numpy path and the apply works."""
    assert applykernel.have_native() is False
    assert applykernel.resolve("auto") is None
    assert applykernel.resolve(None) is None
    assert applykernel.resolve("numpy") is None
    with pytest.raises(RuntimeError, match="queue A item 8"):
        applykernel.resolve("native")
    with pytest.raises(RuntimeError, match="queue A item 8"):
        DeltaParameterServer(_blob(), apply_kernel="native")
    ps = DeltaParameterServer(_blob(), apply_kernel="auto")
    assert ps._kernel is None  # the numpy path is live
    d = [np.full(s, 2.0, np.float32) for s in SHAPES]
    ps.handle_commit({"delta": d, "clock": 0})
    idx = np.array([0, 1], np.int32)
    ps.handle_commit({"delta": SparseDelta(idx, np.ones(2, np.float32),
                                           TOTAL), "clock": 0})
    assert ps.num_updates == 2
    np.testing.assert_array_equal(ps.center[0][:2], np.full(2, 3.0))
    np.testing.assert_array_equal(ps.center[0][2:], np.full(31, 2.0))


def test_resolve_rejects_unknown_names():
    assert applykernel.KERNEL_CHOICES == japply.KERNEL_CHOICES
    with pytest.raises(ValueError, match="apply_kernel"):
        applykernel.resolve("cuda")
