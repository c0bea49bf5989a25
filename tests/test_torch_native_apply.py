"""The port's native apply kernel (its own build of
``csrc/applykernel.cpp``, compiled with ``-ffp-contract=off``) bit for bit
against the numpy path and against the JAX package's module: the dense
axpy over aligned and byte-unaligned buffers at several scales, the
sequential scatter-add with duplicated indices (the accumulation order is
part of the contract), and the row scatter-add of a row-sparse commit.
The JAX package's native route is its ``csrc/applykernel.cpp`` built for
these tests (``torch_jax_native``), whatever the checkout's in-place
builds hold."""

import numpy as np
import pytest
import torch

from distkeras_tpu import applykernel as japply
from distkeras_tpu_torch import applykernel
from torch_jax_native import load as load_jax_native

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_native_apply(monkeypatch):
    """The JAX package's apply kernel from its own build, not the tree's."""
    monkeypatch.setattr(japply, "_native", load_jax_native("applykernel"))

SCALES = [1.0, 0.25, 1.0 / 3.0, -2.7183, 0.0, 1e-7]
SIZES = [0, 1, 7, 128, 1023]


def _f32(n, rng, aligned):
    """A writable float32 array, or one at a 1-byte offset (flags.aligned
    False: a pooled receive view's worst case)."""
    if aligned:
        return rng.standard_normal(n).astype(np.float32)
    raw = bytearray(4 * n + 1)
    arr = np.frombuffer(raw, dtype=np.float32, count=n, offset=1)
    arr[:] = rng.standard_normal(n).astype(np.float32)
    return arr


@pytest.fixture(scope="module")
def kernel():
    k = applykernel.resolve("native")
    assert k.__name__ == "distkeras_tpu_torch._applykernel"
    return k


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("n", SIZES)
def test_axpy_native_bit_equal(kernel, n, scale, aligned):
    rng = np.random.default_rng(n * 7 + SCALES.index(scale))
    dst, src = _f32(n, rng, aligned), _f32(n, rng, aligned)
    want, jax_want = dst.copy(), dst.copy()
    applykernel.axpy(None, want, src, scale)
    japply.axpy(japply.resolve("native"), jax_want, src, scale)
    applykernel.axpy(kernel, dst, src, scale)
    np.testing.assert_array_equal(dst.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(dst.view(np.uint32),
                                  jax_want.view(np.uint32))


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n,k", [(1, 1), (64, 7), (512, 200), (300, 900)])
def test_scatter_add_native_bit_equal(kernel, n, k, aligned):
    rng = np.random.default_rng(n + k)
    dst = _f32(n, rng, aligned)
    want = dst.copy()
    idx = rng.integers(0, n, size=k).astype(np.int64)  # duplicates
    vals = (rng.standard_normal(k)
            * 10.0 ** rng.integers(-6, 6, k)).astype(np.float32)
    applykernel.scatter_add(None, want, idx, vals)
    applykernel.scatter_add(kernel, dst, idx, vals)
    np.testing.assert_array_equal(dst.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("scale", [1.0, 0.5, 1.0 / 3.0])
def test_row_scatter_add_native_bit_equal(kernel, scale):
    """A row-sparse commit into a (200, 32) table: each touched row one
    axpy, a duplicated row accumulated in order."""
    rng = np.random.default_rng(3)
    dst = rng.standard_normal((200, 32)).astype(np.float32)
    want, jax_want = dst.copy(), dst.copy()
    rows = np.array([0, 17, 17, 199, 64], np.int32)
    vals = rng.standard_normal((5, 32)).astype(np.float32)
    applykernel.row_scatter_add(None, want, rows, vals, scale)
    japply.row_scatter_add(None, jax_want, rows, vals, scale)
    applykernel.row_scatter_add(kernel, dst, rows, vals, scale)
    np.testing.assert_array_equal(dst.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(want, jax_want)
