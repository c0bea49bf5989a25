"""The epoch layout and the worker mesh of the port against the JAX
package.

``num_rounds``, ``round_block``, ``round_stream`` and ``shape_epoch_data``
must give the JAX package's arrays to the bit (values, dtypes, shapes)
over a grid of (rows, workers, window, batch), wrap-padded tails
included.  ``prefetch_to_device`` keeps order and count and refuses an
item of the wrong arity, as the JAX function does.  ``get_mesh`` builds the
worker mesh: one device named N times runs N workers, more workers than
devices raises, and workers on distinct devices raise for the engine.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu.data import pipeline as jpipe
from distkeras_tpu.parallel.spmd import shape_epoch_data as jshape
from distkeras_tpu_torch.data import pipeline
from distkeras_tpu_torch.device import host_to_device
from distkeras_tpu_torch.parallel import (WORKER_AXIS, get_mesh,
                                          shape_epoch_data)
from distkeras_tpu_torch.parallel.mesh import same_device, worker_device

torch.set_num_threads(1)

# (rows, workers, window, batch): exact fits, ragged tails, a tail shorter
# than one batch, fewer rows than one round, one worker, wide windows
GRID = [(96, 2, 3, 16), (100, 2, 3, 16), (1000, 8, 4, 32), (7, 4, 2, 8),
        (513, 1, 12, 64), (60, 3, 5, 4), (4096, 8, 4, 32), (33, 4, 1, 8),
        (200, 4, 3, 8), (1, 1, 1, 1), (61, 6, 2, 5)]


def columns(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 3, 2)).astype(np.float32)
    y = rng.integers(0, 10, rows).astype(np.int64)
    return x, y


@pytest.mark.parametrize("rows,n,w,b", GRID)
def test_round_block_and_num_rounds_bit_identical(rows, n, w, b):
    rounds = pipeline.num_rounds(rows, n, w, b)
    assert rounds == jpipe.num_rounds(rows, n, w, b)
    for r in range(rounds):
        sel, mask = pipeline.round_block(rows, n, w, b, r)
        jsel, jmask = jpipe.round_block(rows, n, w, b, r)
        for got, want in ((sel, jsel), (mask, jmask)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,n,w,b", GRID)
def test_shape_epoch_data_bit_identical(rows, n, w, b):
    x, y = columns(rows, rows)
    got = shape_epoch_data(x, y, n, w, b)
    want = jshape(x, y, n, w, b)
    assert got[-1] == want[-1]
    for g, j in zip(got[:-1], want[:-1]):
        assert g.dtype == j.dtype and g.shape == j.shape
        np.testing.assert_array_equal(g, j)
    mask = got[2]
    # every real row exactly once with mask 1; padding spread over workers
    assert mask.sum() == rows
    if rows >= n * w * b:
        assert (mask.sum(axis=(0, 1, 3)) > 0).all()


def test_shape_epoch_data_with_segment_ids_bit_identical():
    x, y = columns(100)
    seg = np.arange(100 * 4).reshape(100, 4).astype(np.int32)
    got = shape_epoch_data(x, y, 2, 3, 16, columns_seg=seg)
    want = jshape(x, y, 2, 3, 16, columns_seg=seg)
    for g, j in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("rows,n", [(0, 1), (3, 4)])
def test_num_rounds_refusals_match_jax(rows, n):
    with pytest.raises(ValueError) as jerr:
        jpipe.num_rounds(rows, n, 2, 8)
    with pytest.raises(ValueError) as perr:
        pipeline.num_rounds(rows, n, 2, 8)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("shuffle_seed,with_seg", [(None, False), (5, False),
                                                   (7, True)])
def test_round_stream_bit_identical(shuffle_seed, with_seg):
    x, y = columns(150, 3)
    seg = np.arange(150, dtype=np.int32) if with_seg else None
    got = list(pipeline.round_stream(x, y, 3, 2, 8, shuffle_seed, seg))
    want = list(jpipe.round_stream(x, y, 3, 2, 8, shuffle_seed, seg))
    assert len(got) == len(want) == pipeline.num_rounds(150, 3, 2, 8)
    for g, j in zip(got, want):
        assert len(g) == len(j) == (4 if with_seg else 3)
        for a, b in zip(g, j):
            np.testing.assert_array_equal(a, b)


def test_round_stream_matches_shape_epoch_data():
    x, y = columns(200, 4)
    xb, yb, mb, rounds = shape_epoch_data(x, y, 4, 3, 8)
    for r, (xs, ys, ms) in enumerate(pipeline.round_stream(x, y, 4, 3, 8)):
        np.testing.assert_array_equal(xs, xb[r])
        np.testing.assert_array_equal(ys, yb[r])
        np.testing.assert_array_equal(ms, mb[r])
    assert r == rounds - 1


@pytest.mark.parametrize("buffer_size", [1, 2, 3])
def test_prefetch_keeps_order_and_count(buffer_size):
    items = [(np.full((2,), i, np.float64), np.array([i], np.int64))
             for i in range(5)]
    out = list(pipeline.prefetch_to_device(iter(items), ("cpu", "cpu"),
                                           buffer_size))
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        assert a.dtype == torch.float32 and a.tolist() == [i, i]
        assert b.dtype == torch.int64 and b.tolist() == [i]


def test_prefetch_refuses_an_item_of_the_wrong_arity():
    items = [(np.zeros(2), np.zeros(2), np.zeros(2))]
    with pytest.raises(ValueError, match="3 arrays but 2 devices"):
        list(pipeline.prefetch_to_device(iter(items), ("cpu", "cpu")))


def test_host_to_device_stores_f64_as_f32():
    t = host_to_device(np.arange(3, dtype=np.float64), torch.device("cpu"))
    assert t.dtype == torch.float32
    t = host_to_device(torch.arange(3), torch.device("cpu"),
                       non_blocking=True)
    assert t.dtype == torch.int64


def test_worker_mesh_on_one_repeated_device():
    mesh = get_mesh(8, devices=["cpu"] * 8)
    assert mesh.axis_names == (WORKER_AXIS,) and mesh.size == 8
    assert dict(mesh.shape) == {WORKER_AXIS: 8}
    assert worker_device(mesh) == torch.device("cpu")
    assert get_mesh(3, devices=["cpu"] * 8).size == 3
    assert get_mesh(devices=["cpu"] * 2).size == 2


def test_worker_mesh_refusals():
    with pytest.raises(ValueError, match="exceeds"):
        get_mesh(4, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_mesh()
    # distinct devices without a process group of the mesh's size
    with pytest.raises(RuntimeError, match="start 2 processes"):
        worker_device(get_mesh(2, devices=["cpu", "meta"]))


def test_same_device():
    assert same_device(torch.device("cpu"), torch.device("cpu"))
    assert not same_device(torch.device("cpu"), torch.device("meta"))
