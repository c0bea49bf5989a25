"""The port's streaming ingestion (``streaming.py``: ``StreamBuffer``,
``StreamSource``, ``feed_stream``) against the JAX module's, on the CPU.

 - **The bounded buffer**: FIFO order across the ring's wrap, owned
   copies out, producer backpressure (a push blocks on a full ring until
   a consumer drains it, and times out with none), shape checks, the
   same-thread grow; the port's buffer and the JAX one give the same rows
   and counters for the same numpy-seeded pushes and takes.  bf16 rows
   ride a torch ring (the port's wire has no ``ml_dtypes``).
 - **The generator source** reads in order to exhaustion, row for row as
   the JAX ``StreamSource`` over the same generator.
 - **The socket feed** receives every frame into the pool's reusable
   scratch (a counting pool), hands out owned copies, and ends at the
   ``{"end"}`` frame or at EOF; ``addr=`` dials a feed server.
 - **The wire**: a JAX ``feed_stream`` into the port's source and the
   port's ``feed_stream`` into the JAX source carry the same rows, bf16
   rows included.

Socket legs use ``socket.socketpair()`` or an ephemeral port; waits are
for states, not times.
"""

import socket
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu import networking as jnet
from distkeras_tpu import streaming as jstream
from distkeras_tpu_torch import StreamBuffer, StreamSource, networking
from distkeras_tpu_torch.streaming import feed_stream

torch.set_num_threads(1)

V, C = 64, 4


def wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "state not reached"
        time.sleep(0.001)


def chunks(n, rows=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, rows).astype(np.int32).reshape(-1, 1),
             rng.standard_normal((rows, C)).astype(np.float32))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the bounded buffer
# ---------------------------------------------------------------------------

def test_buffer_rows_fifo_and_copies():
    buf = StreamBuffer(capacity_rows=8)
    x = np.arange(6, dtype=np.int32).reshape(6, 1)
    y = np.arange(12, dtype=np.float32).reshape(6, 2)
    buf.push(x, y)
    ax, ay = buf.take(4)
    np.testing.assert_array_equal(ax[:, 0], [0, 1, 2, 3])
    np.testing.assert_array_equal(ay, y[:4])
    assert ax.flags["OWNDATA"] and ay.flags["OWNDATA"]  # safe to keep
    buf.push(x[:4] + 100, y[:4])  # wraps around the ring
    bx, _ = buf.take(10)
    np.testing.assert_array_equal(bx[:, 0], [4, 5, 100, 101, 102, 103])
    buf.close()
    assert buf.take(1) is None
    with pytest.raises(RuntimeError, match="close"):
        buf.push(x, y)
    assert buf.rows_in == 10 and buf.rows_out == 10 and buf.grows == 0


def test_buffer_backpressure_blocks_the_producer():
    """push() blocks while the ring is full and resumes when a consumer
    drains it."""
    buf = StreamBuffer(capacity_rows=4)
    x = np.arange(8, dtype=np.int32).reshape(8, 1)
    y = np.ones((8, 1), np.float32)
    done = threading.Event()

    def producer():
        buf.push(x, y)  # 8 rows through a 4-row ring: blocks mid-way
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    wait_for(lambda: len(buf) == 4)  # the ring is full...
    assert not done.is_set() and t.is_alive()  # ...and the producer waits
    ax, _ = buf.take(8)
    bx, _ = buf.take(8)
    assert done.wait(20.0)
    t.join()
    np.testing.assert_array_equal(np.concatenate([ax, bx])[:, 0],
                                  np.arange(8))


def test_buffer_push_times_out_without_a_consumer():
    buf = StreamBuffer(capacity_rows=4)
    with pytest.raises(TimeoutError):
        buf.push(np.zeros((8, 1), np.int32), np.zeros((8, 1), np.float32),
                 timeout=0.01)
    assert len(buf) == 4  # the ring filled before the push gave up
    with pytest.raises(TimeoutError):
        StreamBuffer(4).take(1, timeout=0.01)


def test_buffer_shape_mismatch_rejected():
    buf = StreamBuffer(capacity_rows=8)
    buf.push(np.zeros((2, 3), np.float32), np.zeros((2, 1), np.float32))
    with pytest.raises(ValueError, match="shaped"):
        buf.push(np.zeros((2, 4), np.float32), np.zeros((2, 1), np.float32))
    with pytest.raises(ValueError, match="rows"):
        buf.push(np.zeros((2, 3), np.float32), np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError, match="capacity_rows"):
        StreamBuffer(0)


def test_buffer_grows_for_a_same_thread_producer():
    buf = StreamBuffer(capacity_rows=4)
    x = np.arange(3, dtype=np.int32).reshape(3, 1)
    buf.push(x, x.astype(np.float32))
    buf.take(2)  # the head moves: the grow must unwrap the ring
    buf.push(x + 10, x.astype(np.float32), block=False)
    buf.push(x + 20, x.astype(np.float32), block=False)
    assert buf.grows >= 1 and buf.capacity >= 7 and len(buf) == 7
    out, _ = buf.take(100)
    np.testing.assert_array_equal(out[:, 0],
                                  [2, 10, 11, 12, 20, 21, 22])


def test_buffer_keeps_bf16_rows_in_a_torch_ring():
    buf = StreamBuffer(capacity_rows=4)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2).to(torch.bfloat16)
    y = np.arange(3, dtype=np.int32)
    buf.push(x, y)
    buf.push(x + 8, y, block=False)
    ax, ay = buf.take(10)
    assert isinstance(ax, torch.Tensor) and ax.dtype == torch.bfloat16
    assert torch.equal(ax, torch.cat([x, x + 8]))
    np.testing.assert_array_equal(ay, np.concatenate([y, y]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_buffer_matches_the_jax_buffer(seed):
    """The same seeded pushes (some growing) and takes through both
    buffers: the same rows out, the same counters."""
    rng = np.random.default_rng(seed)
    ours, theirs = StreamBuffer(5), jstream.StreamBuffer(5)
    for _ in range(40):
        if rng.random() < 0.5:
            n = int(rng.integers(1, 7))
            x = rng.standard_normal((n, 3)).astype(np.float32)
            y = rng.integers(0, 9, (n, 2)).astype(np.int64)
            for b in (ours, theirs):
                b.push(x, y, block=False)
        elif len(theirs):
            k = int(rng.integers(1, 8))
            (ax, ay), (bx, by) = ours.take(k), theirs.take(k)
            np.testing.assert_array_equal(ax, bx)
            np.testing.assert_array_equal(ay, by)
    for attr in ("rows_in", "rows_out", "grows", "capacity"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert len(ours) == len(theirs)


# ---------------------------------------------------------------------------
# the generator source
# ---------------------------------------------------------------------------

def test_generator_reads_in_order_to_exhaustion():
    cs = [(np.full((3, 1), i, np.int32), np.full((3, 2), i, np.float32))
          for i in range(5)]
    src = StreamSource(generator=iter(cs), buffer_rows=4)
    x1, _ = src.read(7)  # spans chunks; the ring grows past its bound
    np.testing.assert_array_equal(x1[:, 0], [0, 0, 0, 1, 1, 1, 2])
    x2, _ = src.read(100)  # the tail: whatever is left
    np.testing.assert_array_equal(x2[:, 0], [2, 2, 3, 3, 3, 4, 4, 4])
    assert src.read(1) is None  # exhausted and drained
    assert src.buffer.rows_in == 15 and src.buffer.rows_out == 15


@pytest.mark.parametrize("sizes", [(7, 100), (32, 32, 32, 1000),
                                   (1, 5, 64, 13, 500)])
def test_generator_source_matches_the_jax_source(sizes):
    cs = chunks(9, rows=24, seed=len(sizes))
    ours = StreamSource(generator=iter(cs), buffer_rows=16)
    theirs = jstream.StreamSource(generator=iter(cs), buffer_rows=16)
    reads = list(sizes) + [50] * 8  # then on to exhaustion
    for n in reads:
        a, b = ours.read(n), theirs.read(n)
        if b is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert ours.read(1) is None and theirs.read(1) is None
    assert ours.buffer.rows_out == theirs.buffer.rows_out == 9 * 24
    assert ours.buffer.grows == theirs.buffer.grows


# ---------------------------------------------------------------------------
# the socket feed
# ---------------------------------------------------------------------------

class CountingPool(networking.BufferPool):
    def __init__(self):
        super().__init__()
        self.gets = []

    def get(self, size):
        self.gets.append(size)
        return super().get(size)


def test_socket_feed_reuses_the_pool_scratch():
    """Every frame is received into the pool: after the first frame of a
    size, each receive reuses the same scratch, and the rows handed out
    are owned copies of what was fed."""
    a, b = socket.socketpair()
    cs = chunks(10)
    feeder = threading.Thread(target=feed_stream, args=(a, cs))
    feeder.start()
    pool = CountingPool()
    src = StreamSource(sock=b, pool=pool)
    try:
        x, y = src.read(320)
        feeder.join()
        assert len(x) == 320
        np.testing.assert_array_equal(x[:32], cs[0][0])
        np.testing.assert_array_equal(y[-32:], cs[-1][1])
        assert x.flags["OWNDATA"]  # ring copies, not pool views
        assert src.read(1) is None  # {"end": True} closed the stream
        assert len(pool.gets) == 11  # 10 chunks + the end frame
        assert pool.hits >= 8 and pool.misses <= 2, (pool.hits,
                                                     pool.misses)
    finally:
        src.stop()
        a.close()


def test_socket_eof_ends_the_stream():
    a, b = socket.socketpair()
    src = StreamSource(sock=b)
    networking.send_data(a, {"x": np.zeros((4, 1), np.int32),
                             "y": np.zeros((4, C), np.float32)})
    a.close()  # EOF mid-stream, no {"end"} frame
    x, _ = src.read(100, timeout=20.0)
    assert len(x) == 4
    assert src.read(1, timeout=20.0) is None
    src.stop()


def test_addr_source_dials_a_feed_server():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    cs = chunks(3, rows=8, seed=5)

    def serve():
        conn, _ = listener.accept()
        feed_stream(conn, cs)
        conn.close()

    t = threading.Thread(target=serve)
    t.start()
    with StreamSource(addr=listener.getsockname()) as src:
        x, y = src.read(100, timeout=20.0)
        assert src.read(1, timeout=20.0) is None
    t.join()
    listener.close()
    np.testing.assert_array_equal(x, np.concatenate([c[0] for c in cs]))
    np.testing.assert_array_equal(y, np.concatenate([c[1] for c in cs]))


@pytest.mark.parametrize("kw", [{}, {"generator": iter([]),
                                     "addr": ("h", 1)},
                                {"sock": object(), "addr": ("h", 1)}])
def test_source_takes_exactly_one_backend(kw):
    for cls in (StreamSource, jstream.StreamSource):
        with pytest.raises(ValueError, match="exactly one"):
            cls(**kw)


# ---------------------------------------------------------------------------
# the wire, both ways
# ---------------------------------------------------------------------------

def _feed_into(feed, pool_net, src_cls, cs):
    a, b = socket.socketpair()
    feeder = threading.Thread(target=feed, args=(a, cs))
    feeder.start()
    src = src_cls(sock=b, pool=pool_net.BufferPool())
    try:
        got = src.read(10 ** 6, timeout=20.0)
        assert src.read(1, timeout=20.0) is None
    finally:
        feeder.join()
        src.stop()
        a.close()
    return got


@pytest.mark.parametrize("bf16", [False, True])
def test_a_jax_feed_into_the_port_source(bf16):
    cs = chunks(4, rows=8, seed=7)
    if bf16:
        cs = [(x, y.astype(ml_dtypes.bfloat16)) for x, y in cs]
    x, y = _feed_into(jstream.feed_stream, networking, StreamSource, cs)
    np.testing.assert_array_equal(x, np.concatenate([c[0] for c in cs]))
    want = np.concatenate([c[1] for c in cs])
    if bf16:
        assert isinstance(y, torch.Tensor) and y.dtype == torch.bfloat16
        np.testing.assert_array_equal(y.float().numpy(),
                                      want.astype(np.float32))
    else:
        np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("bf16", [False, True])
def test_the_port_feed_into_a_jax_source(bf16):
    cs = chunks(4, rows=8, seed=8)
    sent = cs
    if bf16:
        sent = [(x, torch.from_numpy(y).to(torch.bfloat16)) for x, y in cs]
    x, y = _feed_into(feed_stream, jnet, jstream.StreamSource, sent)
    np.testing.assert_array_equal(x, np.concatenate([c[0] for c in cs]))
    want = np.concatenate([c[1] for c in cs])
    if bf16:
        assert y.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(
            y.astype(np.float32),
            want.astype(ml_dtypes.bfloat16).astype(np.float32))
    else:
        np.testing.assert_array_equal(y, want)


def test_buffer_under_contention_delivers_every_row_once():
    """More producers and consumers than cores through a small ring with
    a shortened switch interval: every tagged row arrives exactly once."""
    import sys
    buf = StreamBuffer(capacity_rows=16)
    producers, rows_each = 10, 200
    got, lock = [], threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def produce(p):
            for i in range(0, rows_each, 5):
                tags = p * rows_each + np.arange(i, i + 5)
                buf.push(tags.reshape(-1, 1), tags.astype(np.float32),
                         timeout=60.0)

        def consume():
            while True:
                chunk = buf.take(7, timeout=60.0)
                if chunk is None:
                    return
                np.testing.assert_array_equal(chunk[0][:, 0], chunk[1])
                with lock:
                    got.extend(chunk[0][:, 0].tolist())

        ps = [threading.Thread(target=produce, args=(p,))
              for p in range(producers)]
        cs = [threading.Thread(target=consume) for _ in range(4)]
        for t in ps + cs:
            t.start()
        for t in ps:
            t.join(60.0)
        buf.close()
        for t in cs:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ps + cs)
    assert sorted(got) == list(range(producers * rows_each))
    assert buf.rows_in == buf.rows_out == producers * rows_each
