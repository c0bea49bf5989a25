"""The in-process legs of tests/test_dcn_chaos.py on the port: TCP
keepalive and the ``idle_deadline`` reaping of half-open connections on
both PS cores, the WAN-grade ``ChaosProxy`` actions (partition,
asymmetric delay, bandwidth) through the real socket stack, and worker
partition tolerance (``partition_windows``: buffer while dark, one heal
probe a window, one reconciling commit on heal, a typed ``Partitioned``
once the budget is spent).

The JAX file's ``codec`` axis takes both values here too: the chaos
actions run on the port's native codec (its default) and again with the
pure-Python codec pinned (the ``..._on_the_python_codec`` twins).  The ``ProcessChaos`` legs (signals to OS processes) and the
two-process chaos run are in ``tests/test_torch_process_elastic.py``.
"""

import random
import socket
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import DOWNPOUR, networking
from distkeras_tpu_torch.networking import ChaosFault, ChaosProxy
from distkeras_tpu_torch.parameter_servers import (DeltaParameterServer,
                                                   _enable_keepalive,
                                                   make_socket_server)
from distkeras_tpu_torch.resilience import Partitioned
from distkeras_tpu_torch.workers import DOWNPOURWorker

from test_torch_host_ps import _accuracy, make_dataset, make_model

torch.set_num_threads(1)

SHAPES = [(2048,), (3,)]


def _blob():
    """Protocol-only blob: one 8 KiB tensor so bandwidth shaping has
    something to pace, one tiny one."""
    return {"model": "{}",
            "weights": [np.zeros(s, np.float32) for s in SHAPES]}


def _model_blob(n=3):
    return {"model": make_model().to_json(),
            "weights": [np.zeros((n,), np.float32)]}


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pred()


def _heartbeat(host, port, timeout=1.0):
    """One 'h' round trip on a fresh dial; raises on a dead path."""
    sock = networking.connect(host, port)
    try:
        sock.settimeout(timeout)
        networking.send_opcode(sock, b"h")
        return networking.recv_data(sock)
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _close(*socks):
    for s in socks:
        if s is not None:
            try:
                s.close()
            except OSError:
                pass


@pytest.fixture(params=["threaded", "event"])
def core(request):
    return request.param


# ---------------------------------------------------------------------------
# half-open-connection reaping (both PS cores)
# ---------------------------------------------------------------------------

def test_enable_keepalive_tightens_probe_schedule():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname())
    conn, _ = srv.accept()
    try:
        _enable_keepalive(conn, 6.0)
        assert conn.getsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE) == 1
        if hasattr(socket, "TCP_KEEPIDLE"):
            assert conn.getsockopt(socket.IPPROTO_TCP,
                                   socket.TCP_KEEPIDLE) == 3
            assert conn.getsockopt(socket.IPPROTO_TCP,
                                   socket.TCP_KEEPINTVL) == 1
            assert conn.getsockopt(socket.IPPROTO_TCP,
                                   socket.TCP_KEEPCNT) == 3
        _enable_keepalive(cli)  # without a deadline: the OS schedule
        assert cli.getsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE) == 1
    finally:
        _close(conn, cli, srv)


def test_idle_deadline_validation(core):
    ps = DeltaParameterServer(_blob())
    for bad in (0, -1.0):
        with pytest.raises(ValueError, match="idle_deadline"):
            make_socket_server(ps, ps_core=core, idle_deadline=bad)


def test_half_open_peer_is_reaped(core):
    """A peer that vanishes without RST is reaped once it has been silent
    past ``idle_deadline``, while an active one keeps serving."""
    ps = DeltaParameterServer(_blob())
    server = make_socket_server(ps, ps_core=core, idle_deadline=0.3)
    server.start()
    ghost = live = None
    try:
        ghost = networking.connect("127.0.0.1", server.port)  # never speaks
        _wait(lambda: server.live_connections == 1)
        live = networking.connect("127.0.0.1", server.port)
        deadline = time.monotonic() + 5.0
        while server.reaped == 0 and time.monotonic() < deadline:
            networking.send_opcode(live, b"h")
            networking.recv_data(live)
            time.sleep(0.02)
        assert server.reaped == 1
        _wait(lambda: server.live_connections == 1)
        networking.send_opcode(live, b"p")
        msg = networking.recv_data(live)
        assert msg["clock"] == 0 and len(msg["weights"]) == len(SHAPES)
    finally:
        _close(ghost, live)
        server.stop()


def test_idle_deadline_off_keeps_silent_connections(core):
    """Default (idle_deadline=None): an idle connection is NOT reaped,
    however long it stays silent."""
    ps = DeltaParameterServer(_blob())
    server = make_socket_server(ps, ps_core=core)
    server.start()
    ghost = None
    try:
        ghost = networking.connect("127.0.0.1", server.port)
        _wait(lambda: server.live_connections == 1)
        time.sleep(0.45)  # > the other test's deadline, silent throughout
        assert server.reaped == 0
        assert server.live_connections == 1
    finally:
        _close(ghost)
        server.stop()


# ---------------------------------------------------------------------------
# ChaosProxy WAN-grade actions (both PS cores, both codecs)
# ---------------------------------------------------------------------------

def test_chaos_partition_refuses_dials_then_heals(core):
    ps = DeltaParameterServer(_blob())
    server = make_socket_server(ps, ps_core=core)
    server.start()
    proxy = ChaosProxy("127.0.0.1", server.port,
                       faults=[ChaosFault(0, 1, "partition", 0.4)])
    sock = None
    try:
        sock = networking.connect(proxy.host, proxy.port)
        sock.settimeout(5.0)
        networking.send_opcode(sock, b"p")          # op 0: relays fine
        assert networking.recv_data(sock)["clock"] == 0
        t0 = time.monotonic()
        networking.send_opcode(sock, b"h")          # op 1: partition fires
        with pytest.raises((ConnectionError, OSError, ValueError,
                            socket.timeout)):
            networking.recv_data(sock)              # this pair was RST
        with pytest.raises((ConnectionError, OSError, ValueError,
                            socket.timeout)):
            _heartbeat(proxy.host, proxy.port, timeout=1.0)
        healed = None
        deadline = time.monotonic() + 5.0
        while healed is None and time.monotonic() < deadline:
            try:
                healed = _heartbeat(proxy.host, proxy.port, timeout=1.0)
            except (ConnectionError, OSError, ValueError, socket.timeout):
                time.sleep(0.05)
        assert healed is not None and healed["clock"] == 0
        assert time.monotonic() - t0 >= 0.3  # the heal waited out the arg
        assert proxy.injected == [(0, 1, "partition")]
    finally:
        _close(sock)
        proxy.stop()
        server.stop()


def test_chaos_asymmetric_delay_directions(core):
    """``delay_up`` holds the REQUEST at the proxy; ``delay_down`` holds
    only the REPLY."""
    ps = DeltaParameterServer(_blob())
    server = make_socket_server(ps, ps_core=core)
    server.start()
    proxy = ChaosProxy("127.0.0.1", server.port,
                       faults=[ChaosFault(0, 0, "delay_up", 0.35),
                               ChaosFault(1, 0, "delay_down", 0.35)])
    up = down = None
    try:
        up = networking.connect(proxy.host, proxy.port)
        networking.send_opcode(up, b"c")
        networking.send_data(up, {"delta": [np.ones(s, np.float32)
                                            for s in SHAPES],
                                  "worker_id": 0, "clock": 0})
        assert ps.num_updates == 0  # held upstream of the server
        _wait(lambda: ps.num_updates == 1)
        down = networking.connect(proxy.host, proxy.port)
        down.settimeout(5.0)
        t0 = time.monotonic()
        networking.send_opcode(down, b"p")
        msg = networking.recv_data(down)
        assert time.monotonic() - t0 >= 0.3
        np.testing.assert_array_equal(np.asarray(msg["weights"][1]),
                                      np.ones(3, np.float32))
        assert proxy.injected == [(0, 0, "delay_up"),
                                  (1, 0, "delay_down")]
    finally:
        _close(up, down)
        proxy.stop()
        server.stop()


def test_chaos_jittered_delay_is_a_pure_function_of_the_seed():
    a = ChaosProxy._jittered((0.2, 0.1), random.Random((7 << 20) ^ 3))
    b = ChaosProxy._jittered((0.2, 0.1), random.Random((7 << 20) ^ 3))
    assert a == b and 0.2 <= a <= 0.3
    rng = random.Random(0)
    assert ChaosProxy._jittered(None, rng) == 0.05
    assert ChaosProxy._jittered(0.7, rng) == 0.7
    assert ChaosProxy._jittered(None, rng, default=1 << 20) == 1 << 20


def test_chaos_bandwidth_shapes_both_directions_bit_exact(core):
    """One 'u' round trip through a 32 KiB/s link: both ~8 KiB frames are
    paced and arrive BIT-EXACT."""
    ps = DeltaParameterServer(_blob())
    server = make_socket_server(ps, ps_core=core)
    server.start()
    proxy = ChaosProxy("127.0.0.1", server.port,
                       faults=[ChaosFault(0, 0, "bandwidth", 32768)])
    sock = None
    try:
        sock = networking.connect(proxy.host, proxy.port)
        sock.settimeout(10.0)
        t0 = time.monotonic()
        networking.send_opcode(sock, b"u")
        networking.send_data(sock, {"delta": [np.ones(s, np.float32)
                                              for s in SHAPES],
                                    "worker_id": 0, "clock": 0})
        msg = networking.recv_data(sock)
        assert time.monotonic() - t0 >= 0.35
        assert msg["clock"] == 1
        np.testing.assert_array_equal(np.asarray(msg["weights"][0]),
                                      np.ones(2048, np.float32))
        assert proxy.injected == [(0, 0, "bandwidth")]
    finally:
        _close(sock)
        proxy.stop()
        server.stop()


# ---------------------------------------------------------------------------
# worker partition tolerance (partition_windows > 0)
# ---------------------------------------------------------------------------

def test_partition_budget_exhaustion_raises_typed_partitioned():
    """No heal in sight: the worker buffers ``partition_windows`` windows
    of committed mass, then surfaces ``Partitioned`` (a
    ``ConnectionError``, typed apart from ``PSShardDown``)."""
    blob = _model_blob()
    ps = DeltaParameterServer(blob)
    server = make_socket_server(ps, ps_core="event")
    server.start()
    wk = DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", server.port,
                        partition_windows=2, device="cpu")
    try:
        wk.connect()
        wk.pull()
        server.crash()
        d = [np.ones(3, np.float32)]
        with pytest.raises(Partitioned) as ei:
            for _ in range(10):  # first sends may still reach dead buffers
                wk.commit(d, 0)
        assert ei.value.pending_windows == 3  # budget 2 + the overflow
        assert ei.value.addr == ("127.0.0.1", server.port)
        assert isinstance(ei.value, ConnectionError)
        assert wk.partitions == 1 and wk.reconciliations == 0
        # the partition cache still serves the last good center
        assert np.asarray(wk.pull()[0]).shape == (3,)
    finally:
        server.stop()


def test_partition_heal_reconciles_buffered_mass():
    """Through a scripted partition: the worker buffers while dark, the
    per-window heal probe adopts a fresh path once the proxy heals, and
    the buffered mass lands as ONE reconciling commit; the loss is the
    windows in flight at partition onset."""
    blob = _model_blob()
    ps = DeltaParameterServer(blob)
    server = make_socket_server(ps, ps_core="event")
    server.start()
    proxy = ChaosProxy("127.0.0.1", server.port,
                       faults=[ChaosFault(0, 2, "partition", 0.35)])
    wk = DOWNPOURWorker(blob, "sgd", "mse", proxy.host, proxy.port,
                        partition_windows=64, device="cpu")
    try:
        wk.connect()
        wk.pull()                        # op 0
        d = [np.ones(3, np.float32)]
        wk.commit(d, 0)                  # op 1: applied
        wk.commit(d, 0)                  # op 2: dropped at partition onset
        committed = 2
        deadline = time.monotonic() + 8.0
        while wk.reconciliations == 0 and time.monotonic() < deadline:
            wk.commit(d, 0)
            committed += 1
            time.sleep(0.05)
        assert wk.partitions == 1 and wk.reconciliations == 1
        center = np.asarray(wk.pull()[0])
        assert committed - 2 <= center[0] <= committed - 1
        np.testing.assert_array_equal(center, np.full(3, center[0]))
        # what still counts as landing is a lower bound of what landed
        assert sum(wk.sent_by_gen.values()) <= ps.num_updates
    finally:
        proxy.stop()
        server.stop()


def test_partition_windows_trainer_validation():
    m = make_model()
    kw = dict(num_workers=2, execution="host_ps", device="cpu")
    with pytest.raises(ValueError, match="ps_shards"):
        DOWNPOUR(m, ps_shards=2, partition_windows=4, **kw)
    with pytest.raises(ValueError, match="process_ps"):
        DOWNPOUR(m, recovery=True, partition_windows=4, **kw)
    assert DOWNPOUR(m, partition_windows=4, **kw).partition_windows == 4
    # the worker takes the serial single-socket loop only
    with pytest.raises(ValueError, match="comm_overlap"):
        DOWNPOURWorker(_model_blob(), "sgd", "mse", "127.0.0.1", 1,
                       partition_windows=2, comm_overlap=True, device="cpu")


def test_partition_windows_trains_through_the_trainer():
    """``partition_windows`` on host_ps with the serial loop: a fault-free
    run takes the knob through to every worker and learns."""
    ds = make_dataset(n=512)
    t = DOWNPOUR(make_model(), num_workers=2, batch_size=32, num_epoch=2,
                 communication_window=4, learning_rate=0.05,
                 label_col="label_encoded", execution="host_ps",
                 partition_windows=4, comm_overlap=False, device="cpu")
    fitted = t.train(ds)
    assert all(w.partition_windows == 4 and w.partitions == 0
               for w in t._ps_workers)
    assert _accuracy(fitted, ds) > 0.6


@pytest.fixture()
def python_codec(monkeypatch):
    """Pin the pure-Python wire codec (``networking._native = None``)."""
    monkeypatch.setattr(networking, "_native", None)


def test_chaos_partition_refuses_dials_then_heals_on_the_python_codec(
        core, python_codec):
    test_chaos_partition_refuses_dials_then_heals(core)


def test_chaos_asymmetric_delay_directions_on_the_python_codec(
        core, python_codec):
    test_chaos_asymmetric_delay_directions(core)


def test_chaos_bandwidth_shapes_both_directions_bit_exact_on_the_python_codec(
        core, python_codec):
    test_chaos_bandwidth_shapes_both_directions_bit_exact(core)
