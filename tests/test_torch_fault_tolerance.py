"""Worker-death tolerance on the port's host PS: the cases of
tests/test_fault_tolerance.py, the PS legs of
tests/test_determinism_faults.py, and the wait for commits that can still
land before the center is read.

``fault_tolerance=True`` lets a host-PS run survive worker death: the PS
treats a dropped socket as a normal disconnect, so the trainer finishes
with the survivors and reports the dead (``failed_workers``,
``worker_failures``).  ``fault_injection={worker_id: n}`` makes a worker
fault at its n+1-th commit.  The JAX file's process-engine leg runs the
port's worker OS processes (``execution="process_ps"``).

The wait: after each wave ``run_host_ps_training`` waits until every
server has applied the commits that can still land (a serial worker's last
commit is fire-and-forget).  A target of the clock at the wave's start
plus every commit a worker *prepared* is unreachable after a
fault-aborted commit or under a respawned shard's restored clock: each
wave would stall for the wait's 30 s and log a false "short of" warning.
The count is per (shard, generation), from the sends themselves.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import ADAG, DOWNPOUR, networking
from distkeras_tpu_torch.core.model import serialize_model
from distkeras_tpu_torch.parallel import get_mesh
from distkeras_tpu_torch.parameter_servers import (
    DeltaParameterServer, SocketParameterServer, _applied_mark,
    _await_applied, _clocks, _landing_targets)
from distkeras_tpu_torch.ps_sharding import ShardedServerGroup
from distkeras_tpu_torch.resilience import RetryPolicy, ShardSupervisor
from distkeras_tpu_torch.workers import DOWNPOURWorker

from test_torch_host_ps import make_dataset, make_model
from test_torch_host_ps_overlap import _tiny_blob

torch.set_num_threads(1)

FAST = RetryPolicy(attempts=None, backoff=0.02, max_backoff=0.2,
                   deadline=20.0, seed=0)
PS_LOGGER = "distkeras_tpu_torch.parameter_servers"


def _accuracy(fitted, ds):
    pred = fitted.predict(ds["features"])
    return float(np.mean(np.argmax(pred, axis=1) == ds["label"]))


def _ft_trainer(cls=ADAG, **kw):
    base = dict(num_workers=4, batch_size=16, num_epoch=3,
                communication_window=4, label_col="label_encoded",
                worker_optimizer="adam", learning_rate=2e-3,
                execution="host_ps", device="cpu")
    base.update(kw)
    return cls(make_model(), **base)


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------

def test_host_ps_survives_injected_worker_death(caplog):
    """4 workers, worker 1 dies at its 3rd commit: training completes on
    the survivors, the dead id is reported, the model still learns, and
    the run neither stalls on nor warns about the aborted commit."""
    ds = make_dataset(n=1024)
    t = _ft_trainer(fault_tolerance=True, fault_injection={1: 2})
    t0 = time.monotonic()
    with caplog.at_level(logging.WARNING, logger=PS_LOGGER):
        fitted = t.train(ds)
    assert time.monotonic() - t0 < 30.0  # the wait's 30 s never ran out
    assert "short of" not in caplog.text
    assert t.failed_workers == [1]
    assert "injected fault" in t.worker_failures[1]
    assert _accuracy(fitted, ds) > 0.85
    assert len(t.get_history()) > 0


def test_host_ps_tolerates_exit_fault_kind(capsys):
    """An ('exit', n) worker dies MID-FRAME via SystemExit and
    fault_tolerance still finishes on the survivors, the death diagnosable
    (the traceback text, and a line on stderr)."""
    ds = make_dataset(n=1024)
    t = _ft_trainer(fault_tolerance=True, fault_injection={1: ("exit", 2)})
    fitted = t.train(ds)
    assert t.failed_workers == [1]
    assert "SystemExit" in t.worker_failures[1]
    assert "continuing with survivors" in capsys.readouterr().err
    assert _accuracy(fitted, ds) > 0.85


def test_injected_fault_without_tolerance_raises():
    ds = make_dataset(n=512)
    t = _ft_trainer(DOWNPOUR, num_workers=2, num_epoch=1,
                    communication_window=2, worker_optimizer="sgd",
                    learning_rate=0.05, fault_injection={0: 1})
    with pytest.raises(RuntimeError, match="injected fault"):
        t.train(ds)


def test_exit_fault_without_tolerance_is_a_runtime_error():
    """An 'exit'-faulted worker thread surfaces as a training error, never
    as the process's own exit."""
    ds = make_dataset(n=512)
    t = _ft_trainer(DOWNPOUR, num_workers=2, num_epoch=1,
                    communication_window=2, worker_optimizer="sgd",
                    learning_rate=0.05, fault_injection={0: ("exit", 1)})
    with pytest.raises(RuntimeError, match="worker 0 exited"):
        t.train(ds)


def test_all_workers_dead_still_raises():
    """fault_tolerance survives SOME deaths, not total loss."""
    ds = make_dataset(n=512)
    t = _ft_trainer(num_workers=2, num_epoch=1, communication_window=2,
                    worker_optimizer="sgd", learning_rate=0.05,
                    fault_tolerance=True, fault_injection={0: 1, 1: 1})
    with pytest.raises(RuntimeError, match="all 2 workers failed"):
        t.train(ds)


def test_spmd_rejects_fault_kwargs():
    ds = make_dataset(n=256)
    for kw in (dict(fault_tolerance=True), dict(fault_injection={0: 1})):
        t = ADAG(make_model(), batch_size=16, num_epoch=1,
                 label_col="label_encoded",
                 mesh=get_mesh(2, devices=["cpu"] * 2), **kw)
        with pytest.raises(ValueError, match="fault_tolerance"):
            t.train(ds)


def test_failed_workers_reset_between_runs():
    ds = make_dataset(n=512)
    t = _ft_trainer(num_workers=2, num_epoch=1, fault_tolerance=True,
                    fault_injection={0: 1})
    t.train(ds)
    assert t.failed_workers == [0]
    t.fault_injection = None
    t.train(ds)
    assert t.failed_workers == []


def test_process_ps_survives_worker_process_death(monkeypatch):
    """Cross-process flavor: one of two OS worker processes exits nonzero
    mid-training; the driver completes with the survivor and reports it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ds = make_dataset(n=512)
    t = _ft_trainer(num_workers=2, num_epoch=4, learning_rate=4e-3,
                    execution="process_ps", fault_tolerance=True,
                    fault_injection={1: 2})
    fitted = t.train(ds)
    assert t.failed_workers == [1]
    assert t.worker_failures[1].startswith("exit code")
    # half the shard died after 2 commits: the survivor's half still
    # carries the model well past chance (0.25 for 4 classes)
    assert _accuracy(fitted, ds) > 0.7
    # only the survivor's history came back (the casualty never wrote one)
    # 256 rows a worker: 4 windows of 64 an epoch, 4 epochs
    assert len(t.get_history()) == 16


# ---------------------------------------------------------------------------
# the PS legs of tests/test_determinism_faults.py
# ---------------------------------------------------------------------------

def _start_ps():
    ps = DeltaParameterServer(serialize_model(make_model()))
    server = SocketParameterServer(ps)
    server.start()
    return ps, server


def test_ps_survives_worker_death():
    """A worker that dies mid-protocol (EOF after opcode, torn frame,
    garbage opcode) must not take down the PS or corrupt service."""
    ps, server = _start_ps()
    try:
        c1 = networking.connect("127.0.0.1", server.port)
        c1.close()
        c2 = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(c2, b"c")
        c2.sendall(b"DKT1\x10\x00\x00\x00partial")  # torn frame
        c2.close()
        c3 = networking.connect("127.0.0.1", server.port)
        c3.sendall(b"Z")
        c3.close()
        h = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(h, b"p")
        pulled = networking.recv_data(h)
        assert pulled["clock"] == 0
        delta = [np.ones_like(w) for w in pulled["weights"]]
        networking.send_opcode(h, b"c")
        networking.send_data(h, {"delta": delta, "clock": 0})
        networking.send_opcode(h, b"p")
        after = networking.recv_data(h)
        assert after["clock"] == 1
        np.testing.assert_allclose(after["weights"][0],
                                   pulled["weights"][0] + 1.0)
        networking.send_opcode(h, b"q")
        h.close()
    finally:
        server.stop()


def test_ps_concurrent_commits_all_land():
    """N threads commit concurrently; the clock counts every commit and the
    center equals the sum of all deltas (each apply under the mutex)."""
    ps, server = _start_ps()
    n_threads, commits_each = 4, 8
    try:
        def worker():
            c = networking.connect("127.0.0.1", server.port)
            for _ in range(commits_each):
                networking.send_opcode(c, b"p")
                pulled = networking.recv_data(c)
                delta = [np.ones_like(w) for w in pulled["weights"]]
                networking.send_opcode(c, b"c")
                networking.send_data(c, {"delta": delta, "clock": 0})
            networking.send_opcode(c, b"q")
            c.close()

        before = [w.copy() for w in ps.center]
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # fire-and-forget commits: wait for the clock to settle
        deadline = time.time() + 5.0
        while (ps.num_updates < n_threads * commits_each
               and time.time() < deadline):
            time.sleep(0.01)
        assert ps.num_updates == n_threads * commits_each
        np.testing.assert_allclose(
            ps.center[0], before[0] + n_threads * commits_each, atol=1e-5)
    finally:
        server.stop()


def test_stop_is_idempotent_and_unblocks():
    ps, server = _start_ps()
    accept_thread = server._accept_thread
    server.stop()
    server.stop()  # second stop must not raise
    accept_thread.join(timeout=5.0)
    assert not accept_thread.is_alive()


def test_stop_unblocks_idle_connected_handlers():
    """stop() neither hangs nor leaks with workers connected but idle: the
    event loop drains the selector and closes every connection."""
    ps, server = _start_ps()
    conns = [networking.connect("127.0.0.1", server.port) for _ in range(3)]
    try:
        deadline = time.time() + 5.0
        while server.live_connections < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert server.live_connections == 3
        assert server._conn_threads == []  # one I/O thread, no per-conn ones
        io_thread = server._accept_thread
        t0 = time.time()
        server.stop()
        assert time.time() - t0 < 5.0
        assert not io_thread.is_alive()
        assert server.live_connections == 0
        for c in conns:
            c.settimeout(2.0)
            assert c.recv(1) == b""
    finally:
        server.stop()
        for c in conns:
            c.close()


def test_stop_logs_and_force_closes_leaked_handler(caplog):
    """An I/O loop wedged inside an apply outlives stop()'s join budget:
    stop() logs it and force-closes every connection and the listener."""
    release = threading.Event()

    class WedgedPS(DeltaParameterServer):
        def _apply(self, msg):
            release.wait(20.0)  # the wedge: the apply never returns
            super()._apply(msg)

    server = SocketParameterServer(WedgedPS(serialize_model(make_model())))
    server.start()
    sock = networking.connect("127.0.0.1", server.port)
    try:
        networking.send_opcode(sock, b"c")
        networking.send_data(
            sock, {"delta": [np.zeros_like(w) for w in server.ps.center],
                   "clock": 0})
        deadline = time.time() + 5.0
        while not server.ps._lock.locked() and time.time() < deadline:
            time.sleep(0.01)
        assert server.ps._lock.locked()
        io_thread = server._accept_thread
        with caplog.at_level(logging.WARNING, logger=PS_LOGGER):
            t0 = time.time()
            server.stop(join_timeout=0.2)
        assert time.time() - t0 < 5.0
        assert "still alive" in caplog.text
        release.set()
        io_thread.join(timeout=5.0)
        assert not io_thread.is_alive()
    finally:
        release.set()
        server.stop()
        sock.close()


# ---------------------------------------------------------------------------
# the wait for commits that can still land
# ---------------------------------------------------------------------------

def _prepared_targets(server, clocks0, commits0, workers):
    """The target of a count of prepared commits: each clock at the wave's
    start plus every commit the workers prepared since (``_commits``)."""
    new = sum(w._commits for w in workers) - commits0
    return [c + new for c in clocks0]


def test_wait_targets_a_respawned_shards_restored_clock(caplog):
    """Two commits land on both shards, shard 0 is killed and respawned
    from its first snapshot (clock 0), and the worker commits twice more
    at the new generation.  Shard 0 can only reach 2: the prepared target
    (4) stalls the whole timeout and warns, the repaired one is met at
    once, with no warning."""
    blob = {"model": make_model().to_json(),
            "weights": [np.zeros((8,), np.float32),
                        np.zeros((3,), np.float32)]}
    group = ShardedServerGroup("downpour", blob, num_workers=1,
                               num_shards=2)
    group.start()
    sup = ShardSupervisor(group, "downpour", 1, liveness_deadline=0.3)
    wk = DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", group.ports[0],
                        shard_plan=group.plan, shard_addrs=group.addrs,
                        recovery=True, retry_policy=FAST, device="cpu")
    try:
        for j in range(2):
            sup.snapshot_shard(j)  # the initial-state snapshots
        mark = _applied_mark(group, [wk])
        clocks0, commits0 = _clocks(group), wk._commits
        wk.connect()
        wk.pull()
        d = [np.ones(8, np.float32), np.ones(3, np.float32)]
        wk.update(d, 0)
        wk.update(d, 0)
        sup.kill_shard(0)
        assert sup.respawn_shard(0)["restored_clock"] == 0
        wk.pull()  # resumes shard 0 and learns generation 1
        assert wk._shard_client._gens == [1, 0]
        wk.commit(d, 0)
        wk.commit(d, 0)  # fire-and-forget: the wait must cover them
        targets = _landing_targets(group, [wk], mark, sup)
        assert targets == [2, 4]
        with caplog.at_level(logging.WARNING, logger=PS_LOGGER):
            t0 = time.monotonic()
            _await_applied(group, lambda: _landing_targets(
                group, [wk], mark, sup), timeout=10.0)
            assert time.monotonic() - t0 < 5.0
            assert "short of" not in caplog.text
            assert _clocks(group) == [2, 4]
            prepared = _prepared_targets(group, clocks0, commits0, [wk])
            assert prepared == [4, 4]
            t0 = time.monotonic()
            _await_applied(group, prepared, timeout=0.3)
            assert time.monotonic() - t0 >= 0.3  # its stall
        assert "short of" in caplog.text  # ... and its false warning
        wk.disconnect()
    finally:
        group.stop()


def test_wait_skips_a_fault_aborted_commit(caplog):
    """A worker whose second commit is aborted by an injected fault
    counted it in ``_commits`` but never sent it: the prepared target is
    unreachable, the repaired one is the clock the server reaches."""
    blob = _tiny_blob()
    ps = DeltaParameterServer(blob)
    server = SocketParameterServer(ps)
    server.start()
    wk = DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", server.port,
                        fault_injection={0: 1}, device="cpu")
    try:
        mark = _applied_mark(server, [wk])
        clocks0, commits0 = _clocks(server), wk._commits
        wk.connect()
        wk.pull()
        wk.commit([np.ones(3, np.float32)], 0)
        with pytest.raises(RuntimeError, match="injected fault"):
            wk.commit([np.ones(3, np.float32)], 0)
        assert _landing_targets(server, [wk], mark) == [1]
        assert _prepared_targets(server, clocks0, commits0, [wk]) == [2]
        with caplog.at_level(logging.WARNING, logger=PS_LOGGER):
            _await_applied(server, lambda: _landing_targets(
                server, [wk], mark), timeout=10.0)
            assert "short of" not in caplog.text
            assert ps.num_updates == 1
            _await_applied(server, [2], timeout=0.2)
        assert "short of" in caplog.text
    finally:
        server.stop()


@pytest.mark.parametrize("elastic", [False, True])
def test_recovery_run_with_a_shard_killed_does_not_stall(elastic, caplog):
    """A recovery run (the static and the elastic engine) with one shard
    crash-killed mid-run finishes without the wait's stall or warning."""
    ds = make_dataset(n=1024)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=2,
             communication_window=4, learning_rate=0.1,
             label_col="label_encoded", execution="host_ps", ps_shards=2,
             recovery=True, elastic=elastic, device="cpu")
    stop = threading.Event()

    def killer():
        while getattr(t, "_ps_supervisor", None) is None \
                and not stop.is_set():
            time.sleep(0.005)
        sup = t._ps_supervisor
        while sup.group.servers[1].ps.num_updates < 3 and not stop.is_set():
            time.sleep(0.005)
        if not stop.is_set():
            sup.kill_shard(1)

    th = threading.Thread(target=killer)
    th.start()
    t0 = time.monotonic()
    try:
        with caplog.at_level(logging.WARNING, logger=PS_LOGGER):
            fitted = t.train(ds)
    finally:
        stop.set()
        th.join()
    assert time.monotonic() - t0 < 30.0  # the wait's 30 s never ran out
    assert "short of" not in caplog.text
    assert len(t._ps_supervisor.recoveries) == 1
    assert _accuracy(fitted, ds) > 0.6
