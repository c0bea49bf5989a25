"""The cases of tests/test_resilience.py on the port: survivable parameter
servers (``resilience.ShardJournal``, ``ShardSupervisor``), the
generation handshake, the single-socket and sharded reconnect-resume of
the workers, the top-k re-credit of a gen-rejected commit, the
``ChaosProxy`` faults through the real socket stack, and ``recovery=True``
through the trainers on the CPU.

Key invariants:
 - ``RetryPolicy``: jittered exponential backoff, attempt and deadline
   bounds, deterministic under a seed (``describe`` and the defaults are
   held against the JAX package in tests/test_torch_supervisors.py).
 - The **bounded-loss contract**: a shard respawned from its last snapshot
   drops exactly the windows committed after that snapshot, and commits
   resume on the restored center.
 - The **generation handshake**: a restarted shard rejects in-flight
   commits stamped with the old generation; workers re-sync from the reply
   and their per-shard clocks stay monotonic across the restart.
 - ``ShardSupervisor`` detects a crashed and a wedged shard and respawns
   it on the same address.
 - End to end: ``recovery=True`` survives a mid-run shard kill under each
   delta-family algorithm at ``ps_shards`` 1 and 3.

The JAX file's ``slow`` soak (one shard kill per epoch for 5 epochs) is
``slow`` here too.
"""

import logging
import socket
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import ADAG, DOWNPOUR, DynSGD, networking
from distkeras_tpu_torch.networking import ChaosFault, ChaosProxy
from distkeras_tpu_torch.parallel import get_mesh
from distkeras_tpu_torch.parameter_servers import (DeltaParameterServer,
                                                   SocketParameterServer)
from distkeras_tpu_torch.ps_sharding import (ShardedPSClient,
                                             ShardedServerGroup)
from distkeras_tpu_torch.resilience import (RetryPolicy, ShardJournal,
                                            ShardSupervisor)
from distkeras_tpu_torch.workers import DOWNPOURWorker

from test_torch_host_ps import _accuracy, make_dataset, make_model
from test_torch_host_ps_overlap import _tiny_blob

torch.set_num_threads(1)

#: fast-converging policy for loopback tests (kills + respawns land in ms)
FAST = RetryPolicy(attempts=None, backoff=0.02, max_backoff=0.2,
                   deadline=20.0, seed=0)


def _blob(n=8, m=3):
    return {"model": make_model().to_json(),
            "weights": [np.zeros((n,), np.float32),
                        np.zeros((m,), np.float32)]}


def _group(algorithm="downpour", num_shards=2, blob=None):
    g = ShardedServerGroup(algorithm, blob or _blob(), num_workers=1,
                           num_shards=num_shards)
    g.start()
    return g


def _supervisor(group, **kw):
    kw.setdefault("heartbeat_interval", 0.05)
    kw.setdefault("liveness_deadline", 0.3)
    kw.setdefault("snapshot_interval", 0.05)
    return ShardSupervisor(group, "downpour", 1, **kw)


def _worker(blob, host, port, **kw):
    return DOWNPOURWorker(blob, "sgd", "mse", host, port, device="cpu", **kw)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pred()


# ---------------------------------------------------------------------------
# RetryPolicy: the unified, jittered backoff contract
# ---------------------------------------------------------------------------

def test_retry_policy_delays_jitter_and_caps():
    p = RetryPolicy(attempts=6, backoff=0.1, max_backoff=0.5, jitter=0.5,
                    seed=7)
    delays = list(p.delays())
    assert len(delays) == 6
    for i, d in enumerate(delays):
        base = min(0.1 * 2 ** i, 0.5)
        assert base <= d <= base * 1.5  # jitter stretches, never shrinks
    assert delays == list(p.delays())  # seeded: deterministic
    # unseeded: two policies draw different jitter streams (herd avoidance)
    a = list(RetryPolicy(attempts=6, backoff=0.1).delays())
    b = list(RetryPolicy(attempts=6, backoff=0.1).delays())
    assert a != b


def test_retry_policy_needs_a_bound():
    with pytest.raises(ValueError, match="bound"):
        RetryPolicy(attempts=None, deadline=None)
    with pytest.raises(ValueError, match="attempts"):
        RetryPolicy(attempts=0)


def test_retry_policy_deadline_bounds_wall_clock():
    p = RetryPolicy(attempts=None, backoff=0.01, max_backoff=0.02,
                    deadline=0.1, seed=0)
    calls = []

    def always_fails():
        calls.append(1)
        raise ConnectionRefusedError

    t0 = time.perf_counter()
    with pytest.raises(ConnectionRefusedError):
        p.call(always_fails, (ConnectionRefusedError,))
    assert time.perf_counter() - t0 < 2.0
    assert len(calls) >= 2  # it did retry before the deadline cut it off


def test_retry_policy_call_succeeds_after_transient_faults():
    faults = [ConnectionResetError(), socket.timeout()]

    def flaky():
        if faults:
            raise faults.pop(0)
        return "up"

    p = RetryPolicy(attempts=5, backoff=0.001, seed=0)
    assert p.call(flaky, (ConnectionResetError, socket.timeout)) == "up"


def test_worker_connect_backoff_is_jittered(monkeypatch):
    """N workers re-dialing a restarted shard must not sleep in lockstep:
    the per-instance jitter streams differ."""
    from distkeras_tpu_torch import resilience

    def refuse(host, port, **kw):
        raise ConnectionRefusedError

    monkeypatch.setattr(networking, "connect", refuse)
    sleeps: dict = {}

    def record(key):
        def sleep(d):
            sleeps.setdefault(key, []).append(d)
        return sleep

    for key in ("a", "b"):
        monkeypatch.setattr(resilience.time, "sleep", record(key))
        wk = _worker(_tiny_blob(), "127.0.0.1", 1)
        with pytest.raises(ConnectionError, match="refused"):
            wk.connect(attempts=6, backoff=0.05)
    assert len(sleeps["a"]) == 6 and len(sleeps["b"]) == 6
    assert sleeps["a"] != sleeps["b"]  # jitter desynchronizes the herd


# ---------------------------------------------------------------------------
# heartbeat + generation handshake at the protocol level
# ---------------------------------------------------------------------------

def test_heartbeat_opcode_returns_clock_and_generation():
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps, generation=3)
    server.start()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(sock, b"h")
        msg = networking.recv_data(sock)
        assert msg["clock"] == 0 and msg["gen"] == 3
        assert "weights" not in msg  # cheap probe, no center payload
        networking.send_opcode(sock, b"q")
        sock.close()
    finally:
        server.stop()


def test_stale_generation_commit_is_rejected():
    """A commit stamped with an older generation is DROPPED; the 'u' reply
    still re-syncs the worker with the current state + generation."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps, generation=1)
    server.start()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        delta = {"delta": [np.ones(3, np.float32)], "worker_id": 0,
                 "clock": 0}
        networking.send_opcode(sock, b"u")
        networking.send_data(sock, {**delta, "gen": 0})  # stale
        msg = networking.recv_data(sock)
        assert msg["stale"] is True and msg["gen"] == 1
        assert msg["clock"] == 0  # nothing applied
        np.testing.assert_array_equal(msg["weights"][0], np.zeros(3))

        networking.send_opcode(sock, b"c")
        networking.send_data(sock, {**delta, "gen": 0})  # stale 'c': dropped
        networking.send_opcode(sock, b"u")
        networking.send_data(sock, {**delta, "gen": 1})  # current: applied
        msg = networking.recv_data(sock)
        assert "stale" not in msg and msg["clock"] == 1
        np.testing.assert_array_equal(msg["weights"][0], np.ones(3))
        sock.close()
    finally:
        server.stop()


def test_unstamped_commits_keep_working():
    """Commits without a 'gen' field apply regardless of the server
    generation."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps, generation=5)
    server.start()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(sock, b"u")
        networking.send_data(sock, {"delta": [np.ones(3, np.float32)],
                                    "worker_id": 0, "clock": 0})
        msg = networking.recv_data(sock)
        assert msg["clock"] == 1 and msg["gen"] == 5
        sock.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# snapshot journal + the bounded-loss contract
# ---------------------------------------------------------------------------

def test_shard_journal_roundtrip_and_retention(tmp_path):
    j = ShardJournal(str(tmp_path), max_to_keep=2)
    assert j.latest(0) is None
    for snap in range(1, 4):
        j.save(0, snap, [np.full((4,), float(snap), np.float32)],
               clock=snap * 10, generation=snap)
    out = j.latest(0)
    assert out["clock"] == 30 and out["generation"] == 3
    assert out["snap_id"] == 3
    np.testing.assert_array_equal(out["center"][0], np.full(4, 3.0))
    # retention: only the last max_to_keep snapshots remain on disk
    assert j._ckpt(0).all_steps() == [2, 3]
    # shards journal independently
    j.save(1, 1, [np.zeros((2, 2), np.float32)], clock=7, generation=0)
    assert j.latest(1)["clock"] == 7
    assert j.latest(0)["clock"] == 30


def test_bounded_loss_contract_across_respawn(lock_order_audit):
    """commit d1 → snapshot → commit d2 → crash → respawn: the restored
    center is exactly w0+d1 (d2 is dropped), the restored clock matches,
    a post-restart commit d3 lands on the restored center, and the
    client's view of the shard clock never runs backwards."""
    group = _group(num_shards=2)
    sup = _supervisor(group)  # loop NOT started: deterministic sequencing
    client = ShardedPSClient(group.plan, group.addrs, recovery=True,
                             policy=FAST)
    try:
        for j in range(2):
            sup.snapshot_shard(j)  # the initial-state snapshot
        client.connect()
        shapes = [w.shape for w in _blob()["weights"]]
        d1 = [np.full(s, 1.0, np.float32) for s in shapes]
        d2 = [np.full(s, 10.0, np.float32) for s in shapes]
        d3 = [np.full(s, 100.0, np.float32) for s in shapes]
        client.update({"delta": d1, "worker_id": 0, "clock": 0})
        sup.snapshot_shard(0)  # d1 is durable on shard 0
        client.update({"delta": d2, "worker_id": 0, "clock": 1})
        assert client._clocks == [2, 2]

        sup.kill_shard(0)
        rec = sup.respawn_shard(0)
        assert rec["restored_clock"] == 1  # the post-d1 snapshot
        assert rec["dropped_updates"] == 1  # exactly d2
        assert rec["generation"] == 1

        center = client.pull()  # reconnect-resumes shard 0
        assert client.resumes >= 1
        s0 = group.plan.scatter(center)[0]
        np.testing.assert_array_equal(s0[0], np.full(s0[0].shape, 1.0))
        # shard 1 never died: it kept d1+d2
        s1 = group.plan.scatter(center)[1]
        np.testing.assert_array_equal(s1[0], np.full(s1[0].shape, 11.0))
        # monotonic view: the restored shard-0 clock (1) did not roll the
        # client's baseline (2) backwards
        assert client._clocks[0] == 2 and client.clock_regressions >= 1
        assert client._gens[0] == 1

        client.update({"delta": d3, "worker_id": 0, "clock": 2})
        after = client.pull()
        a0 = group.plan.scatter(after)[0]
        np.testing.assert_array_equal(a0[0], np.full(a0[0].shape, 101.0))
    finally:
        client.abort()
        group.stop()


# ---------------------------------------------------------------------------
# the supervisor: crash and wedge detection, same-address respawn
# ---------------------------------------------------------------------------

def test_supervisor_detects_crash_and_respawns_same_port(lock_order_audit):
    group = _group(num_shards=2)
    sup = _supervisor(group)
    sup.start()
    try:
        port0 = group.servers[0].port
        sup.kill_shard(0)
        _wait(lambda: bool(sup.recoveries))
        assert sup.recoveries[0]["shard"] == 0
        assert set(sup.recoveries[0]) == {"shard", "generation",
                                          "restored_clock",
                                          "dropped_updates", "respawn_ms"}
        assert group.servers[0].port == port0  # same address
        assert group.servers[0].generation == 1
        assert sup.heartbeat(0, timeout=1.0)  # serving again
        assert sup.heartbeat(1, timeout=1.0)  # shard 1 untouched
        assert group.servers[1].generation == 0
    finally:
        sup.stop()
        group.stop()


def test_supervisor_detects_wedged_shard(caplog):
    """A shard whose apply lock is stuck fails the heartbeat deadline (the
    probe goes THROUGH the apply lock) and is respawned; neither the
    snapshot tick nor the detection loop deadlocks on the wedged lock, and
    the wedged handler's leak is logged by the respawn's stop()."""
    group = _group(num_shards=2)
    sup = _supervisor(group)
    sup.start()  # initial snapshots while healthy
    wedged = group.servers[0]
    assert wedged.ps._lock.acquire(timeout=5.0)  # the wedge: applies block
    try:
        with caplog.at_level(logging.WARNING):
            _wait(lambda: bool(sup.recoveries))
        assert sup.recoveries[0]["shard"] == 0
        assert group.servers[0] is not wedged
        assert sup.heartbeat(0, timeout=1.0)  # fresh PS, fresh lock
        assert sup.heartbeat(1, timeout=1.0)  # the healthy shard never left
        assert "still alive" in caplog.text
    finally:
        wedged.ps._lock.release()
        sup.stop()
        group.stop()


# ---------------------------------------------------------------------------
# single-socket PSWorker reconnect-resume
# ---------------------------------------------------------------------------

def test_single_socket_worker_reconnect_resume():
    """The PS crashes and a replacement (generation 1, restored state)
    binds the same port; the worker re-dials mid-run, re-syncs, and its
    stale-generation in-flight commit is rejected rather than applied."""
    blob = _tiny_blob()
    ps = DeltaParameterServer(blob)
    server = SocketParameterServer(ps)
    server.start()
    port = server.port
    wk = _worker(blob, "127.0.0.1", port, recovery=True, retry_policy=FAST)
    replacement = [None]
    crashed = threading.Event()
    try:
        wk.connect()
        wk.pull()
        assert wk._gen == 0
        applied, center = wk.update([np.ones(3, np.float32)], 0)
        assert wk._last_clock == 1
        center = [np.array(w) for w in center]

        def restart():
            crashed.wait()
            time.sleep(0.3)  # the worker must actually wait through this
            ps2 = DeltaParameterServer(
                {"model": blob["model"], "weights": center})
            ps2.num_updates = 1
            srv = SocketParameterServer(ps2, port=port, generation=1)
            srv.start()
            replacement[0] = srv

        rt = threading.Thread(target=restart)
        rt.start()
        server.crash()
        crashed.set()
        # mid-run op against the dead PS: reconnect-resume, not a raise
        w = wk.pull()
        rt.join()
        assert wk.resumes >= 1 and wk._gen == 1
        np.testing.assert_array_equal(np.asarray(w[0]), np.ones(3))
        applied, center = wk.update([np.ones(3, np.float32)], 0)
        assert wk._last_clock == 2
        np.testing.assert_array_equal(np.asarray(center[0]), np.full(3, 2.0))
        wk.disconnect()
    finally:
        server.stop()
        if replacement[0] is not None:
            replacement[0].stop()


def test_worker_without_recovery_still_fails_fast():
    """recovery=False (default): a mid-run transport fault raises."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    wk = _worker(_tiny_blob(), "127.0.0.1", server.port)
    try:
        wk.connect()
        wk.pull()
        server.crash()
        with pytest.raises((ConnectionError, OSError)):
            for _ in range(3):  # first op may still drain a buffered reply
                wk.pull()
        assert wk.resumes == 0
    finally:
        server.stop()


def test_recovery_knob_validation():
    m = make_model()
    kw = dict(num_workers=2, label_col="label_encoded", device="cpu")
    t = ADAG(m, execution="host_ps", recovery=True, **kw)
    assert t.recovery is True and t.recovery_policy is None
    assert ADAG(m, execution="host_ps", **kw).recovery is False
    t = ADAG(m, execution="host_ps", recovery=True, recovery_policy=FAST,
             **kw)
    assert t.recovery_policy is FAST
    with pytest.raises(ValueError, match="recovery"):
        # SPMD: resume is the recovery story
        ADAG(m, recovery=True, label_col="label_encoded",
             mesh=get_mesh(2, devices=["cpu"] * 2))
    # process_ps recovery rides the supervised (elastic) engine only, and
    # takes no policy object (the config travels as JSON)
    with pytest.raises(ValueError, match="recovery"):
        ADAG(m, execution="process_ps", recovery=True, **kw)
    with pytest.raises(ValueError, match="recovery_policy"):
        ADAG(m, execution="process_ps", recovery=True, elastic=True,
             recovery_policy=FAST, **kw)
    t2 = ADAG(m, execution="process_ps", recovery=True, elastic=True, **kw)
    assert t2.recovery and t2.elastic


# ---------------------------------------------------------------------------
# top-k residual re-sync across shard restarts (wire_dtype="topk")
# ---------------------------------------------------------------------------

def test_topk_stale_commit_recredits_residual():
    """A gen-rejected sparse commit re-credits its as-applied mass into the
    error-feedback residual (at density 1.0 the arithmetic is exact)."""
    blob = {"model": make_model().to_json(),
            "weights": [np.zeros((8,), np.float32)]}
    ps = DeltaParameterServer(blob)
    server = SocketParameterServer(ps, generation=1)
    server.start()
    try:
        wk = _worker(blob, "127.0.0.1", server.port, wire_dtype="topk",
                     wire_topk=1.0)
        wk.connect()
        wk._gen = 0  # pretend our view predates a respawn (old generation)
        delta = [np.arange(1, 9, dtype=np.float32)]
        applied, center = wk.update(delta, 0)
        # the commit was DROPPED (stale gen): center untouched, clock 0
        np.testing.assert_array_equal(np.asarray(center[0]), np.zeros(8))
        assert wk._last_clock == 0 and wk.recredits == 1
        np.testing.assert_allclose(wk._residual_flat, delta[0], atol=1e-7)
        # the stale reply re-synced the generation; a zero follow-up commit
        # ships exactly the re-credited mass
        assert wk._gen == 1
        applied, center = wk.update([np.zeros(8, np.float32)], 0)
        np.testing.assert_allclose(np.asarray(center[0]), delta[0],
                                   atol=1e-6)
        np.testing.assert_allclose(wk._residual_flat, 0.0, atol=1e-7)
        wk.disconnect()
    finally:
        server.stop()


def test_topk_sharded_recredit_only_the_stale_shard():
    """Only the gen-rejecting shard's split is re-credited: the surviving
    shard's slice applied and must NOT be double-counted."""
    blob = _blob(8, 3)
    group = _group(num_shards=2, blob=blob)
    try:
        wk = _worker(blob, "127.0.0.1", group.ports[0],
                     shard_plan=group.plan, shard_addrs=group.addrs,
                     wire_dtype="topk", wire_topk=1.0)
        wk.connect()
        wk.pull()  # learn every shard's generation (0)
        group.servers[0].generation = 1  # shard 0 "respawned"
        total = group.plan.flat_elements()
        delta_flat = np.arange(1, total + 1, dtype=np.float32)
        delta = []
        off = 0
        for w in blob["weights"]:
            delta.append(delta_flat[off:off + w.size].reshape(w.shape))
            off += w.size
        wk.update(delta, 0)
        assert wk._shard_client.last_stale == [True, False]
        assert wk.recredits == 1
        owner = group.plan.shard_of_flat(np.arange(total))
        res = wk._residual_flat
        np.testing.assert_allclose(res[owner == 0], delta_flat[owner == 0],
                                   atol=1e-7)
        np.testing.assert_allclose(res[owner == 1], 0.0, atol=1e-7)
        gathered, clocks = group.snapshot()
        flat_c = np.concatenate([g.reshape(-1) for g in gathered])
        np.testing.assert_allclose(flat_c[owner == 1],
                                   delta_flat[owner == 1], atol=1e-6)
        np.testing.assert_allclose(flat_c[owner == 0], 0.0, atol=1e-7)
        wk.disconnect()
    finally:
        group.stop()


# ---------------------------------------------------------------------------
# ChaosProxy: deterministic faults through the real socket stack
# ---------------------------------------------------------------------------

def test_chaos_proxy_is_transparent_without_faults():
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        with ChaosProxy("127.0.0.1", server.port) as proxy:
            sock = networking.connect(proxy.host, proxy.port)
            networking.send_opcode(sock, b"u")
            networking.send_data(sock, {"delta": [np.ones(3, np.float32)],
                                        "worker_id": 0, "clock": 0})
            msg = networking.recv_data(sock)
            assert msg["clock"] == 1
            np.testing.assert_array_equal(msg["weights"][0], np.ones(3))
            networking.send_opcode(sock, b"q")
            sock.close()
            assert proxy.injected == []
    finally:
        server.stop()


def test_chaos_proxy_scripted_reset_triggers_resume():
    """A scripted reset at an exact opcode index: the worker
    reconnect-resumes through the proxy and the dropped request is the
    only loss (and no longer counts as a commit that can land)."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        with ChaosProxy("127.0.0.1", server.port, seed=1,
                        faults=[ChaosFault(0, 2, "reset")]) as proxy:
            wk = _worker(_tiny_blob(), proxy.host, proxy.port,
                         recovery=True, retry_policy=FAST)
            wk.connect()
            wk.pull()                                    # op 0
            wk.update([np.ones(3, np.float32)], 0)       # op 1
            wk.update([np.ones(3, np.float32)], 0)       # op 2: reset
            assert wk.resumes >= 1
            assert proxy.injected == [(0, 2, "reset")]
            assert ps.num_updates == 1
            assert sum(wk.sent_by_gen.values()) == ps.num_updates
            wk.disconnect()
    finally:
        server.stop()


def test_chaos_proxy_torn_frame_drops_connection_center_untouched():
    """A torn 'u' frame: the server drops that connection without
    applying, and the worker recovers."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        with ChaosProxy("127.0.0.1", server.port, seed=1,
                        faults=[ChaosFault(0, 1, "tear")]) as proxy:
            wk = _worker(_tiny_blob(), proxy.host, proxy.port,
                         recovery=True, retry_policy=FAST)
            wk.connect()
            wk.pull()                               # op 0
            wk.update([np.ones(3, np.float32)], 0)  # op 1: torn mid-frame
            assert wk.resumes >= 1
            assert ps.num_updates == 0  # the torn commit never applied
            applied, center = wk.update([np.ones(3, np.float32)], 0)
            assert ps.num_updates == 1
            np.testing.assert_array_equal(np.asarray(center[0]), np.ones(3))
            wk.disconnect()
    finally:
        server.stop()


def test_chaos_proxy_duplicated_reply_is_discarded():
    """A duplicated 'u' reply must not desync the pipeline: the worker
    discards the stale duplicate."""
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        with ChaosProxy("127.0.0.1", server.port, seed=1,
                        faults=[ChaosFault(0, 1, "dup_reply")]) as proxy:
            wk = _worker(_tiny_blob(), proxy.host, proxy.port,
                         recovery=True, retry_policy=FAST)
            wk.connect()
            wk.pull()
            wk.update([np.ones(3, np.float32)], 0)  # reply duplicated
            applied, center = wk.update([np.ones(3, np.float32)], 0)
            assert wk.stale_replies == 1  # the duplicate was discarded
            assert wk._last_clock == 2
            np.testing.assert_array_equal(np.asarray(center[0]),
                                          np.full(3, 2.0))
            wk.disconnect()
    finally:
        server.stop()


def test_chaos_proxy_delay_stalls_the_round_trip():
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        with ChaosProxy("127.0.0.1", server.port,
                        faults=[ChaosFault(0, 0, "delay", 0.25)]) as proxy:
            sock = networking.connect(proxy.host, proxy.port)
            t0 = time.perf_counter()
            networking.send_opcode(sock, b"p")
            networking.recv_data(sock)
            assert time.perf_counter() - t0 >= 0.25
            sock.close()
    finally:
        server.stop()


def test_chaos_proxy_seeded_auto_faults_are_reproducible():
    """auto mode's per-opcode decision stream is a pure function of
    (seed, connection); live traffic shows faults land and the worker
    survives them."""
    import random

    def stream(seed, conn, n=20):
        proxy = ChaosProxy.__new__(ChaosProxy)  # decision logic only
        proxy.faults = []
        proxy.auto = {"reset": 0.3}
        rng = random.Random((seed << 20) ^ conn)
        return [(f.action if f is not None else None)
                for f in (proxy._fault_for(conn, i, rng) for i in range(n))]

    for conn in range(4):
        assert stream(42, conn) == stream(42, conn)
    assert stream(42, 0) != stream(42, 1)
    assert stream(42, 0) != stream(7, 0)
    assert any(a == "reset" for a in stream(42, 0))

    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        with ChaosProxy("127.0.0.1", server.port, seed=42,
                        auto={"reset": 0.3}) as proxy:
            wk = _worker(_tiny_blob(), proxy.host, proxy.port,
                         recovery=True, retry_policy=FAST.replace(seed=42))
            wk.connect()
            wk.pull()
            for _ in range(6):
                wk.update([np.ones(3, np.float32)], 0)
            wk.disconnect()
            assert len(proxy.injected) >= 1  # faults really landed
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# end to end: mid-run reconnect-resume through the trainer
# ---------------------------------------------------------------------------

def _kill_shard_zero_when(t, stop, at_clock=2, samples=None):
    """A watcher thread: once shard 0 has applied ``at_clock`` commits,
    crash it; then sample the workers' clock views until ``stop``."""

    def watch():
        while getattr(t, "_ps_supervisor", None) is None \
                and not stop.is_set():
            time.sleep(0.005)
        sup = t._ps_supervisor
        while sup is not None and sup.group.servers[0].ps.num_updates \
                < at_clock and not stop.is_set():
            time.sleep(0.005)
        if sup is not None and not stop.is_set():
            sup.kill_shard(0)
        while samples is not None and not stop.is_set():
            for w in getattr(t, "_ps_workers", []):
                c = getattr(w, "_shard_client", None)
                if c is not None:
                    samples.append((id(w), list(c._clocks)))
            time.sleep(0.005)

    th = threading.Thread(target=watch)
    th.start()
    return th


@pytest.mark.parametrize("cls,shards,kw", [
    (DOWNPOUR, 1, {"learning_rate": 0.05}),
    (DOWNPOUR, 3, {"learning_rate": 0.05}),
    (ADAG, 1, {"learning_rate": 0.1}),
    (ADAG, 3, {"learning_rate": 0.1}),
    (DynSGD, 1, {"learning_rate": 0.05}),
    (DynSGD, 3, {"learning_rate": 0.05}),
    (DOWNPOUR, 3, {"learning_rate": 0.05, "wire_dtype": "topk",
                   "wire_topk": 0.1}),
    (ADAG, 1, {"learning_rate": 0.1, "wire_dtype": "topk",
               "wire_topk": 0.1}),
])
def test_mid_run_reconnect_resume(cls, shards, kw):
    """A shard crash mid-run is survived: the supervisor respawns it with
    the generation bumped, the workers reconnect without restarting the
    run, every sampled per-shard clock is monotone across the restart, the
    run still learns, and (top-k) the residual stays finite."""
    ds = make_dataset(n=1024)
    t = cls(make_model(), num_workers=2, batch_size=32, num_epoch=2,
            communication_window=4, label_col="label_encoded",
            execution="host_ps", ps_shards=shards, recovery=True,
            device="cpu", **kw)
    samples: list = []
    stop = threading.Event()
    th = _kill_shard_zero_when(t, stop, samples=samples)
    try:
        fitted = t.train(ds)
    finally:
        stop.set()
        th.join()
    sup = t._ps_supervisor
    assert len(sup.recoveries) >= 1
    assert sup.recoveries[0]["shard"] == 0
    assert sup.recoveries[0]["generation"] >= 1
    gens = [w._shard_client._gens[0] for w in t._ps_workers]
    assert all(g is not None and g >= 1 for g in gens)
    assert any(w._shard_client.resumes >= 1 for w in t._ps_workers)
    last: dict = {}
    for wid, clocks in samples:
        if wid in last:
            assert all(a >= b for a, b in zip(clocks, last[wid])), \
                (clocks, last[wid])
        last[wid] = clocks
    if kw.get("wire_dtype") == "topk":
        for w in t._ps_workers:
            res = (w._residual_dev if w._residual_dev is not None
                   else w._residual_flat)
            assert res is not None
            assert np.all(np.isfinite(np.asarray(res)))
    assert _accuracy(fitted, ds) > 0.6


def test_recovery_survives_chaos_proxy_shard_kill_mid_epoch():
    """Workers ride ChaosProxies to every shard; the shard-0 proxy's
    script kills the shard mid-epoch.  The supervisor restores it from the
    last snapshot on the same port; the workers reconnect through the
    proxy and training completes and learns."""
    ds = make_dataset(n=512)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=3,
             communication_window=4, learning_rate=0.1,
             label_col="label_encoded", execution="host_ps", ps_shards=2,
             recovery=True, device="cpu")
    proxies = []

    def hook(addrs):
        for j, (h, p) in enumerate(addrs):
            faults = []
            if j == 0:  # the 4th opcode on the first connection: shard dies
                faults = [ChaosFault(0, 3, "call",
                                     lambda: t._ps_supervisor.kill_shard(0))]
            proxies.append(ChaosProxy(h, p, seed=j, faults=faults))
        return [p.addr for p in proxies]

    t._shard_addr_hook = hook
    try:
        fitted = t.train(ds)
    finally:
        for p in proxies:
            p.stop()
    sup = t._ps_supervisor
    assert any(act == "call" for _, _, act in proxies[0].injected)
    assert len(sup.recoveries) >= 1 and sup.recoveries[0]["shard"] == 0
    assert any(w._shard_client.resumes >= 1 for w in t._ps_workers)
    assert _accuracy(fitted, ds) > 0.6


@pytest.mark.slow
def test_chaos_soak_one_shard_kill_per_epoch():
    """Soak: a seeded ChaosProxy fronts every shard; the shard-0 proxy
    kills its shard once per epoch-sized stretch of traffic for a 5-epoch
    run, with seeded random delays on top.  Training still converges."""
    ds = make_dataset(n=1024)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=5,
             communication_window=4, learning_rate=0.1,
             label_col="label_encoded", execution="host_ps", ps_shards=2,
             recovery=True, device="cpu")
    proxies = []
    windows_per_epoch = 4

    def hook(addrs):
        for j, (h, p) in enumerate(addrs):
            faults = []
            if j == 0:
                faults = [ChaosFault(-1, windows_per_epoch, "call",
                                     lambda: t._ps_supervisor.kill_shard(0))]
            proxies.append(ChaosProxy(h, p, seed=j,
                                      auto={"delay": (0.02, 0.01)},
                                      faults=faults))
        return [p.addr for p in proxies]

    t._shard_addr_hook = hook
    try:
        fitted = t.train(ds)
    finally:
        for p in proxies:
            p.stop()
    assert len(t._ps_supervisor.recoveries) >= 2
    assert _accuracy(fitted, ds) > 0.6
