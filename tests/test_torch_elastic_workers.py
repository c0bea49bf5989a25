"""The cases of tests/test_elastic_workers.py on the port: the lease
ledger (``resilience.LeaseLedger``), the worker supervisor
(``WorkerSupervisor``), the three fault kinds, the PS cores' half-frame
disconnect path, and ``elastic=True`` through the trainers on the CPU.

Key invariants:
 - The **exactly-once lease contract**: every lease is completed exactly
   once per epoch by someone; killing k of N workers mid-epoch loses zero
   examples.  Revoked leases reject their former holder's late renew and
   complete.
 - **Death → respawn**: a worker that raises or exits has its leases
   revoked and a replacement respawned under a fresh id; ``max_respawns``
   bounds the budget and total loss still fails loudly.
 - **Wedge → steal**: a hung worker misses its lease deadline and
   survivors steal the lease; the epoch still completes.
 - ``'exit'`` dies MID-FRAME and the PS handler drops that connection
   cleanly (no codec error, no leaked connection entry).
 - ``compile_windows`` leaves the worker's model as it was.
 - ``elastic=False`` (default) keeps the static engine bit for bit.

The JAX file's ``slow`` soak is ``slow`` here too.
"""

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
                                                   SocketParameterServer,
                                                   make_socket_server)
from distkeras_tpu_torch.resilience import LeaseLedger, WorkerSupervisor
from distkeras_tpu_torch.workers import DOWNPOURWorker, parse_fault_injection

from test_torch_host_ps import _accuracy, make_dataset, make_model
from test_torch_host_ps_overlap import _tiny_blob

torch.set_num_threads(1)


def _worker(blob, port, **kw):
    return DOWNPOURWorker(blob, "sgd", "mse", "127.0.0.1", port,
                          device="cpu", **kw)


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pred()


# ---------------------------------------------------------------------------
# the lease ledger
# ---------------------------------------------------------------------------

def test_ledger_partitions_window_aligned():
    led = LeaseLedger(num_rows=1000, rows_per_window=128, lease_windows=2)
    leases = led.begin_epoch(0)
    # 1000 rows / (128*2) per lease -> 3 full leases + a 232-row tail
    assert [(l.start, l.stop) for l in leases] == [
        (0, 256), (256, 512), (512, 768), (768, 1000)]
    assert [l.windows for l in leases] == [2, 2, 2, 2]  # tail: ceil(232/128)
    assert sum(l.stop - l.start for l in leases) == 1000


def test_ledger_exactly_once_under_steal():
    """A revoked lease's former holder cannot renew or complete it; the
    stealer's completion is the one recorded, exactly once."""
    t = [0.0]
    led = LeaseLedger(400, rows_per_window=100, lease_windows=2,
                      min_deadline=1.0, slack=4.0, clock=lambda: t[0])
    led.begin_epoch(0)
    a = led.acquire(0)
    assert a.lease_id == 0 and led.renew(a.lease_id, 0)
    t[0] += 10.0  # worker 0 wedges: no renewal past the deadline
    revoked = led.revoke_expired()
    assert [(l.lease_id, h) for l, h in revoked] == [(0, 0)]
    assert led.reassigned == 1
    assert not led.renew(a.lease_id, 0)
    assert not led.complete(a.lease_id, 0)
    b = led.acquire(1)
    assert b.lease_id == 0
    for _ in range(b.windows):
        t[0] += 0.1
        assert led.renew(b.lease_id, 1)
    assert led.complete(b.lease_id, 1)
    assert not led.complete(b.lease_id, 1)  # at most once, even for the owner
    c = led.acquire(1)
    for _ in range(c.windows):
        t[0] += 0.1
        led.renew(c.lease_id, 1)
    led.complete(c.lease_id, 1)
    assert led.epoch_done()
    rep = led.assert_epoch_complete(0)
    assert rep["by_worker"] == {0: 1, 1: 1}
    assert rep["rows_completed"] == 400


def test_ledger_incomplete_epoch_fails_loudly():
    led = LeaseLedger(200, rows_per_window=100, lease_windows=1)
    led.begin_epoch(0)
    l = led.acquire(0)
    led.renew(l.lease_id, 0)
    led.complete(l.lease_id, 0)
    with pytest.raises(RuntimeError, match="incomplete"):
        led.assert_epoch_complete(0)


def test_ledger_deadline_follows_worker_rate_ewma():
    """Deadlines adapt to each worker's measured pace, floored by
    min_deadline."""
    t = [0.0]
    led = LeaseLedger(1000, rows_per_window=100, lease_windows=5,
                      min_deadline=0.1, slack=3.0, clock=lambda: t[0])
    led.begin_epoch(0)
    l = led.acquire(7)
    assert led._state[l.lease_id]["deadline"] == pytest.approx(0.1)
    for _ in range(2):  # two windows at exactly 1.0s each
        t[0] += 1.0
        assert led.renew(l.lease_id, 7)
    assert led.rates[7] == pytest.approx(1.0)
    # 3 windows left at ~1s each, slack 3 -> deadline now + ~9s
    assert led._state[l.lease_id]["deadline"] == pytest.approx(t[0] + 9.0)
    assert led.revoke_worker(7) == 1
    assert led.acquire(8).lease_id == l.lease_id


# ---------------------------------------------------------------------------
# fault-kind parsing
# ---------------------------------------------------------------------------

def test_fault_injection_parsing():
    assert parse_fault_injection({1: 2, "3": 4}) == {1: ("raise", 2),
                                                     3: ("raise", 4)}
    assert parse_fault_injection({0: ("exit", 1), "2": ["hang", 5]}) == {
        0: ("exit", 1), 2: ("hang", 5)}
    assert parse_fault_injection(None) == {}
    with pytest.raises(ValueError, match="kind"):
        parse_fault_injection({0: ("explode", 1)})
    with pytest.raises(ValueError, match="budget"):
        parse_fault_injection({0: ("exit", 1, 2)})
    with pytest.raises(ValueError, match="kind"):
        _worker(_tiny_blob(), 1, fault_injection={0: ("nope", 1)})
    # every kind constructs a worker (the port once refused 'exit'/'hang')
    for kind in ("raise", "exit", "hang"):
        wk = _worker(_tiny_blob(), 1, fault_injection={0: (kind, 1)})
        assert wk.fault_injection == {0: (kind, 1)}


# ---------------------------------------------------------------------------
# half-frame worker death at the PS handler (both cores)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("core", ["event", "threaded"])
@pytest.mark.parametrize("close", ["fin", "rst", "torn_header"])
def test_half_frame_disconnect_closes_cleanly(close, core):
    """A worker dying mid-frame (FIN, RST, or a truncated header) leaves
    no codec error and no leaked connection entry: the live-connection
    count returns to zero, the center is untouched, and the server keeps
    serving others."""
    ps = DeltaParameterServer(_tiny_blob())
    server = make_socket_server(ps, ps_core=core)
    server.start()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        frame = networking.encode_message(
            {"delta": [np.ones(3, np.float32)], "worker_id": 0, "clock": 0})
        networking.send_opcode(sock, b"u")
        if close == "torn_header":
            sock.sendall(b"DKT1" + (500).to_bytes(4, "little") + b"{")
        else:
            sock.sendall(frame[: len(frame) // 2])
        if close == "rst":
            networking._hard_close(sock)
        else:
            sock.close()
        _wait(lambda: server.live_connections == 0)
        _wait(lambda: len(server._conn_threads) == 0)
        assert ps.num_updates == 0  # the torn commit never applied
        ok = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(ok, b"u")
        networking.send_data(ok, {"delta": [np.ones(3, np.float32)],
                                  "worker_id": 1, "clock": 0})
        msg = networking.recv_data(ok)
        assert msg["clock"] == 1
        networking.send_opcode(ok, b"q")
        ok.close()
    finally:
        server.stop()


def test_exit_fault_dies_mid_frame_through_the_real_worker():
    """The 'exit' fault leaves the PS exactly that half-frame corpse, and
    the aborted commit never counts as one that can land."""
    blob = _tiny_blob()
    ps = DeltaParameterServer(blob)
    server = SocketParameterServer(ps)
    server.start()
    wk = _worker(blob, server.port, fault_injection={0: ("exit", 1)})
    try:
        wk.connect()
        wk.pull()
        wk.commit([np.ones(3, np.float32)], 0)  # commit 1: applies
        with pytest.raises(SystemExit, match="exits at commit 2"):
            wk.commit([np.ones(3, np.float32)], 0)
        _wait(lambda: server.live_connections == 0)
        assert ps.num_updates == 1  # the torn second commit never applied
        assert wk._commits == 2 and sum(wk.sent_by_gen.values()) <= 1
    finally:
        server.stop()


def test_hang_fault_wedges_until_released():
    """'hang' blocks at its commit with the connection open (no EOF for the
    server) until ``_hang_released``; then it unwinds with a RuntimeError
    and the commit is never sent."""
    blob = _tiny_blob()
    ps = DeltaParameterServer(blob)
    server = SocketParameterServer(ps)
    server.start()
    wk = _worker(blob, server.port, fault_injection={0: ("hang", 1)})
    errors = []
    try:
        wk.connect()
        wk.pull()
        wk.commit([np.ones(3, np.float32)], 0)

        def second():
            try:
                wk.commit([np.ones(3, np.float32)], 0)
            except RuntimeError as e:
                errors.append(e)

        th = threading.Thread(target=second)
        th.start()
        _wait(lambda: wk._commits == 2)
        assert th.is_alive() and server.live_connections == 1
        wk._hang_released.set()
        th.join(timeout=5.0)
        assert not th.is_alive()
        assert "hang released" in str(errors[0])
        _wait(lambda: ps.num_updates == 1)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# ChaosProxy 'stall': wedged connections without real timeouts
# ---------------------------------------------------------------------------

def test_chaos_proxy_stall_wedges_the_connection():
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        with ChaosProxy("127.0.0.1", server.port,
                        faults=[ChaosFault(0, 1, "stall")]) as proxy:
            sock = networking.connect(proxy.host, proxy.port)
            networking.send_opcode(sock, b"p")
            networking.recv_data(sock)  # op 0 relays normally
            networking.send_opcode(sock, b"p")  # op 1: stalled
            sock.settimeout(0.3)
            with pytest.raises(socket.timeout):
                networking.recv_data(sock)
            assert proxy.injected == [(0, 1, "stall")]
            assert ps.num_updates == 0
            sock.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the supervisor: death detection, respawn, bounded budget
# ---------------------------------------------------------------------------

def _fake_run_fn(ledger, die_once_for=(), window_s=0.02):
    """A run_fn that drains the ledger without a model; workers in
    ``die_once_for`` raise on their first lease."""
    died = set()

    def run(wid, worker):
        while True:
            lease = ledger.acquire(wid)
            if lease is None:
                return {"history": [], "state": None}
            if wid in die_once_for and wid not in died:
                died.add(wid)
                raise RuntimeError(f"synthetic death of worker {wid}")
            for _ in range(lease.windows):
                time.sleep(window_s)
                assert ledger.renew(lease.lease_id, wid)
            assert ledger.complete(lease.lease_id, wid)

    return run


def test_supervisor_respawns_dead_worker_and_epoch_completes():
    led = LeaseLedger(800, rows_per_window=100, lease_windows=2,
                      min_deadline=5.0)
    sup = WorkerSupervisor(led, lambda wid: object(),
                           _fake_run_fn(led, die_once_for={0}),
                           num_workers=2, poll_interval=0.005)
    sup.run_epoch(0)
    rep = led.assert_epoch_complete(0)
    assert rep["completed"] == 4
    assert sup.respawns == 1
    assert sup.respawn_records[0]["died"] == 0
    assert sup.respawn_records[0]["replacement"] == 2
    assert sup.respawn_records[0]["recovery_ms"] is not None
    assert set(sup.respawn_records[0]) == {"died", "replacement", "reason",
                                           "recovery_ms"}
    assert 0 in sup.failures and "synthetic death" in sup.failures[0]
    assert [e["kind"] for e in sup.events] == ["death", "respawn"]


def test_supervisor_raises_once_respawn_budget_is_spent():
    led = LeaseLedger(200, rows_per_window=100, lease_windows=1,
                      min_deadline=5.0)

    def always_dies(wid, worker):
        lease = led.acquire(wid)
        if lease is None:
            return {"history": [], "state": None}
        raise RuntimeError(f"worker {wid} always dies")

    sup = WorkerSupervisor(led, lambda wid: object(), always_dies,
                           num_workers=1, poll_interval=0.01, max_respawns=2)
    with pytest.raises(RuntimeError, match="all elastic workers failed"):
        sup.run_epoch(0)
    assert sup.respawns == 2
    assert WorkerSupervisor(led, lambda wid: object(), always_dies,
                            num_workers=3).max_respawns == 6  # 2·n


# ---------------------------------------------------------------------------
# compile_windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"wire_dtype": "topk", "wire_topk": 0.1}],
                         ids=["dense", "topk"])
def test_compile_windows_leaves_the_model_unchanged(kw):
    """The warm-up window runs on clones: every parameter (and the
    optimizer-free state) is bit-identical after the call, and it returns
    a positive wall time."""
    blob = {"model": make_model().to_json(),
            "weights": [np.asarray(w) for w in make_model().get_weights()]}
    wk = DOWNPOURWorker(blob, "adam", "categorical_crossentropy",
                        "127.0.0.1", 1, communication_window=2,
                        batch_size=8, device="cpu", **kw)
    wk._ensure_model()
    before = [p.detach().clone() for p in wk._params.values()]
    x = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(64) % 4]
    seconds = wk.compile_windows(x, y)
    assert seconds > 0.0
    for a, b in zip(before, wk._params.values()):
        assert torch.equal(a, b)
    assert wk._residual_dev is None  # the top-k residual was a throwaway


# ---------------------------------------------------------------------------
# trainer knob validation
# ---------------------------------------------------------------------------

def test_elastic_knob_validation():
    m = make_model()
    kw = dict(num_workers=2, label_col="label_encoded", device="cpu")
    t = ADAG(m, execution="host_ps", elastic=True, **kw)
    assert t.elastic is True and t.lease_windows is None
    assert ADAG(m, execution="host_ps", **kw).elastic is False
    with pytest.raises(ValueError, match="elastic"):
        ADAG(m, elastic=True, label_col="label_encoded",
             mesh=get_mesh(2, devices=["cpu"] * 2))  # SPMD
    # process_ps elastic is the supervised cross-process engine
    assert ADAG(m, execution="process_ps", elastic=True, **kw).elastic
    with pytest.raises(ValueError, match="lease_windows"):
        ADAG(m, execution="host_ps", elastic=True, lease_windows=0, **kw)
    with pytest.raises(ValueError, match="lease_timeout"):
        ADAG(m, execution="host_ps", elastic=True, lease_timeout=0.0, **kw)


def test_elastic_rejects_checkpoint_and_bare_hang_faults(tmp_path):
    ds = make_dataset(n=256)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=1,
             label_col="label_encoded", execution="host_ps", elastic=True,
             checkpoint_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="elastic"):
        t.train(ds)
    # 'hang' without elastic would deadlock the epoch join: rejected
    t2 = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=1,
              label_col="label_encoded", execution="host_ps",
              fault_injection={0: ("hang", 1)}, device="cpu")
    with pytest.raises(ValueError, match="hang"):
        t2.train(ds)


# ---------------------------------------------------------------------------
# end to end: the death/respawn matrix
# ---------------------------------------------------------------------------

def _assert_zero_loss(t, rows=1024):
    stats = t.elastic_stats
    for epoch in range(t.num_epoch):
        rep = stats["lease_completions"][epoch]
        assert rep["completed"] == rep["leases"], rep
        assert rep["rows_completed"] == rows


@pytest.mark.parametrize("cls,shards,kw", [
    (DOWNPOUR, 1, {"learning_rate": 0.05}),
    (DOWNPOUR, 3, {"learning_rate": 0.05, "wire_dtype": "topk",
                   "wire_topk": 0.1}),
    (ADAG, 1, {"learning_rate": 0.1, "wire_dtype": "topk",
               "wire_topk": 0.1}),
    (ADAG, 3, {"learning_rate": 0.1}),
    (DynSGD, 1, {"learning_rate": 0.05}),
    (DynSGD, 3, {"learning_rate": 0.05}),
])
def test_elastic_death_respawn_matrix(cls, shards, kw):
    """{DOWNPOUR, ADAG, DynSGD} x ps_shards {1,3} x wire {dense, topk}: one
    worker exits mid-epoch; a replacement is respawned, every lease
    completes exactly once per epoch, worker-visible clocks stay
    monotone, and the run learns."""
    ds = make_dataset(n=1024)
    t = cls(make_model(), num_workers=2, batch_size=32, num_epoch=2,
            communication_window=4, label_col="label_encoded",
            execution="host_ps", elastic=True, ps_shards=shards,
            fault_injection={0: ("exit", 2)}, device="cpu", **kw)
    fitted = t.train(ds)
    _assert_zero_loss(t)
    stats = t.elastic_stats
    assert set(stats) == {"respawns", "respawn_records",
                          "leases_reassigned", "windows_per_worker",
                          "lease_completions", "events"}
    assert stats["respawns"] >= 1
    assert t.failed_workers == [0]
    assert "exits at commit" in t.worker_failures[0]
    for w in t._ps_workers:
        client = getattr(w, "_shard_client", None)
        regressions = (client.clock_regressions if client is not None
                       else w.clock_regressions)
        assert regressions == 0
    assert _accuracy(fitted, ds) > 0.6


def test_elastic_straggler_leases_stolen_epoch_finishes():
    """One of two workers wedges ('hang') mid-epoch; its leases are
    revoked on the deadline and stolen by the survivor, the epoch still
    completes, and the wedge is diagnosable from the event log."""
    ds = make_dataset(n=1024)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=2,
             communication_window=4, learning_rate=0.1,
             label_col="label_encoded", execution="host_ps", elastic=True,
             lease_timeout=0.5, fault_injection={0: ("hang", 2)},
             device="cpu")
    fitted = t.train(ds)
    _assert_zero_loss(t)
    stats = t.elastic_stats
    assert stats["windows_per_worker"].get(0, 0) <= 2
    assert stats["leases_reassigned"] >= 1
    kinds = {e["kind"] for e in stats["events"]}
    assert "lease_revoked" in kinds and "death" in kinds
    assert 0 in t.worker_failures and "wedged" in t.worker_failures[0]
    # the wedged thread was released at shutdown
    assert t._worker_supervisor.workers[0]._hang_released.is_set()
    assert _accuracy(fitted, ds) > 0.6


@pytest.mark.parametrize("cls,lr", [(DOWNPOUR, 0.05), (ADAG, 0.1)])
def test_elastic_kill_two_of_four_zero_examples_lost(cls, lr, monkeypatch):
    """Killing 2 of 4 workers mid-epoch (one 'exit', one 'hang') loses zero
    examples, and the MLP reaches the non-faulted run's quality band.

    Worker 2's hang fires at its third commit, so in the faulted run the
    other workers take no lease until worker 2 holds its third: a slow
    start of its thread cannot leave it too few leases for the fault."""
    ds = make_dataset(n=1024)

    def run(faults):
        t = cls(make_model(), num_workers=4, batch_size=32, num_epoch=2,
                communication_window=4, learning_rate=lr,
                label_col="label_encoded", execution="host_ps",
                elastic=True, lease_timeout=0.5, fault_injection=faults,
                device="cpu")
        return t, t.train(ds)

    clean_t, clean = run(None)
    taken, third = [0], threading.Event()
    acquire = LeaseLedger.acquire

    def gated_acquire(self, worker):
        if worker != 2:
            third.wait(timeout=120.0)
        lease = acquire(self, worker)
        if worker == 2 and lease is not None:
            taken[0] += 1
            if taken[0] == 3:
                third.set()
        return lease

    monkeypatch.setattr(LeaseLedger, "acquire", gated_acquire)
    chaos_t, chaos = run({1: ("exit", 1), 2: ("hang", 2)})
    assert third.is_set()
    _assert_zero_loss(chaos_t)
    assert {1, 2} <= set(chaos_t.failed_workers)
    assert chaos_t.elastic_stats["respawns"] >= 1
    clean_acc = _accuracy(clean, ds)
    chaos_acc = _accuracy(chaos, ds)
    assert clean_acc > 0.6
    assert chaos_acc > max(0.6, clean_acc - 0.1), (clean_acc, chaos_acc)
    assert clean_t.elastic_stats["respawns"] == 0
    assert clean_t.failed_workers == []


def test_elastic_composes_with_recovery_worker_and_shard_both_die():
    """A worker exits mid-epoch AND a PS shard is crash-killed: both
    supervisors recover, every lease still completes exactly once, and
    the run learns."""
    ds = make_dataset(n=1024)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=2,
             communication_window=4, learning_rate=0.1,
             label_col="label_encoded", execution="host_ps", elastic=True,
             ps_shards=2, recovery=True, fault_injection={0: ("exit", 2)},
             device="cpu")
    stop = threading.Event()

    def killer():
        while getattr(t, "_ps_supervisor", None) is None \
                and not stop.is_set():
            time.sleep(0.005)
        sup = t._ps_supervisor
        while sup.group.servers[0].ps.num_updates < 2 and not stop.is_set():
            time.sleep(0.005)
        if not stop.is_set():
            sup.kill_shard(0)

    th = threading.Thread(target=killer)
    th.start()
    try:
        fitted = t.train(ds)
    finally:
        stop.set()
        th.join()
    _assert_zero_loss(t)
    assert t.elastic_stats["respawns"] >= 1
    assert len(t._ps_supervisor.recoveries) >= 1
    assert _accuracy(fitted, ds) > 0.6


def test_elastic_false_default_is_bit_identical():
    """elastic defaults to False and the default path is the static
    engine: a single-worker run gives identical weights across
    invocations and never builds a ledger or worker supervisor."""
    ds = make_dataset(n=256)

    def run():
        t = DOWNPOUR(make_model(), num_workers=1, batch_size=32,
                     num_epoch=1, communication_window=4,
                     learning_rate=0.05, label_col="label_encoded",
                     execution="host_ps", device="cpu")
        fitted = t.train(ds)
        return t, fitted.get_weights()

    t1, w1 = run()
    t2, w2 = run()
    assert t1.elastic is False
    assert not hasattr(t1, "_worker_supervisor")
    assert t1.elastic_stats == {}
    for a, b in zip(w1, w2):
        np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_elastic_chaos_soak_one_worker_kill_per_epoch():
    """Soak: one worker killed per epoch for 5 epochs; every epoch
    completes its ledger exactly once and training converges."""
    ds = make_dataset(n=1024)
    faults = {0: ("exit", 1), 1: ("exit", 3), 2: ("exit", 5),
              3: ("exit", 7)}
    t = ADAG(make_model(), num_workers=4, batch_size=32, num_epoch=5,
             communication_window=4, learning_rate=0.1,
             label_col="label_encoded", execution="host_ps", elastic=True,
             fault_injection=faults, device="cpu")
    fitted = t.train(ds)
    assert t.elastic_stats["respawns"] >= 3
    _assert_zero_loss(t)
    assert _accuracy(fitted, ds) > 0.6
