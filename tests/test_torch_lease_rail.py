"""The port's lease rail and process supervisor against the JAX
package's, on the CPU.

 - ``LeaseServer``/``LeaseClient`` over loopback: epochs open and close,
   leases are acquired, renewed and completed exactly once, a blocking
   ``acquire`` returns a revoked lease, ``finish`` releases the workers,
   and the client re-dials a server that dropped its connection.
 - Interop, both ways, in-process: one scripted sequence of ledger calls
   through a port client against a JAX server and a JAX client against a
   port server gives the same leases, the same replies and the same
   ``assert_epoch_complete`` report as each package against itself.
 - ``ProcessSupervisor`` over stub children (``python -c "import time;
   time.sleep(60)"``), the test playing the workers' lease traffic: a
   SIGKILL is a death (leases revoked, a respawn under a fresh id), a
   SIGSTOP with silent beats is ``frozen`` (leases revoked, survivors
   steal them), SIGCONT and a beat rejoin (``thawed``); the events equal
   those of the JAX ``ProcessSupervisor`` driven by the same stubs.

Every wait is for a state (an event, a respawn count, an epoch flag); the
freeze deadline is the one clock the supervisor itself reads.
"""

import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

import distkeras_tpu.resilience as jres
import distkeras_tpu_torch.resilience as pres

torch.set_num_threads(1)

PACKAGES = {"port": pres, "jax": jres}
STUB = [sys.executable, "-c", "import time; time.sleep(60)"]


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "state never reached"
        time.sleep(0.005)


def _stop(server):
    """Stop a lease server of either package at once: the JAX server's
    ``stop`` closes its listener, which does not wake a blocking accept
    on Linux, and then waits 5 s for the accept thread; a shutdown of the
    listening socket first wakes it (the port's ``stop`` does this
    itself)."""
    try:
        server._sock.shutdown(socket.SHUT_RDWR)
    except (AttributeError, OSError):
        pass
    server.stop()


def _ledger(res, leases=4):
    # 2 rows a window, one window a lease; deadlines far beyond the test
    return res.LeaseLedger(2 * leases, 2, 1, min_deadline=600.0)


# ---------------------------------------------------------------------------
# the rail on its own
# ---------------------------------------------------------------------------

def test_the_lease_rail_over_loopback():
    ledger = _ledger(pres, leases=3)
    with pres.LeaseServer(ledger) as server:
        client = pres.LeaseClient("127.0.0.1", server.port,
                                  poll_interval=0.005).connect()
        try:
            got = {}
            waiter = threading.Thread(
                target=lambda: got.update(epoch=client.wait_epoch(None)))
            waiter.start()
            ledger.begin_epoch(0)
            server.open_epoch(0)
            waiter.join(timeout=30)
            assert got["epoch"] == 0
            a = client.acquire(5)
            assert a == pres.Lease(0, 0, 0, 2, 1)
            assert 5 in server.beats()
            assert client.renew(a.lease_id, 5) is True
            assert client.renew(a.lease_id, 6) is False  # not the holder
            assert client.complete(a.lease_id, 5) is True
            assert client.complete(a.lease_id, 5) is False  # exactly once
            b, c = client.acquire(5), client.acquire(6)
            assert (b.lease_id, c.lease_id) == (1, 2)
            # a blocking acquire returns the lease a revocation frees
            box = {}
            th = threading.Thread(
                target=lambda: box.update(lease=client.acquire(7)))
            th.start()
            _wait(lambda: server.requests >= 10)
            assert ledger.revoke_worker(6) == 1
            th.join(timeout=30)
            assert box["lease"].lease_id == 2
            for lease, wid in ((b, 5), (box["lease"], 7)):
                assert client.complete(lease.lease_id, wid)
            assert ledger.epoch_done() and client.acquire(5) is None
            report = ledger.assert_epoch_complete(0)
            assert report["rows_completed"] == 6
            assert report["by_worker"] == {0: 5, 1: 5, 2: 7}
            # between epochs a worker parks; finish() releases it
            server.close_epoch()
            box.clear()
            th = threading.Thread(
                target=lambda: box.update(epoch=client.wait_epoch(0)))
            th.start()
            _wait(lambda: th.is_alive() and server.requests >= 16)
            server.finish()
            th.join(timeout=30)
            assert box == {"epoch": None}
        finally:
            client.close()


def test_the_client_redials_a_dropped_connection():
    ledger = _ledger(pres)
    ledger.begin_epoch(0)
    with pres.LeaseServer(ledger) as server:
        server.open_epoch(0)
        client = pres.LeaseClient(
            "127.0.0.1", server.port,
            policy=pres.RetryPolicy(attempts=20, backoff=0.01)).connect()
        try:
            assert client.acquire(0).lease_id == 0
            client._sock.close()  # the transport dies under the client
            assert client.acquire(0).lease_id == 1
            assert client.resumes == 1
        finally:
            client.close()


# ---------------------------------------------------------------------------
# interop: one call sequence through every pairing
# ---------------------------------------------------------------------------

def _script(client, ledger, server):
    """A fixed sequence of ledger calls over the wire; the replies."""
    out = []
    ledger.begin_epoch(3)
    server.open_epoch(3)
    out.append(client.wait_epoch(None))
    leases = [client.acquire(w) for w in (0, 1, 0)]
    out.append([tuple(lease) for lease in leases])
    out.append([client.renew(leases[0].lease_id, 0),
                client.renew(leases[0].lease_id, 1),
                client.renew(leases[1].lease_id, 1)])
    out.append([client.complete(leases[0].lease_id, 0),
                client.complete(leases[0].lease_id, 0),
                client.complete(leases[1].lease_id, 0)])
    out.append(ledger.revoke_worker(1))
    rest = [client.acquire(2), client.acquire(2)]
    out.append([tuple(lease) for lease in rest])
    out.append([client.complete(lease.lease_id, 2) for lease in rest])
    out.append(client.complete(leases[2].lease_id, 0))
    out.append(client.acquire(0))
    out.append(ledger.assert_epoch_complete(3))
    server.close_epoch()
    server.finish()
    out.append(client.wait_epoch(3))
    return out


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "port"), ("jax", "port"),
                          ("port", "jax"), ("jax", "jax")])
def test_clients_and_servers_interoperate_call_for_call(server_pkg,
                                                        client_pkg):
    runs = {}
    for pair in {(server_pkg, client_pkg), ("jax", "jax")}:
        srv_res, cli_res = PACKAGES[pair[0]], PACKAGES[pair[1]]
        ledger = _ledger(srv_res, leases=4)
        server = srv_res.LeaseServer(ledger).start()
        client = cli_res.LeaseClient("127.0.0.1", server.port,
                                     poll_interval=0.005).connect()
        try:
            runs[pair] = _script(client, ledger, server)
        finally:
            client.close()
            _stop(server)
    assert runs[(server_pkg, client_pkg)] == runs[("jax", "jax")]
    assert runs[("jax", "jax")][-2]["rows_completed"] == 8


# ---------------------------------------------------------------------------
# ProcessSupervisor over stub children
# ---------------------------------------------------------------------------

def _drive_supervisor(res):
    """SIGKILL one stub, freeze and thaw the other, drain the epoch;
    returns (the events without their times, the acquired leases, the
    epoch report, respawn records without times, failures' keys)."""
    ledger = _ledger(res, leases=4)
    server = res.LeaseServer(ledger).start()
    procs = []

    def spawn(wid):
        p = subprocess.Popen(STUB)
        procs.append(p)
        return p

    sup = res.ProcessSupervisor(ledger, server, spawn, 2,
                                poll_interval=0.005, freeze_deadline=1.0)
    clients = {w: res.LeaseClient("127.0.0.1", server.port,
                                  poll_interval=0.005).connect()
               for w in (0, 1, 2)}
    box = {}

    def run():
        try:
            sup.run_epoch(0)
        except BaseException as e:  # surfaced below
            box["error"] = e

    sup.start()
    th = threading.Thread(target=run)
    th.start()
    beating = threading.Event()
    beater = None
    try:
        assert clients[0].wait_epoch(None) == 0
        held = {0: clients[0].acquire(0), 1: clients[1].acquire(1)}
        # worker 0 beats (renews) until the freeze
        beating.set()

        def beat():
            while beating.is_set():
                clients[0].renew(held[0].lease_id, 0)
                time.sleep(0.01)

        beater = threading.Thread(target=beat)
        beater.start()
        # (1) SIGKILL worker 1: a death, its lease revoked, worker 2 spawned
        sup.procs[1].send_signal(signal.SIGKILL)
        _wait(lambda: sup.respawns == 1)
        # (2) SIGSTOP worker 0 and silence its beats: frozen, lease revoked
        sup.procs[0].send_signal(signal.SIGSTOP)
        beating.clear()
        beater.join()
        _wait(lambda: any(e["kind"] == "frozen" for e in sup.events))
        # (3) SIGCONT: its next renew is refused (stolen) and rejoins it
        sup.procs[0].send_signal(signal.SIGCONT)
        assert clients[0].renew(held[0].lease_id, 0) is False
        _wait(lambda: any(e["kind"] == "thawed" for e in sup.events))
        # (4) the replacement drains every lease, the epoch closes
        stolen = []
        while True:
            lease = clients[2].acquire(2)
            if lease is None:
                break
            stolen.append(tuple(lease))
            assert clients[2].complete(lease.lease_id, 2)
        th.join(timeout=30)
        assert not th.is_alive() and "error" not in box, box
        report = ledger.assert_epoch_complete(0)
    finally:
        beating.clear()
        if beater is not None:
            beater.join()
        for c in clients.values():
            c.close()
        sup.shutdown(timeout=0.5)
        _stop(server)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.poll() is not None for p in procs)
    events = [{k: v for k, v in e.items() if k != "recovery_ms"}
              for e in sup.events]
    records = [{k: v for k, v in r.items() if k != "recovery_ms"}
               for r in sup.respawn_records]
    stats = sup.stats()
    return (events, [tuple(held[0]), tuple(held[1])] + stolen, report,
            records, sorted(sup.failures), stats["respawns"],
            stats["leases_reassigned"])


def test_process_supervisor_matches_jax_on_stub_children():
    port = _drive_supervisor(pres)
    events = port[0]
    assert events == [
        {"kind": "death", "worker": 1, "reason": "died"},
        {"kind": "respawn", "died": 1, "replacement": 2, "reason": "died"},
        {"kind": "frozen", "worker": 0, "leases_revoked": 1},
        {"kind": "thawed", "worker": 0}]
    assert port[1][:2] == [(0, 0, 0, 2, 1), (1, 0, 2, 4, 1)]
    assert sorted(lease[0] for lease in port[1][2:]) == [0, 1, 2, 3]
    assert port[2]["rows_completed"] == 8 and port[4] == [1]
    assert port[5] == 1 and port[6] == 2
    assert port == _drive_supervisor(jres)
