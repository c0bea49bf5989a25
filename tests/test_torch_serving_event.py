"""The port's event transport core (``ServingServer(server_core=
"event")``): one selector I/O thread for every connection.

The contract pinned here (the cases of ``tests/test_serving_event.py`` on
the port): 64 live streams run on one I/O thread with no per-connection
thread and complete bit-identically, ``stop()`` closes every registered
connection and returns the descriptors; a client that stops reading
cannot grow the outbound backlog past ``max_conn_buffer``; the copied
``ClientPool`` never vends one client twice under concurrent checkout
with eviction; and a mid-stream cancel followed by a pipelined enqueue on
one socket is answered in order.
"""

import os
import socket
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch import networking
from distkeras_tpu_torch.serving import (ServingClient, ServingEngine,
                                         ServingServer)
from test_torch_serving_wire import PROMPT, _want, models  # noqa: F401

torch.set_num_threads(1)


def fitted_of(models):
    return models[1]


def _conn_threads():
    """Per-connection server threads alive right now (what the event core
    does without)."""
    return [t for t in threading.enumerate()
            if t.name.startswith("dkt-serving-conn")]


def _open_fds():
    return len(os.listdir("/proc/self/fd"))


def test_event_core_o1_threads_at_64_streams(models):
    fitted = fitted_of(models)
    eng = ServingEngine(fitted, num_slots=4, max_len=28,
                        queue_capacity=128)
    srv = ServingServer(eng, server_core="event", poll_s=0.01).start()
    fds_after_close = None
    clients = []
    try:
        rids = {}
        for i in range(64):
            c = ServingClient(*srv.addr)
            clients.append(c)
            rids[i] = c.submit(PROMPT, 6, temperature=0.5, seed=7)
        assert _conn_threads() == []  # zero per-connection threads
        assert srv._loop is not None and srv._loop.alive
        assert srv._loop.registered() >= 65  # 64 conns + the listener
        done = {}

        def _drain(i, c, rid):
            for _tok, d in c.stream(rid):
                if d is not None:
                    done[i] = d["row"]

        pumps = [threading.Thread(target=_drain, args=(i, c, rids[i]),
                                  daemon=True)
                 for i, c in enumerate(clients)]
        for t in pumps:
            t.start()
        assert _conn_threads() == []
        for t in pumps:
            t.join(timeout=120.0)
        assert len(done) == 64
        want = _want(fitted, PROMPT, 6, max_len=28, temperature=0.5,
                     seed=7)
        for i in range(64):
            np.testing.assert_array_equal(done[i], want)
        for c in clients:
            c.close()
        clients = []
        fds_after_close = _open_fds()
    finally:
        for c in clients:
            c.close()
        srv.stop(join_timeout=10.0)
    assert not srv._loop.alive
    assert srv._loop.registered() == 0
    assert _conn_threads() == []
    if fds_after_close is not None:
        assert _open_fds() < fds_after_close


def test_event_stop_closes_registered_connections(models):
    eng = ServingEngine(fitted_of(models), num_slots=2, max_len=24)
    srv = ServingServer(eng, server_core="event").start()
    socks = [networking.connect(*srv.addr) for _ in range(8)]
    deadline = time.monotonic() + 5.0
    while srv._loop.registered() < 9 and time.monotonic() < deadline:
        time.sleep(0.01)  # accepts run on the loop thread
    assert srv._loop.registered() >= 9
    srv.stop(join_timeout=5.0)
    assert srv._loop.registered() == 0
    for s in socks:
        s.settimeout(2.0)
        assert s.recv(1) == b""
        s.close()


def test_event_write_backlog_is_capped(models):
    """64 pipelined streams on one socket whose client does not read: the
    outbound backlog stops at ``max_conn_buffer`` (plus the frame that
    crossed it); once the client drains, every stream completes in
    order with its full token count."""
    cap = 1 << 12
    eng = ServingEngine(fitted_of(models), num_slots=4, max_len=28,
                        queue_capacity=128)
    srv = ServingServer(eng, server_core="event", poll_s=0.01,
                        max_conn_buffer=cap).start()
    try:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.connect(srv.addr)
        n, steps = 64, 16
        rids = []
        for _ in range(n):
            networking.send_opcode(s, networking.SERVING_OP_ENQUEUE)
            networking.send_data(s, {"prompt": PROMPT,
                                     "num_steps": steps})
            ack = networking.recv_data(s)
            assert ack.get("ok"), ack
            rids.append(int(ack["id"]))
        deadline = time.monotonic() + 5.0
        while not srv._econns and time.monotonic() < deadline:
            time.sleep(0.005)
        for cn in list(srv._econns.values()):
            cn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                               4096)
        for rid in rids:
            networking.send_opcode(s, networking.SERVING_OP_STREAM)
            networking.send_data(s, {"id": rid})
        peak = 0
        deadline = time.monotonic() + 20.0
        paused = False
        while time.monotonic() < deadline and not paused:
            conns = list(srv._econns.values())
            if conns:
                peak = max([peak] + [cn.out_bytes for cn in conns])
                paused = any(cn.paused for cn in conns)
            time.sleep(0.005)
        assert paused, "backlog never hit the cap — backpressure untested"
        assert peak < cap + (1 << 14)
        fast = ServingClient(*srv.addr)
        row = fast.generate(PROMPT, 4)
        assert row.shape[0] >= PROMPT.size + 4
        fast.close()
        for rid in rids:
            toks, finish = [], None
            while finish is None:
                reply = networking.recv_data(s)
                assert not reply.get("error"), reply
                toks.extend(int(t) for t in reply["tokens"])
                if reply["done"]:
                    finish = reply["finish"]
                    assert int(reply["id"]) == rid
            assert finish == "length"
            assert len(toks) == steps
        s.close()
    finally:
        srv.stop(join_timeout=10.0)


def test_client_pool_concurrent_checkout_with_eviction():
    """Two threads on acquire/release of one address while
    ``max_idle_per_addr=1`` evicts: no client is vended to two owners at
    once, and ``close()`` reaps everything, a client released after it
    too."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(128)
    addr = lsock.getsockname()
    accepted = []

    def _accept():
        while True:
            try:
                s, _ = lsock.accept()
            except OSError:
                return
            accepted.append(s)

    threading.Thread(target=_accept, daemon=True).start()

    class _Conn:
        def __init__(self, a):
            self.sock = socket.create_connection(tuple(a))
            self.closed = False

        def close(self):
            self.closed = True
            self.sock.close()

    pool = networking.ClientPool(_Conn, max_idle_per_addr=1)
    vended, errs = [], []
    in_use = set()
    use_lock = threading.Lock()

    def _worker():
        try:
            for _ in range(50):
                cl = pool.acquire(addr)
                with use_lock:
                    assert id(cl) not in in_use, "double-vended client"
                    in_use.add(id(cl))
                    vended.append(cl)
                with use_lock:
                    in_use.discard(id(cl))
                pool.release(addr, cl)
        except BaseException as e:  # surfaced below
            errs.append(e)

    workers = [threading.Thread(target=_worker) for _ in range(2)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=30.0)
    assert errs == []
    straggler = pool.acquire(addr)
    pool.close()
    pool.release(addr, straggler)
    assert straggler.closed
    assert all(cl.closed for cl in vended)
    lsock.close()
    for s in accepted:
        s.close()


def test_event_midstream_cancel_then_deferred_enqueue(models):
    eng = ServingEngine(fitted_of(models), num_slots=2, max_len=28,
                        queue_capacity=8)
    srv = ServingServer(eng, server_core="event", poll_s=0.01).start()
    try:
        c = ServingClient(*srv.addr)
        rid = c.submit(PROMPT, 16)
        networking.send_opcode(c.sock, networking.SERVING_OP_STREAM)
        networking.send_data(c.sock, {"id": rid})
        networking.send_opcode(c.sock, networking.SERVING_OP_CANCEL)
        networking.send_data(c.sock, {"id": rid})
        networking.send_opcode(c.sock, networking.SERVING_OP_ENQUEUE)
        networking.send_data(c.sock, {"prompt": PROMPT, "num_steps": 2})
        finish = None
        while finish is None:
            reply = networking.recv_data(c.sock, pool=c._pool)
            assert not reply.get("error"), reply
            if reply["done"]:
                finish = reply["finish"]
        assert finish == "cancel"
        ack = networking.recv_data(c.sock, pool=c._pool)
        assert ack.get("ok") and "id" in ack
        row = None
        for _tok, done in c.stream(int(ack["id"])):
            if done is not None:
                row = done["row"]
        assert row is not None and row.shape[0] >= PROMPT.size + 2
        c.close()
    finally:
        srv.stop(join_timeout=5.0)
