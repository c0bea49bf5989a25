"""The port's static cross-process engine (``execution="process_ps"``)
against its host-PS engine and the JAX package, on the CPU.

 - **The process boundary changes nothing.**  One worker process
   (``python -m distkeras_tpu_torch.ps_worker_main``) on the port gives
   the same window losses and center, bit for bit, as the port's
   ``host_ps`` run with one worker thread, for ADAG, DOWNPOUR and AEASGD
   (their default transports: overlapped for the delta family, serial for
   the elastic one), and equals the JAX package's one-worker host-PS run
   within rtol 1e-5, atol 1e-6 (the host-PS parity tolerance; the JAX
   reference runs in this process, ``jax_one_worker``).
 - Two worker processes at one and two shards: every loss history has
   its windows and falls, the clock counts every commit.
 - The last commit: a serial worker's last ``'c'`` is fire-and-forget; a
   driver that stops its server when the processes exit (the JAX
   engine) loses it when the server's loop is late, and the port's wait
   for the commits each child reports (``sent`` in its result file) does
   not.
 - ``fault_tolerance``: a worker process that dies mid-frame (``'exit'``)
   leaves a degraded completion; all of them dead raises.
 - The JAX engine's refusals, with its messages.

Children inherit ``OMP_NUM_THREADS=1`` (each test sets it) and the repo
root on ``PYTHONPATH``; each costs ~3 s of imports here, so the runs of
the first two legs start together (``runs``).
"""

import concurrent.futures
import time

import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
import distkeras_tpu_torch as port
from distkeras_tpu_torch import parameter_servers as pps

from test_torch_host_ps_parity import (ALGORITHMS, TOL, _jax_model,
                                       _optimizer, _port_model, _rows,
                                       _weights, jax_one_worker)

torch.set_num_threads(1)

ONE = ("ADAG", "DOWNPOUR", "AEASGD")
COMMON = dict(batch_size=8, num_epoch=2, communication_window=4,
              label_col="label_encoded", seed=3)


def _trainer(pkg, name, execution, workers=1, **kw):
    model = (_port_model if pkg is port else _jax_model)(_weights())
    extra = dict(device="cpu") if pkg is port else {}
    return getattr(pkg, name)(model, num_workers=workers,
                              execution=execution, **COMMON, **extra,
                              **_optimizer(pkg, ALGORITHMS[name]), **kw)


def _train(name, execution, workers=1, rows=None, **kw):
    t = _trainer(port, name, execution, workers, **kw)
    fitted = t.train(port.Dataset(_rows() if rows is None else rows))
    return t, fitted


def _all_dead(t):
    try:
        t.train(port.Dataset(_rows(rows=320)))
    except RuntimeError as e:
        return str(e)
    return None


@pytest.fixture(scope="module")
def runs():
    """The process runs of the first two legs, started together (their
    children import in parallel), and the in-process references."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with concurrent.futures.ThreadPoolExecutor(7) as pool:
            futures = {name: pool.submit(_train, name, "process_ps")
                       for name in ONE}
            for shards in (1, 2):
                futures[shards] = pool.submit(
                    _train, "DOWNPOUR", "process_ps", workers=2,
                    rows=_rows(rows=320), ps_shards=shards)
            futures["degraded"] = pool.submit(
                _train, "ADAG", "process_ps", workers=2,
                rows=_rows(rows=320), fault_tolerance=True,
                fault_injection={0: ("exit", 2)})
            futures["all_dead"] = pool.submit(
                _all_dead, _trainer(port, "ADAG", "process_ps", workers=2,
                                    fault_tolerance=True,
                                    fault_injection={0: ("exit", 1),
                                                     1: ("exit", 1)}))
            out = {("host", name): _train(name, "host_ps") for name in ONE}
            out.update({("jax", name): jax_one_worker(name, _weights(),
                                                      _rows(), None)
                        for name in ONE})
            out.update({k: f.result() for k, f in futures.items()})
    return out


@pytest.mark.parametrize("name", ONE)
def test_one_worker_process_is_bit_identical_to_host_ps(runs, name):
    (pt, pfit), (ht, hfit) = runs[name], runs[("host", name)]
    assert pt.comm_overlap == ht.comm_overlap == (name != "AEASGD")
    # 160 rows / (window 4 x batch 8) = 5 windows an epoch, 2 epochs
    assert len(pt.get_history()) == 10
    assert pt.get_history() == ht.get_history()
    for a, b in zip(pfit.get_weights(), hfit.get_weights()):
        np.testing.assert_array_equal(a, b)
    assert pt._ps_server.ps.num_updates == ht._ps_server.ps.num_updates \
        == 10
    # the child reported its commits, by (shard, generation)
    (child,) = pt._process_results
    assert sum(child.sent_by_gen.values()) == 10
    assert set(pt.process_launches.values()) == {0}  # no attention here
    # the child loaded the driver's host extensions: no compiler ran there
    assert child.native_compiles == pt.process_native_compiles == 0


@pytest.mark.parametrize("name", ONE)
def test_one_worker_process_matches_jax(runs, name):
    pt, pfit = runs[name]
    jhist, jcenter, jw, jclock = runs[("jax", name)]
    np.testing.assert_allclose(pt.get_history(), jhist, **TOL)
    for a, b in zip(pfit.get_weights(), jcenter):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert jw._commits == jclock == 10


@pytest.mark.parametrize("shards", [1, 2])
def test_two_worker_processes_train(runs, shards):
    t, fitted = runs[shards]
    hist = t.get_history()
    # 320 rows dealt round-robin: 160 a worker, 5 windows an epoch, 2
    # epochs, worker 0's windows then worker 1's
    assert len(hist) == 20
    for w in (hist[:10], hist[10:]):
        assert np.mean(w[-3:]) < np.mean(w[:3])
    assert [len(r.history) for r in t._process_results] == [10, 10]
    clocks = pps._clocks(t._ps_server)
    assert clocks == [20] * shards
    assert t.ps_shards == shards
    assert all(np.isfinite(w).all() for w in fitted.get_weights())


def test_the_wait_keeps_the_last_commit(monkeypatch):
    """AEASGD pulls, then commits: its last ``'c'`` is fire-and-forget.
    The driver's server loop is held for 2 s after it answers the last
    pull, as a loaded machine sometimes holds it; the child commits,
    quits and exits meanwhile.  Without the wait (the JAX engine's
    order: stop the server once the processes exit) the loop exits with
    the commit unread and the center has 9 of the 10; with it, 10."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    drain = pps.SocketParameterServer._process_drain

    def held(self, entries):
        drain(self, entries)
        if self.ps.num_updates == 9 and any(e[1] == b"p" for e in entries):
            time.sleep(2.0)

    monkeypatch.setattr(pps.SocketParameterServer, "_process_drain", held)
    wait = pps._await_applied

    def skipped_for_the_parent(server, clocks, timeout=30.0):
        if not getattr(server, "_parent_order", False):
            wait(server, clocks, timeout)

    monkeypatch.setattr(pps, "_await_applied", skipped_for_the_parent)
    make = pps.make_socket_server
    made = []

    def tagged(*a, **k):
        server = make(*a, **k)
        server._parent_order = not made  # the first run is the parent's
        made.append(server)
        return server

    monkeypatch.setattr(pps, "make_socket_server", tagged)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        parent = pool.submit(_train, "AEASGD", "process_ps")
        deadline = time.monotonic() + 60
        while not made:  # the parent's server exists before the change's
            assert time.monotonic() < deadline and not parent.done()
            time.sleep(0.005)
        change = pool.submit(_train, "AEASGD", "process_ps")
        (pt_parent, _), (pt_change, _) = parent.result(), change.result()
    assert pt_parent._ps_server._parent_order
    assert not pt_change._ps_server._parent_order
    assert pt_parent._ps_server.ps.num_updates == 9
    assert pt_change._ps_server.ps.num_updates == 10
    for t in (pt_parent, pt_change):
        (child,) = t._process_results
        assert sum(child.sent_by_gen.values()) == 10


def test_degraded_completion_under_fault_tolerance(runs):
    """Worker 0 dies mid-frame at its third commit (``'exit'``: half a
    frame, an RST, a nonzero exit): the survivor finishes."""
    t, fitted = runs["degraded"]
    assert t.failed_workers == [0]
    assert t.worker_failures[0].startswith("exit code")
    # only the survivor's result came back: its 10 windows
    assert [r.worker_id for r in t._process_results] == [1]
    assert len(t.get_history()) == 10
    # the survivor's commits and the casualty's two applied ones
    assert pps._clocks(t._ps_server) == [12]
    assert all(np.isfinite(w).all() for w in fitted.get_weights())
    assert runs["all_dead"] is not None
    assert "all 2 worker processes failed" in runs["all_dead"]


def _refusal(pkg, case, tmp_path):
    if case == "checkpoint":
        _trainer(pkg, "ADAG", "process_ps",
                 checkpoint_dir=str(tmp_path / pkg.__name__)).train(
            pkg.Dataset(_rows()))
    elif case == "resume":
        _trainer(pkg, "ADAG", "process_ps").train(pkg.Dataset(_rows()),
                                                  resume=True)
    elif case == "hang":
        _trainer(pkg, "ADAG", "process_ps",
                 fault_injection={0: ("hang", 1)}).train(
            pkg.Dataset(_rows()))
    elif case == "callable_schedule":
        _trainer(pkg, "ADAG", "process_ps",
                 lr_schedule=lambda step: 0.01).train(pkg.Dataset(_rows()))
    elif case == "recovery_without_elastic":
        _trainer(pkg, "ADAG", "process_ps", recovery=True)
    elif case == "recovery_policy":
        policy = pkg.resilience.RetryPolicy(attempts=3)
        _trainer(pkg, "ADAG", "process_ps", recovery=True, elastic=True,
                 recovery_policy=policy)
    elif case == "row_sparse":
        _trainer(pkg, "ADAG", "process_ps", row_sparse=True)
    elif case == "stream":
        _trainer(pkg, "ADAG", "process_ps", stream=True)
    elif case == "placement_without_elastic":
        _trainer(pkg, "ADAG", "process_ps", ps_placement="process")
    elif case == "freeze_without_elastic":
        _trainer(pkg, "ADAG", "process_ps", freeze_deadline=1.0)
    elif case == "validation":
        t = _trainer(pkg, "ADAG", "process_ps")
        t.train(pkg.Dataset(_rows()), validation_data=pkg.Dataset(_rows()))


REFUSALS = ["checkpoint", "resume", "hang", "callable_schedule",
            "recovery_without_elastic", "recovery_policy", "row_sparse",
            "stream", "placement_without_elastic", "freeze_without_elastic",
            "validation"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_carry_the_jax_messages(case, tmp_path):
    import distkeras_tpu.resilience  # noqa: F401  (jdk.resilience)
    import distkeras_tpu_torch.resilience  # noqa: F401
    with pytest.raises(ValueError) as jax_err:
        _refusal(jdk, case, tmp_path)
    with pytest.raises(ValueError) as port_err:
        _refusal(port, case, tmp_path)
    assert str(port_err.value) == str(jax_err.value)
