"""The port's supervised cross-process engine (``execution="process_ps"``
with ``elastic=True``), on the CPU.

 - **Both placements**, each with faults fired by a state, never by a
   wall time: with the PS in the driver (``ps_placement="driver"``, two
   shards) worker 1 is SIGKILLed once the first lease of epoch 0 has
   completed; with the PS in shard processes (``"process"``, two
   journaling shards, bf16 commits, ``recovery``) worker 1 is SIGKILLed
   the same way and shard 0 once epoch 1 has begun.  Every epoch's
   ledger closes over every row (zero lost examples), the dead worker is
   respawned under a fresh id, shard 0 comes back at the same address
   with its generation bumped, and its clock, probed all along, never
   goes backwards within a generation; the model learns.
 - **Journals across the packages**: a port ``ps_shard_main`` restores a
   snapshot that the JAX ``ShardJournal`` wrote (center, clock,
   generation + 1), serves it, and its SIGTERM snapshot reads back
   through the JAX journal.
 - The ``ProcessChaos`` legs of ``tests/test_dcn_chaos.py`` (schedules,
   validation, signals to a stub), and its two-process chaos run at the
   JAX size and with its faults (a worker kill, a shard kill, a shard
   frozen and thawed), each fired at a state instead of the JAX test's
   wall-clock second, marked ``slow`` as the JAX test is.

Children inherit ``OMP_NUM_THREADS=1`` and the repo root on
``PYTHONPATH``; the two training runs start together.
"""

import concurrent.futures
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu.resilience import ShardJournal as JaxShardJournal
from distkeras_tpu_torch import DOWNPOUR, networking
from distkeras_tpu_torch.core.model import serialize_model
from distkeras_tpu_torch.networking import ProcessChaos, ProcessFault
from distkeras_tpu_torch.ps_shard_main import read_addr, read_restored
from distkeras_tpu_torch.ps_sharding import make_shard_plan
from distkeras_tpu_torch.ps_worker_main import save_model_blob
from distkeras_tpu_torch.resilience import wire_probe

import chip_smoke
from test_torch_host_ps import _accuracy, make_dataset, make_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(pred, timeout=120.0, what="state"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"{what} never reached"
        time.sleep(0.002)


def _trainer(placement, **kw):
    return DOWNPOUR(make_model(), num_workers=2, batch_size=16, num_epoch=3,
                    communication_window=4, label_col="label_encoded",
                    worker_optimizer="sgd", learning_rate=0.05,
                    device="cpu", execution="process_ps", elastic=True,
                    ps_shards=2, ps_placement=placement, **kw)


def _completed(sup, epoch: int) -> int:
    return sup.ledger.epoch_report(epoch)["completed"]


def _chaos(trainer, rules, targets):
    """Faults fired at states of a running trainer (``chip_smoke``'s
    ``_StateChaos``: each rule fires once, in order, through a
    ``ProcessChaos`` with ``at_s`` 0)."""
    chaos = chip_smoke._StateChaos(trainer, targets)
    chaos.rules = list(rules)
    return chaos


class _Probe:
    """Shard 0's (generation, clock), probed over the wire all along."""

    def __init__(self, trainer):
        self.trainer, self.seen = trainer, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            sup = getattr(self.trainer, "_process_supervisor", None)
            if sup is not None and sup.ps_addrs:
                got = wire_probe(*sup.ps_addrs[0], timeout=0.5)
                if got is not None:
                    self.seen.append(got)
            time.sleep(0.01)


def _run(trainer, ds, rules, targets, probe=False):
    return _run_chaos(trainer, ds, _chaos(trainer, rules, targets), probe)


def _run_chaos(trainer, ds, chaos, probe=False):
    watch = _Probe(trainer) if probe else None
    chaos.thread.start()
    if watch is not None:
        watch.thread.start()
    try:
        fitted = trainer.train(ds)
    finally:
        chaos.stop.set()
        if watch is not None:
            watch.stop.set()
            watch.thread.join()
        chaos.thread.join()
    return fitted, chaos, watch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ds = make_dataset(n=512)
    worker1 = {"worker1": lambda sup: sup.procs.get(1)}
    kill_worker = (lambda sup: _completed(sup, 0) >= 1, "worker1", "kill")
    out = {"ds": ds}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        driver = _trainer("driver")
        scratch = str(tmp_path_factory.mktemp("procel"))
        process = _trainer("process", recovery=True, wire_dtype="bfloat16",
                           freeze_deadline=3.0, scratch_dir=scratch)
        process.snapshot_interval = 0.05  # journal often: little to drop
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            fd = pool.submit(_run, driver, ds, [kill_worker], worker1)
            fp = pool.submit(
                _run, process, ds,
                [kill_worker,
                 (lambda sup: sup.ledger.epoch >= 1, "shard0", "kill")],
                {**worker1, "shard0": lambda sup: sup.ps_procs[0]},
                probe=True)
            out["driver"] = (driver, *fd.result())
            out["process"] = (process, *fp.result())
    out["scratch"] = scratch
    return out


@pytest.mark.parametrize("placement", ["driver", "process"])
def test_a_killed_worker_loses_no_example(runs, placement):
    t, fitted, chaos, _ = runs[placement]
    assert chaos.fired[0] == ["worker1", "kill", 0]
    assert [(n, a) for n, _, a, pid in chaos.injected
            if pid is not None][0] == ("worker1", "kill")
    reports = t.elastic_stats["lease_completions"]
    assert sorted(reports) == [0, 1, 2]
    for rep in reports.values():  # every epoch's ledger over every row
        assert rep["rows_completed"] == 512
        assert rep["completed"] == rep["leases"] == 8
    assert 1 in t.failed_workers and t.elastic_stats["respawns"] >= 1
    rec = t.elastic_stats["respawn_records"][0]
    assert rec["died"] == 1 and rec["replacement"] >= 2
    # the replacement wrote a result under its fresh id
    ids = [r.worker_id for r in t._process_results]
    assert 1 not in ids and rec["replacement"] in ids
    # every window ran (a stolen one twice); the dead worker's history
    # died with it
    lost = t.elastic_stats["windows_per_worker"].get(1, 0)
    assert len(t.get_history()) >= 24 - lost
    assert _accuracy(fitted, runs["ds"]) > 0.8


def test_a_killed_shard_comes_back_at_its_address(runs):
    t, fitted, chaos, watch = runs["process"]
    assert ["shard0", "kill", 1] in chaos.fired
    stats = t.elastic_stats
    assert stats["ps_restarts"][0] >= 1
    assert [r["shard"] for r in stats["ps_recoveries"]].count(0) >= 1
    # the same address: the addr file the respawn re-bound, the probe's
    sup = t._process_supervisor
    addr_dir = os.path.join(runs["scratch"], "addrs")
    host, port, gen = read_addr(os.path.join(addr_dir, "shard_0.addr"))
    assert (host, port) == sup.ps_addrs[0]
    assert gen >= 1
    # generation bumped, the clock it restored published, and the probed
    # clock never goes backwards within a generation
    gens = [g for g, _ in watch.seen]
    assert gens == sorted(gens) and gens[0] == 0 and gens[-1] == gen
    for g in set(gens):
        clocks = [c for gg, c in watch.seen if gg == g]
        assert clocks == sorted(clocks)
        if g > 0:
            assert read_restored(addr_dir, 0, g) <= clocks[0]
    last0 = max(c for g, c in watch.seen if g == 0)
    assert read_restored(addr_dir, 0, 1) <= last0
    assert max(c for _, c in watch.seen) > last0  # it went on training
    # the final center came over the wire: finite, and it learned
    assert all(np.isfinite(w).all() for w in fitted.get_weights())


def test_process_launches_are_summed_from_the_children(runs):
    t = runs["driver"][0]
    assert t.process_launches and set(t.process_launches.values()) == {0}
    assert sorted(t.process_launches) == sorted(
        t._process_results[0].launches)
    assert t.process_native_compiles == 0  # the driver built, they loaded


def test_a_port_shard_restores_a_jax_journal(tmp_path, monkeypatch):
    """A JAX ``ShardJournal`` snapshot of shard 1 of 2 (generation 2,
    clock 7) restores in a port ``ps_shard_main``: generation 3, clock 7,
    the journal's center; its SIGTERM snapshot reads back in JAX."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    blob = serialize_model(make_model())
    weights = [np.asarray(w) for w in blob["weights"]]
    plan = make_shard_plan([w.shape for w in weights],
                           [w.dtype for w in weights], 2)
    rng = np.random.default_rng(5)
    center = [rng.standard_normal(w.shape).astype(np.float32)
              for w in plan.scatter(weights)[1]]
    journal_dir, addr_dir = tmp_path / "journal", tmp_path / "addrs"
    addr_dir.mkdir()
    JaxShardJournal(str(journal_dir)).save(1, 4, center, 7, 2)
    model_path = str(tmp_path / "model.npz")
    save_model_blob(model_path, blob)
    cfg = tmp_path / "shard.json"
    cfg.write_text(json.dumps({
        "algorithm": "downpour", "model_path": model_path,
        "num_workers": 2, "num_shards": 2, "addr_dir": str(addr_dir),
        "journal_dir": str(journal_dir), "snapshot_interval": 30.0}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen([sys.executable, "-m",
                             "distkeras_tpu_torch.ps_shard_main", str(cfg),
                             "1"], env=env)
    try:
        path = addr_dir / "shard_1.addr"
        _wait(lambda: path.exists() or proc.poll() is not None, 60.0)
        host, port, gen = read_addr(str(path))
        assert gen == 3 and read_restored(str(addr_dir), 1, 3) == 7
        assert wire_probe(host, port) == (3, 7)
        sock = networking.connect(host, port)
        try:
            networking.send_opcode(sock, b"p")
            reply = networking.recv_data(sock)
            networking.send_opcode(sock, b"q")
        finally:
            sock.close()
        assert reply["clock"] == 7 and reply["gen"] == 3
        for a, b in zip(reply["weights"], center):
            np.testing.assert_array_equal(a, b)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    latest = JaxShardJournal(str(journal_dir)).latest(1)
    assert (latest["generation"], latest["clock"]) == (3, 7)
    assert latest["snap_id"] == 5
    for a, b in zip(latest["center"], center):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the ProcessChaos legs of tests/test_dcn_chaos.py
# ---------------------------------------------------------------------------

def test_process_chaos_schedule_is_deterministic():
    targets = {"w0": 111, "w1": 222}
    kw = dict(auto={"kill": 0.1, "stop": (0.2, 0.5)},
              tick_s=0.25, horizon_s=5.0)
    a = ProcessChaos(targets, seed=3, **kw)
    b = ProcessChaos(targets, seed=3, **kw)
    assert a.schedule == b.schedule
    assert any(f.action == "kill" for f in a.schedule)
    stops = [f for f in a.schedule if f.action == "stop"]
    conts = [f for f in a.schedule if f.action == "cont"]
    assert stops
    for f in stops:
        assert any(c.target == f.target
                   and abs(c.at_s - (f.at_s + 0.5)) < 1e-9 for c in conts)
    assert ProcessChaos(targets, seed=4, **kw).schedule != a.schedule


def test_process_chaos_validates_targets_and_actions():
    with pytest.raises(ValueError, match="unknown target"):
        ProcessChaos({"a": 1}, faults=[ProcessFault("b", 0.1, "kill")])
    with pytest.raises(ValueError, match="action"):
        ProcessChaos({"a": 1}, faults=[ProcessFault("a", 0.1, "nuke")])
    with pytest.raises(ValueError, match="auto action"):
        ProcessChaos({"a": 1}, auto={"explode": 0.5})


def test_process_chaos_fires_signals_and_records_dead_slots():
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(30)"])
    chaos = ProcessChaos({"w": lambda: proc},
                         faults=[ProcessFault("w", 0.05, "stop"),
                                 ProcessFault("w", 0.15, "cont"),
                                 ProcessFault("w", 0.25, "kill"),
                                 ProcessFault("w", 0.6, "kill")])
    try:
        chaos.start()
        assert proc.wait(timeout=10.0) == -signal.SIGKILL
        _wait(lambda: len(chaos.injected) == 4, timeout=5.0)
        assert [(t, a) for t, _, a, _ in chaos.injected] == [
            ("w", "stop"), ("w", "cont"), ("w", "kill"), ("w", "kill")]
        pids = [p for _, _, _, p in chaos.injected]
        assert pids[:3] == [proc.pid] * 3
        assert pids[3] is None
    finally:
        chaos.stop()
        if proc.poll() is None:
            proc.kill()


# ---------------------------------------------------------------------------
# tests/test_dcn_chaos.py:465, at the JAX size
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_two_process_dcn_chaos_zero_loss_and_journal_respawn(monkeypatch):
    """Worker processes training through a sharded, recoverable,
    elastic, process-placed PS over compressed wire survive a worker
    SIGKILL, a PS-shard SIGKILL (same-address journal respawn, generation
    bumped) and a freeze-and-heal partition, completing every epoch with
    zero lost examples and a final model in the single-host band."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ds = make_dataset(n=1024)
    t = DOWNPOUR(make_model(), num_workers=2, batch_size=16, num_epoch=3,
                 communication_window=4, label_col="label_encoded",
                 worker_optimizer="sgd", learning_rate=0.05, device="cpu",
                 execution="process_ps", elastic=True, recovery=True,
                 ps_shards=2, ps_placement="process",
                 wire_dtype="bfloat16", freeze_deadline=3.0)
    t.snapshot_interval = 0.2  # journal often: tight bounded-loss window
    # the JAX test fires at 2, 6, 12 and 12.6 s of wall time, which the
    # port's CPU run outpaces; here each fault fires at a state of the run
    chaos = _chaos(t, [], {"worker1": lambda sup: sup.procs.get(1),
                           "shard0": lambda sup: sup.ps_procs[0]})
    chaos.rules = [
        # abrupt worker death, once a lease of epoch 0 has completed
        (lambda sup: _completed(sup, 0) >= 1, "worker1", "kill"),
        # PS death -> journal respawn, same address, once epoch 1 began
        (lambda sup: sup.ledger.epoch >= 1, "shard0", "kill"),
        # partition: the (respawned) shard frozen, no FIN/RST ...
        (lambda sup: sup.ledger.epoch >= 2, "shard0", "stop"),
        # ... healed under the supervisor's deadline: as soon as a probe
        # has started after the freeze
        (lambda sup: sup._last_ps_probe
         > chaos.fired_at[("shard0", "stop")], "shard0", "cont")]
    fitted, chaos, _ = _run_chaos(t, ds, chaos)
    box = {"fitted": fitted}
    assert [f[:2] for f in chaos.fired] == [
        ["worker1", "kill"], ["shard0", "kill"], ["shard0", "stop"],
        ["shard0", "cont"]]
    reports = t.elastic_stats["lease_completions"]
    assert sorted(reports) == [0, 1, 2]
    for rep in reports.values():
        assert rep["rows_completed"] == 1024
        assert rep["completed"] == rep["leases"]
    delivered = {(tgt, act) for tgt, _, act, pid in chaos.injected
                 if pid is not None}
    assert ("worker1", "kill") in delivered
    assert 1 in t.worker_failures and t.elastic_stats["respawns"] >= 1
    assert ("shard0", "kill") in delivered
    assert t.elastic_stats["ps_restarts"][0] >= 1
    recs = [r for r in t.elastic_stats["ps_recoveries"]
            if r.get("shard") == 0]
    assert recs
    assert _accuracy(box["fitted"], ds) > 0.8
