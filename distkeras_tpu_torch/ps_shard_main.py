"""Standalone PS shard process, port of ``distkeras_tpu/ps_shard_main.py``:
one shard of a sharded host PS as its own OS process
(``python -m distkeras_tpu_torch.ps_shard_main <config.json> [shard]``).

The shard is host code (numpy applies, the socket server), so the port's
copy differs from the JAX module only in what it imports: the port's
``parameter_servers``, ``ps_sharding``, ``resilience.ShardJournal`` (whose
npz layout is the JAX journal's, so either package's shard restores the
other's snapshots) and the npz model codec.  The JAX module's platform
setup (``honor_platform_env``) has no counterpart: the shard touches no
device.

The JAX module's description follows.

The in-process topology wraps every shard in a ``ShardedServerGroup``
inside the driver; this entrypoint is the cross-process twin — the driver
(or any ``JobRunner`` host) launches one of these per shard and workers
dial them exactly like in-process shards, because the process boundary is
invisible to the wire protocol.  Three contracts make the shard
*survivable* rather than merely remote:

- **Journal-backed respawn.**  A ``journal_dir`` (shared scratch: NFS in a
  real deployment, a tempdir under ``LocalJobRunner``) holds this shard's
  ``ShardJournal``.  On start the newest snapshot — if any — restores the
  center slice and clock, and the server comes up with its **generation
  bumped**, so commits computed against the pre-crash center are rejected
  by the existing generation handshake.  Windows committed after the last
  snapshot are dropped: the same bounded-loss contract as the in-process
  ``ShardSupervisor.respawn_shard``, now crossing an OS process death.
- **Same-address respawn.**  The first launch binds an ephemeral port and
  publishes ``host port generation`` to ``addr_dir/shard_<j>.addr``
  (atomic rename); a respawn finds the file and re-binds the *same* port,
  so workers' recovery redial loops reconnect without a membership change.
- **The clock a generation starts from** goes to
  ``addr_dir/shard_<j>.gen<g>`` (the port's addition), so the driver can
  wait for the commits that can still land before its final read.
- **Clean handoff.**  SIGTERM/SIGINT journal a final snapshot and stop the
  server; the driver gathers the final center over the wire (a plain
  sharded pull) before terminating the group.

Config JSON keys: ``algorithm``, ``model_path``, ``num_workers``,
``num_shards`` (for the deterministic ``make_shard_plan``), ``bind_host``,
``addr_dir``, ``journal_dir`` (optional — no journal means no restore),
``ps_core``, ``coalesce``, ``apply_kernel``, ``snapshot_interval`` (s).
The shard id comes from argv (preferred) or ``DISTKERAS_TPU_PROCESS_ID``
(the ``Job.host_env`` slot), so the same config file serves every shard.
"""

import json
import os
import signal
import sys
import threading
import time

import numpy as np


def _publish_addr(path: str, host: str, port: int, generation: int) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{host} {port} {generation}\n")
    os.replace(tmp, path)


def _publish_restored(addr_dir: str, shard_id: int, generation: int,
                      clock: int) -> None:
    """``addr_dir/shard_<j>.gen<g>``: the clock generation ``g`` of shard
    ``j`` started from (0 on a first launch, the journal's on a respawn).
    The driver adds the commits its workers sent at that generation to it
    before it reads the final center (the port's addition: the addr file
    keeps the JAX layout)."""
    path = os.path.join(addr_dir, f"shard_{shard_id}.gen{generation}")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{clock}\n")
    os.replace(tmp, path)


def read_restored(addr_dir: str, shard_id: int, generation: int):
    """The clock a shard's generation started from, or None if that
    generation has not published it yet."""
    path = os.path.join(addr_dir, f"shard_{shard_id}.gen{generation}")
    try:
        with open(path) as f:
            return int(f.read())
    except FileNotFoundError:
        return None


def read_addr(path: str):
    """Parse a published ``shard_<j>.addr`` file → (host, port, generation)."""
    with open(path) as f:
        host, port, gen = f.read().split()
    return host, int(port), int(gen)


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) not in (2, 3):
        print("usage: python -m distkeras_tpu_torch.ps_shard_main "
              "<config.json> [shard_id]", file=sys.stderr)
        return 2

    with open(argv[1]) as f:
        cfg = json.load(f)
    if len(argv) == 3:
        shard_id = int(argv[2])
    else:
        shard_id = int(os.environ.get("DISTKERAS_TPU_PROCESS_ID",
                                      cfg.get("shard_id", 0)))

    from .parameter_servers import (allocate_parameter_server,
                                    make_socket_server)
    from .ps_sharding import make_shard_plan
    from .ps_worker_main import load_model_blob
    from .resilience import ShardJournal

    blob = load_model_blob(cfg["model_path"])
    weights = [np.asarray(w) for w in blob["weights"]]
    plan = make_shard_plan([w.shape for w in weights],
                           [w.dtype for w in weights],
                           int(cfg["num_shards"]))
    shard_w = plan.scatter(weights)[shard_id]

    # journal restore (respawn path): newest snapshot wins, generation bumps
    journal = None
    snap_id, clock, generation = 0, 0, 0
    if cfg.get("journal_dir"):
        journal = ShardJournal(cfg["journal_dir"],
                               max_to_keep=int(cfg.get("snap_retention", 2)))
        latest = journal.latest(shard_id)
        if latest is not None:
            shard_w = latest["center"]
            clock = latest["clock"]
            generation = latest["generation"] + 1
            snap_id = latest["snap_id"] + 1

    ps = allocate_parameter_server(
        cfg["algorithm"], {"model": blob["model"], "weights": shard_w},
        int(cfg["num_workers"]), apply_kernel=cfg.get("apply_kernel"))
    ps.num_updates = clock

    # same-address respawn: a published addr file pins this shard's port
    bind_host = cfg.get("bind_host", "127.0.0.1")
    addr_path = os.path.join(cfg["addr_dir"], f"shard_{shard_id}.addr")
    port = 0
    if os.path.exists(addr_path):
        _, port, _ = read_addr(addr_path)

    server = None
    for attempt in range(40):  # the dying predecessor may still hold the port
        try:
            server = make_socket_server(
                ps, host=bind_host, port=port, generation=generation,
                ps_core=cfg.get("ps_core", "event"),
                coalesce=bool(cfg.get("coalesce", True)),
                idle_deadline=cfg.get("idle_deadline"))
            server.start()
            break
        except OSError:
            if attempt == 39:
                raise
            time.sleep(0.25)
    _publish_restored(cfg["addr_dir"], shard_id, generation, clock)
    _publish_addr(addr_path, bind_host, server.port, generation)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    def snapshot_once() -> None:
        nonlocal snap_id
        if journal is None:
            return
        with server.ps._lock:
            center = [w.copy() for w in server.ps.center]
            clk = server.ps.num_updates
        journal.save(shard_id, snap_id, center, clk, generation)
        snap_id += 1

    interval = float(cfg.get("snapshot_interval", 0.5))
    if journal is not None:
        def journal_loop() -> None:
            while not stop.wait(interval):
                snapshot_once()
        threading.Thread(target=journal_loop, daemon=True,
                         name="dkt-shard-journal").start()

    stop.wait()
    snapshot_once()  # the clean-shutdown snapshot: zero-loss handoff
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
