"""Standalone parameter-server worker process, port of
``distkeras_tpu/ps_worker_main.py``: the executor of the cross-process
engine (``execution="process_ps"``).

A process entry point that loads its shard (static mode) or the whole
dataset (elastic mode) and the model blob from disk, connects to the PS
over TCP, trains with the port's window program on the device its config
names, and writes its history back for the driver to collect.  Launched
by ``parameter_servers.run_process_ps_training`` through
``job_deployment.Job`` (``LocalJobRunner`` for same-host processes).  The
worker id comes from argv or the ``DISTKERAS_TPU_PROCESS_ID`` env var
``Job.host_env`` renders, and ``initialize_from_env()`` runs first, as in
the JAX module.

What differs from the JAX module:

 - **The device comes from the config** (``"device"``: ``"cuda"``,
   ``"cuda:0"`` or ``"cpu"``; the JAX worker reads the platform from its
   environment).  A config without one gets the port's card rule: the
   worker raises where no CUDA card is present; it never drops to the CPU.
 - **The result file** keeps the JAX key ``history`` (a JAX driver reads a
   port result) and adds ``train_span`` (the wall-clock span of the
   training itself), ``sent`` (rows of shard, generation (-1: none),
   commits sent at it: what can still land, ``workers.PSWorker.sent_by_gen``)
   and the kernel launch counters of this process (``launch_names``,
   ``launches``): ``kernels.count_launch`` counts inside one process, so
   the driver sums its children's.
 - **The driver's numerics switches** (``"backends"``: TF32 in matmuls
   and convolutions, cuDNN's deterministic and benchmark choices, the
   intra-op thread count) are set
   before the model is built, so a process trains as a thread of the
   driver would.
 - **Workers warm up first.**  Before its first lease (elastic) or its
   shard (static) a child runs one masked window (``compile_windows``,
   which leaves the model as it was): its first window builds the
   process's CUDA context, cuDNN and cuBLAS handles, and inside a live
   lease deadline it would read as wedged; outside the training span it
   keeps that cost out of the children's examples/s.

Usage: ``python -m distkeras_tpu_torch.ps_worker_main <config.json>
[worker_id]``
"""

from __future__ import annotations

import json
import os
import sys
import time


def load_model_blob(path: str) -> dict:
    """Read a {'model': json, 'weights': [...]} blob from disk (the
    framework's one npz layout, ``core.model``)."""
    from .core.model import read_npz_blob
    return read_npz_blob(path)


def save_model_blob(path: str, blob: dict) -> None:
    from .core.model import write_npz_blob
    write_npz_blob(path, blob)


def write_result(path: str, worker, span=(0.0, 0.0)) -> None:
    """A worker's result file: its window losses under the JAX key, the
    commits it sent by (shard, generation), this process's kernel
    launches and host-extension compiles, and the wall-clock span of its
    training (``time.time()`` at its first pull and after its last
    window: the imports, the device's start and the warm-up fall outside
    it)."""
    import numpy as np

    from . import native
    from .kernels import launch_counts
    sent = [(shard, -1 if gen is None else int(gen), int(count))
            for (shard, gen), count in sorted(
                worker.sent_by_gen.items(),
                key=lambda kv: (kv[0][0], -1 if kv[0][1] is None
                                else kv[0][1]))]
    counts = launch_counts()
    names = sorted(counts)
    np.savez(path, history=np.asarray(worker.history, np.float32),
             sent=np.asarray(sent, np.int64).reshape(-1, 3),
             launch_names=np.asarray(names, dtype=str),
             launches=np.asarray([counts[k] for k in names], np.int64),
             native_compiles=np.asarray(native.compiles, np.int64),
             train_span=np.asarray(span, np.float64))


def apply_backends(flags) -> None:
    """Set the driver's process-wide numerics switches in this process
    (``parameter_servers._backend_flags``); None leaves torch's own."""
    if not flags:
        return
    import torch
    torch.backends.cuda.matmul.allow_tf32 = bool(flags["matmul_allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(flags["cudnn_allow_tf32"])
    torch.backends.cudnn.deterministic = bool(flags["cudnn_deterministic"])
    torch.backends.cudnn.benchmark = bool(flags["cudnn_benchmark"])
    torch.set_num_threads(int(flags["num_threads"]))


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) not in (2, 3):
        print("usage: python -m distkeras_tpu_torch.ps_worker_main "
              "<config.json> [worker_id]", file=sys.stderr)
        return 2
    from .job_deployment import initialize_from_env
    initialize_from_env()

    import numpy as np

    from .workers import WORKER_CLASSES

    with open(argv[1]) as f:
        cfg = json.load(f)
    # argv wins over the env slot: a supervisor respawning ONE worker under
    # a fresh id appends it to the same config's argv
    if len(argv) == 3:
        worker_id = int(argv[2])
    else:
        worker_id = int(os.environ.get("DISTKERAS_TPU_PROCESS_ID",
                                       cfg.get("worker_id", 0)))

    blob = load_model_blob(cfg["model_path"])

    optimizer = cfg["worker_optimizer"]
    if isinstance(optimizer, dict):  # Optimizer.get_config round-trip
        from .core.optimizers import Optimizer
        optimizer = Optimizer(**optimizer)

    # the config is _worker_kwargs' output plus transport keys: pass the
    # kwargs through verbatim (``device`` included: absent, it is the card)
    transport = {"algorithm", "model_path", "shard_paths", "result_paths",
                 "worker_optimizer", "worker_id", "num_shards",
                 "shard_addrs", "lease_host", "lease_port", "data_path",
                 "result_dir", "backends"}
    apply_backends(cfg.get("backends"))
    kw = {k: v for k, v in cfg.items() if k not in transport}

    # sharded PS: rebuild the deterministic shard plan from the blob (same
    # (shapes, dtypes, num_shards) → same plan as the driver's) and hand the
    # worker the pinned shard addresses — same-address respawn means these
    # stay valid across a PS shard death
    if int(cfg.get("num_shards", 1)) > 1:
        from .ps_sharding import make_shard_plan
        weights = [np.asarray(w) for w in blob["weights"]]
        kw["shard_plan"] = make_shard_plan(
            [w.shape for w in weights], [w.dtype for w in weights],
            int(cfg["num_shards"]))
        kw["shard_addrs"] = [(str(h), int(p))
                             for h, p in cfg["shard_addrs"]]

    worker_cls = WORKER_CLASSES[cfg["algorithm"]]
    worker = worker_cls(blob, worker_optimizer=optimizer, **kw)

    if cfg.get("lease_port"):
        # elastic mode: no static shard — lease row ranges of the full
        # dataset from the driver's LeaseServer, epoch by epoch, exactly
        # like the in-process elastic engine's run_fn
        from .resilience import LeaseClient
        with np.load(cfg["data_path"]) as z:
            x, y = z["x"], z["y"]
        client = LeaseClient(cfg.get("lease_host", "127.0.0.1"),
                             int(cfg["lease_port"]))
        state, last, warm, start = None, None, False, None
        try:
            client.connect()
            while True:
                epoch = client.wait_epoch(last)
                if epoch is None:
                    break
                last = epoch
                # the driver's global shuffle, reproduced bit for bit: the
                # lease's row range indexes the same permutation everywhere
                perm = np.random.default_rng(
                    worker.seed + 7919 * epoch).permutation(len(x))
                xe, ye = x[perm], y[perm]
                if not warm:
                    # this process's first window, off the lease clock
                    worker.compile_windows(xe, ye)
                    warm = True
                    start = time.time()

                def data_fn(lease):
                    return (xe[lease.start:lease.stop],
                            ye[lease.start:lease.stop])

                res = worker.train_leases(worker_id, client, data_fn,
                                          initial_state=state)
                state = res["state"]
        finally:
            client.close()
        write_result(os.path.join(cfg["result_dir"],
                                  f"result_{worker_id}.npz"), worker,
                     (start or time.time(), time.time()))
        return 0

    with np.load(cfg["shard_paths"][worker_id]) as z:
        shard = {cfg["features_col"]: z["x"], cfg["label_col"]: z["y"]}
    # this process's first window, outside the training span (the model
    # is unchanged by it)
    worker.compile_windows(shard[cfg["features_col"]],
                           shard[cfg["label_col"]])
    start = time.time()
    worker.train(worker_id, shard)
    write_result(cfg["result_paths"][worker_id], worker,
                 (start, time.time()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
