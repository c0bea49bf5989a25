#!/usr/bin/env python3
"""Where a host-PS worker thread's time goes, at 1, 2 and 4 threads.

Runs ``ADAG(execution="host_ps")`` over the north-star ConvNet
(``mnist_convnet`` bf16, adam, batch 512, window 12, 60,000 MNIST rows
or their synthetic stand-in, one epoch, ``comm_overlap`` on) with N
worker threads, and wraps each worker's pieces with host-clock timers:

 - ``window``: issuing the window program (the host's launch work for 12
   steps; the card runs them later);
 - ``fetch``: the one device→host copy of the weights and the loss (it
   waits for the card, and on the default stream for every worker's
   queued work);
 - ``send``: ``update_begin`` (the wire coding and the send);
 - ``recv``: ``update_finish`` (waiting for the server's reply);
 - ``load``: ``_weights_to_params`` (the host→device copy);

and, on the server's thread, ``apply`` (the drains) and ``encode`` (the
shared reply frames).  One JSON line per thread count: examples/s over
the ``train()`` call, the seconds before the first window (the server,
the workers' models, the data's copy to the card), the workers' loop
seconds, and each piece's seconds summed over the workers.

``--streams`` runs every worker thread on a CUDA stream of its own
instead of the card's default stream (a lever the port does not pull
yet: its workers share the default stream).

    python3 tools/host_ps_threads.py [--threads 1,2,4] [--streams]
        [--device cpu --rows 3072 --batch 64 --window 4]

Without a card and without ``--device cpu`` it fails.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Timers:
    """Seconds by (thread, piece), summed; the first window's start."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sums = collections.defaultdict(float)
        self.first = None
        self.last = None

    def add(self, piece: str, t0: float, t1: float) -> None:
        with self.lock:
            self.sums[(threading.current_thread().name, piece)] += t1 - t0
            if piece == "window":
                self.first = t0 if self.first is None else min(self.first,
                                                                t0)
            self.last = t1 if self.last is None else max(self.last, t1)

    def by_piece(self) -> dict:
        out = collections.defaultdict(float)
        for (_, piece), v in self.sums.items():
            out[piece] += v
        return dict(out)


def _timed(timers: Timers, piece: str, fn):
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            timers.add(piece, t0, time.perf_counter())
    return wrapper


def instrument(timers: Timers, streams: bool):
    """Wrap the worker and server pieces (class attributes, for every
    worker the trainer builds); returns an undo callable."""
    import torch
    from distkeras_tpu_torch import parameter_servers as ps
    from distkeras_tpu_torch import workers as wk
    saved = []

    def patch(cls, name, new):
        saved.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, new)

    for name, piece in (("_fetch", "fetch"), ("update_begin", "send"),
                        ("update_finish", "recv"),
                        ("_weights_to_params", "load")):
        owner = wk.PSWorker if name in wk.PSWorker.__dict__ else wk.Worker
        patch(owner, name, _timed(timers, piece, owner.__dict__[name]))
    build = wk.Worker.__dict__["_build_window_fn"]

    def timed_build(self):
        fn = build(self)
        if getattr(fn, "_timed", False):
            return fn
        timed = _timed(timers, "window", fn)
        timed._timed = True
        self._window_fn = timed
        return timed
    patch(wk.Worker, "_build_window_fn", timed_build)
    patch(ps.ParameterServer, "_apply_drain_locked",
          _timed(timers, "apply",
                 ps.ParameterServer.__dict__["_apply_drain_locked"]))
    patch(ps.SocketParameterServer, "_encode_shared",
          _timed(timers, "encode",
                 ps.SocketParameterServer.__dict__["_encode_shared"]))
    if streams:
        train = wk.PSWorker.__dict__["train"]

        def on_own_stream(self, *a, **kw):
            with torch.cuda.stream(torch.cuda.Stream(self.device)):
                return train(self, *a, **kw)
        patch(wk.PSWorker, "train", on_own_stream)

    def undo():
        for cls, name, old in reversed(saved):
            setattr(cls, name, old)
    return undo


def run(threads: int, args, rows) -> dict:
    import numpy as np
    from distkeras_tpu_torch import ADAG, Dataset, models
    x, y = rows
    timers = Timers()
    undo = instrument(timers, args.streams)
    try:
        t = ADAG(models.mnist_convnet("bfloat16", device=args.device),
                 num_workers=threads, batch_size=args.batch, num_epoch=1,
                 communication_window=args.window, worker_optimizer="adam",
                 execution="host_ps", device=args.device, seed=0)
        t0 = time.perf_counter()
        t.train(Dataset({"features": x, "label": y}))
        if args.device == "cuda":
            import torch
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        undo()
    pieces = timers.by_piece()
    loop = timers.last - timers.first
    return {"threads": threads, "streams": args.streams,
            "examples_per_sec": len(x) / seconds, "seconds": seconds,
            "setup_s": timers.first - t0, "loop_s": loop,
            "windows": sum(w._commits for w in t._ps_workers),
            "pieces_s": pieces,
            "worker_pieces_share_of_loop": {
                k: v / (loop * threads) for k, v in pieces.items()
                if k not in ("apply", "encode")},
            "loss_first_last": [[w.history[0], w.history[-1]]
                                for w in t._ps_workers],
            "finite": bool(all(np.isfinite(c).all()
                               for c in t._ps_server.ps.center))}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--threads", default="1,2,4")
    p.add_argument("--streams", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=60000)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--window", type=int, default=12)
    args = p.parse_args()
    import numpy as np
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("host_ps_threads: no CUDA device is available",
              file=sys.stderr)
        return 1
    from distkeras_tpu_torch.data import load_mnist
    train, _ = load_mnist(n_train=args.rows, n_test=1)
    rows = (np.asarray(train["features"], np.float32) / 255.0,
            np.eye(10, dtype=np.float32)[np.asarray(train["label"])])
    card = args.device
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    run(1, args, (rows[0][:args.batch * args.window],
                  rows[1][:args.batch * args.window]))  # warm-up
    for n in [int(v) for v in args.threads.split(",")]:
        print(json.dumps({**run(n, args, rows), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
