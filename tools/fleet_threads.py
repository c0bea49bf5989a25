#!/usr/bin/env python3
"""Where a fleet of in-process replicas loses its throughput: N serving
engines of ``chip_smoke.py``'s phase fleet on one card, each scheduled by
its own thread (as a ``ServingRouter``'s in-process replicas are), against
the same N engines stepped in turn by one thread.

    python3 tools/fleet_threads.py [--sizes 1,2,4] [--device cuda]

Run it from the root of a checkout (it imports that tree's
``chip_smoke`` and ``distkeras_tpu_torch``).  It builds the LM of phase
fleet with phase serve's weights (bf16, full width, paged, blocks of 16,
8 slots a replica), splits phase serve's trace round-robin over N fresh,
warmed-up replicas and offers it as a closed loop of
``FLEET_USERS_PER_REPLICA`` users a replica, submitting to the engines
directly (no router), once per mode:

 - ``threads``: every engine runs its scheduler on its own thread
   (``start()``), the main thread only submits and waits;
 - ``one_thread``: the main thread calls each engine's ``step()`` in
   turn, nothing else runs.

It prints one JSON line per (mode, N): tokens/s, every replica's decode
iterations per second together, the wall time, with the card's name and
power limit; and it checks that both modes give every request the
tokens of the single paged engine.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import threading
import time


def _drive_threads(engines, parts, users):
    """Closed loop over started engines: a proxy's completion (its
    listener) lets its user submit the next request."""
    done, lock, seen = queue.Queue(), threading.Lock(), set()
    handles = {}
    pending = [list(p) for p in parts]
    live = 0

    def submit(i):
        prompt, steps, kw = pending[i].pop(0)
        h = engines[i].submit(prompt, steps, **kw)
        handles[prompt.tobytes() + bytes(str(kw), "utf8")] = h

        def fire():
            if h.done:
                with lock:
                    if id(h) in seen:   # engine ids repeat across engines
                        return
                    seen.add(id(h))
                done.put(i)
        h.set_listener(fire)
        return 1

    for i in range(len(engines)):
        for _ in range(users):
            if pending[i]:
                live += submit(i)
    while live:
        i = done.get(timeout=600.0)
        live -= 1
        if pending[i]:
            live += submit(i)
    return handles


def _drive_one_thread(engines, parts, users):
    handles = {}
    pending = [list(p) for p in parts]
    live = [[] for _ in engines]
    while any(pending) or any(live):
        for i, eng in enumerate(engines):
            while pending[i] and len(live[i]) < users:
                prompt, steps, kw = pending[i].pop(0)
                h = eng.submit(prompt, steps, **kw)
                handles[prompt.tobytes() + bytes(str(kw), "utf8")] = h
                live[i].append(h)
            eng.step()
            live[i] = [h for h in live[i] if not h.done]
    return handles


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fleet_threads: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import chip_smoke as c
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip() if args.device == "cuda" else "cpu")
    rng = np.random.default_rng(c.SEED + 15)   # phase serve's trace
    trace = c._serve_trace(rng)
    model = transformer_lm(**c.LM, device=args.device)
    load_jax_weights(model, c._random_jax_weights(model, rng))
    want = c._serve_run(model, trace, False, args.device, paged=True,
                        block_size=c.PAGED_BLOCK)["rows"]
    key = {p.tobytes() + bytes(str(kw), "utf8"): w
           for (p, _, kw), w in zip(trace, want)}
    ok = True
    for n in [int(x) for x in args.sizes.split(",")]:
        parts = [trace[i::n] for i in range(n)]
        for mode in ("threads", "one_thread"):
            engines = [c._fleet_engine(model).warmup() for _ in range(n)]
            c._sync(args.device)
            t0 = time.perf_counter()
            if mode == "threads":
                for e in engines:
                    e.start()
                handles = _drive_threads(engines, parts,
                                         c.FLEET_USERS_PER_REPLICA)
            else:
                handles = _drive_one_thread(engines, parts,
                                            c.FLEET_USERS_PER_REPLICA)
            c._sync(args.device)
            wall = time.perf_counter() - t0
            for e in engines:
                e.stop()
            equal = all(np.array_equal(h.result(), key[k])
                        for k, h in handles.items())
            ok = ok and equal and len(handles) == len(trace)
            tokens = sum(len(h.tokens) for h in handles.values())
            steps = sum(e.stats["decode_steps"] for e in engines)
            print(json.dumps({
                "mode": mode, "replicas": n,
                "users_per_replica": c.FLEET_USERS_PER_REPLICA,
                "tokens_per_sec": tokens / wall,
                "decode_steps_per_sec": steps / wall, "wall_s": wall,
                "rows_equal": equal, "card": smi}), flush=True)
            del engines
            if args.device == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "card": smi}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
