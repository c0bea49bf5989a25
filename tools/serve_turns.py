#!/usr/bin/env python3
"""Time the serving engine over ``chip_smoke.py``'s phase serve trace, on
the graph route, for an A/B of two trees on one card.

    python3 tools/serve_turns.py [--runs 3] [--form full] [--paged]

Run it from the root of the tree to measure (it imports that tree's
``chip_smoke`` and ``distkeras_tpu_torch`` from the current directory, so
an older checkout unpacked elsewhere is measured by running this file
from there).  It builds the LM of phase serve with phase serve's weights
(bf16, full width), runs the trace once to warm up, then ``--runs``
times, and prints one JSON line a run: tokens/s, ms per decode-only
iteration, TTFT p50/p99 and wall time, with the card's name and power
limit.  Alternate the trees between calls (A, B, B, A) and compare only
within one chip call.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("serve_turns: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--form", default="full",
                    choices=("full", "rolling_window"))
    ap.add_argument("--paged", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import chip_smoke as c
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rng = np.random.default_rng(c.SEED + 15)     # phase serve's draws
    trace = c._serve_trace(rng)
    for form, (extra, rolling) in c.SERVE_FORMS.items():
        model = transformer_lm(**c.LM, **extra, device="cuda")
        load_jax_weights(model, c._random_jax_weights(model, rng))
        if form == args.form:
            break
    knobs = dict(paged=True, block_size=16) if args.paged else {}
    for i in range(args.runs + 1):
        r = c._serve_run(model, trace, rolling, "cuda", **knobs)
        if i == 0:
            continue                               # the warm-up run
        print(json.dumps({
            "tree": os.path.basename(os.getcwd()), "form": args.form,
            "paged": args.paged, "run": i,
            **{k: r[k] for k in ("tokens_per_sec", "ms_per_decode_step",
                                 "ttft_ms_p50", "ttft_ms_p99", "wall_s")},
            "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
