#!/usr/bin/env python3
"""Where the time of the port's serving slice goes, on a CUDA card.

    python3 tools/profile_torch_slice.py [--out build/profile.json]

Builds the full-width ``transformer_lm`` of ``chip_smoke.py`` (vocab 512,
seq 2048, d_model 256, 8 heads, 2 kv heads, 4 layers, mlp 1024, bf16) in
its ``"full"`` and ``"rolling_window"`` forms, with random weights drawn
from a numpy seed by ``chip_smoke.py``'s rule, warms ``ModelPredictor.predict`` up, then traces one predict of
16 rows (2 batches of 8) under ``torch.profiler``.  It prints, per form,
one JSON line: the wall time of the call, the device's busy time (the sum
of kernel and copy durations on the card; one stream, so they do not
overlap) and idle share, and the device time by kernel, largest first,
grouped as the flash kernel, matrix products, copies and the rest.  The
whole result also goes to ``--out``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention_fwd"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul"
    return "other"


def profile_form(form, extra, data):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from distkeras_tpu_torch import (FittedModel, ModelPredictor,
                                     load_jax_weights, transformer_lm)
    rng = np.random.default_rng(chip_smoke.SEED)
    model = transformer_lm(**chip_smoke.LM, **extra)
    load_jax_weights(model, chip_smoke._random_jax_weights(model, rng))
    predictor = ModelPredictor(FittedModel(model),
                               batch_size=chip_smoke.BATCH)
    predictor.predict(data)
    predictor.predict(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(data)  # ends with a copy to the host: synced
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, by_group = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + us
        g = group(evt.name)
        by_group[g] = by_group.get(g, 0.0) + us
    busy_ms = sum(by_kernel.values()) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"form": form, "rows": len(data),
            "batch_size": chip_smoke.BATCH, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
            "by_group_ms": {k: v / 1e3 for k, v in
                            sorted(by_group.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "profile_torch_slice.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke
    from distkeras_tpu_torch import Dataset, kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    data = Dataset({"features": np.random.default_rng(
        chip_smoke.SEED).integers(
        0, chip_smoke.LM["vocab_size"],
        (chip_smoke.ROWS, chip_smoke.LM["seq_len"])).astype(np.int32)})
    results = {"card": smi, "torch": torch.__version__, "forms": []}
    for form, extra in chip_smoke.FORMS.items():
        row = profile_form(form, extra, data)
        results["forms"].append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
