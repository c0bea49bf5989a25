#!/usr/bin/env python3
"""Time two builds of the SIMT flash backward against each other, on a CUDA card.

    python3 tools/time_simt_backward.py --ref-csrc OTHER/distkeras_tpu_torch/csrc

Compiles ``flash_attention_bwd.cu`` from ``--ref-csrc`` (for example the
csrc directory of an older checkout, unpacked with ``git archive``) and from
this checkout, with the flags of ``distkeras_tpu_torch/kernels.py``, into
``build/time_simt_backward/``.  At every case of ``chip_smoke.py``'s phases
kernel_train and wide, in every dtype that the SIMT variant serves there
(``_backward_variant``), it runs the dq and dk/dv entries of both builds on
the same random inputs (lse from the plain forward), holds each build's
dq, dk and dv against the plain version under ``chip_smoke.py``'s
per-element rule (``TRAIN_TOL_ULP`` + ``TRAIN_TOL_F32`` of the largest
value), and times each entry through its C function alone (no Python
wrapper: CUDA-event medians, in the order ref, new, new, ref).  It prints
one JSON line per case, the card's name and power limit, and a summary; it
exits non-zero if either build misses the tolerance.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402  (constants only; it imports torch lazily)
from compare_simt_builds import build, entry, tail_args  # noqa: E402

SOURCE = "flash_attention_bwd"
WARMUP, REPS = 3, 10


def timed(fn) -> list:
    """CUDA-event times of ``REPS`` calls after ``WARMUP``."""
    import torch
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def pair(libs: dict, q, k, v, out, lse, do, causal, window) -> dict:
    """The build's dq and dk/dv entries on these inputs: their outputs and
    a launcher of each."""
    import torch
    tail = tail_args(q, k.shape[2], causal, window)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fdq = entry(libs, SOURCE, "flash_attention_bwd_dq", 8)
    fdkv = entry(libs, SOURCE, "flash_attention_bwd_dkv", 8)
    dq_ptrs = [t.data_ptr() for t in (q, k, v, out, do, lse, delta, dq)]
    dkv_ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)]

    def launch(fn, ptrs):
        rc = fn(*ptrs, *tail)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    launch(fdq, dq_ptrs)
    launch(fdkv, dkv_ptrs)
    torch.cuda.synchronize()
    return {"out": {"dq": dq, "dk": dk, "dv": dv, "delta": delta},
            "dq": lambda: launch(fdq, dq_ptrs),
            "dkv": lambda: launch(fdkv, dkv_ptrs)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ref-csrc", required=True, type=Path)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_simt_backward: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "time_simt_backward"
    builds = {"ref": build(args.ref_csrc.resolve(), out_dir / "ref",
                           (SOURCE,)),
              "new": build(ROOT / "distkeras_tpu_torch" / "csrc",
                           out_dir / "new", (SOURCE,))}
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7)
    cases = (*chip_smoke.KERNEL_TRAIN_CASES, chip_smoke.WIDE_CASE)
    all_ok, totals = True, {"ref": 0.0, "new": 0.0}
    for name, b, s, h, hkv, d, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            if fa._backward_variant(dtype, d) != "simt":
                continue
            dname = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(b, s, n, d, device="cuda",
                                       generator=gen).to(dtype)
                           for n in (h, hkv, hkv, h))
            out, lse = (t.contiguous() for t in fa.flash_attention_reference(
                q, k, v, causal, None, window, return_lse=True))
            runs = {n: pair(lib, q, k, v, out, lse, do, causal, window)
                    for n, lib in builds.items()}
            rq, rdelta = fa.flash_attention_bwd_dq_reference(
                q, k, v, out, lse, do, causal, None, window)
            rk, rv = fa.flash_attention_bwd_dkv_reference(
                q, k, v, lse, do, rdelta, causal, None, window)
            want = {"dq": rq, "dk": rk, "dv": rv}
            shares = {n: max(chip_smoke._err_share(r["out"][o], want[o],
                                                   dname)[1]
                             for o in want)
                      for n, r in runs.items()}
            del rq, rdelta, rk, rv, want
            times = {n: {"dq": [], "dkv": []} for n in runs}
            for n in ("ref", "new", "new", "ref"):
                for key in ("dq", "dkv"):
                    times[n][key] += timed(runs[n][key])
            ms = {n: {key: statistics.median(ts) for key, ts in t.items()}
                  for n, t in times.items()}
            for n in ms:
                totals[n] += ms[n]["dq"] + ms[n]["dkv"]
            ok = all(v <= 1.0 for v in shares.values())
            all_ok &= ok
            print(json.dumps({"case": name, "dtype": dname,
                              "shape_bshd": [b, s, h, d], "kv_heads": hkv,
                              "causal": causal, "window": window,
                              "ms": ms, "err_share_of_tol": shares,
                              "pair_speedup": (ms["ref"]["dq"]
                                               + ms["ref"]["dkv"])
                              / (ms["new"]["dq"] + ms["new"]["dkv"])}),
                  flush=True)
            del q, k, v, do, out, lse, runs
            torch.cuda.empty_cache()
    print(smi, flush=True)
    print(json.dumps({"all_within_tol": all_ok, "total_ms": totals,
                      "ref_csrc": str(args.ref_csrc)}), flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
