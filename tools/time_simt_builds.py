#!/usr/bin/env python3
"""Time two builds of the SIMT flash kernels against each other on a card.

    python3 tools/time_simt_builds.py --ref-csrc OTHER/distkeras_tpu_torch/csrc
        [--kernels fwd,bwd]

Compiles ``flash_attention_fwd.cu`` and ``flash_attention_bwd.cu`` from
``--ref-csrc`` (for example the csrc directory of an older checkout,
unpacked with ``git archive``) and from this checkout, with the flags of
``distkeras_tpu_torch/kernels.py``, into ``build/time_simt_builds/``.

- The forward (``fwd``): at every case of ``chip_smoke.py``'s phases
  kernel_train and wide and its odd head dim (``ODD_CASE``), in every dtype
  that the SIMT variant serves there (``_forward_variant``), it runs both
  forms of both builds on the same random inputs, holds each build's
  output against the plain version under ``chip_smoke.py``'s ``KERNEL_TOL``
  and its lse under phase kernel_train's band (``TRAIN_TOL_F32`` of the
  largest value), and times the inference form (``fwd``) and the form with
  lse (``fwd_lse``).
- The backward (``bwd``): at every case of phases kernel_train and wide in
  every dtype that the SIMT variant serves there (``_backward_variant``), it
  runs the dq and dk/dv entries of both builds (lse from the plain
  forward), holds dq, dk and dv against the plain version under
  ``chip_smoke.py``'s per-element rule (``TRAIN_TOL_ULP`` + ``TRAIN_TOL_F32``
  of the largest value), and times each entry.

Each entry is timed through its C function alone (no Python wrapper:
CUDA-event medians, in the order ref, new, new, ref).  It prints one JSON
line per kernel and case, the card's name and power limit, and a summary;
it exits non-zero if either build misses a tolerance.  Imports nothing of
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
from compare_simt_builds import build, entry, launcher, tail_args  # noqa: E402

SOURCES = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd"}
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


def forward(libs: dict, q, k, v, causal, window) -> dict:
    """The build's forward entry on these inputs in both forms: their
    outputs and a launcher of each."""
    import torch
    tail = tail_args(q, k.shape[2], causal, window)
    b, s, h, _ = q.shape
    out_inf, out = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    fn = entry(libs, SOURCES["fwd"], "flash_attention_fwd", 5)
    runs = {"fwd": launcher(fn, [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out_inf.data_ptr(), None], tail),
            "fwd_lse": launcher(fn, [q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr(),
                                     lse.data_ptr()], tail)}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    return {"out": {"out_inference": out_inf, "out": out, "lse": lse},
            **runs}


def backward(libs: dict, q, k, v, out, lse, do, causal, window) -> dict:
    """The build's dq and dk/dv entries on these inputs: their outputs and
    a launcher of each."""
    import torch
    tail = tail_args(q, k.shape[2], causal, window)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    p = lambda *ts: [t.data_ptr() for t in ts]
    runs = {"dq": launcher(entry(libs, SOURCES["bwd"],
                                 "flash_attention_bwd_dq", 8),
                           p(q, k, v, out, do, lse, delta, dq), tail),
            "dkv": launcher(entry(libs, SOURCES["bwd"],
                                  "flash_attention_bwd_dkv", 8),
                            p(q, k, v, do, lse, delta, dk, dv), tail)}
    runs["dq"]()
    runs["dkv"]()
    torch.cuda.synchronize()
    return {"out": {"dq": dq, "dk": dk, "dv": dv, "delta": delta}, **runs}


def kernel_share(got, want, dname: str) -> float:
    """The largest error as a share of its element's KERNEL_TOL."""
    rel, atol = chip_smoke.KERNEL_TOL[dname]
    g, w = got.float(), want.float()
    return ((g - w).abs() / (rel * w.abs() + atol)).max().item()


def in_turns(runs: dict, keys) -> dict:
    """Median ms of each build's entries, timed in the order ref, new, new,
    ref."""
    times = {n: {key: [] for key in keys} for n in runs}
    for n in ("ref", "new", "new", "ref"):
        for key in keys:
            times[n][key] += timed(runs[n][key])
    return {n: {key: statistics.median(ts) for key, ts in t.items()}
            for n, t in times.items()}


def forward_case(fa, builds, gen, case, dtype) -> dict:
    import torch
    name, b, s, h, hkv, d, causal, window = case
    dname = str(dtype).split(".")[-1]
    q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=gen
                           ).to(dtype) for n in (h, hkv, hkv))
    want, want_lse = fa.flash_attention_reference(q, k, v, causal, None,
                                                  window, return_lse=True)
    runs = {n: forward(lib, q, k, v, causal, window)
            for n, lib in builds.items()}
    shares = {n: {"out": max(kernel_share(r["out"][o], want, dname)
                             for o in ("out_inference", "out")),
                  "lse": chip_smoke._err_share(r["out"]["lse"], want_lse,
                                               "float32")[1]}
              for n, r in runs.items()}
    del want, want_lse
    ms = in_turns(runs, ("fwd", "fwd_lse"))
    return {"kernel": "fwd", "case": name, "dtype": dname,
            "shape_bshd": [b, s, h, d], "kv_heads": hkv, "causal": causal,
            "window": window, "ms": ms, "err_share_of_tol": shares,
            "speedup": {key: ms["ref"][key] / ms["new"][key]
                        for key in ("fwd", "fwd_lse")}}


def backward_case(fa, builds, gen, case, dtype) -> dict:
    import torch
    name, b, s, h, hkv, d, causal, window = case
    dname = str(dtype).split(".")[-1]
    q, k, v, do = (torch.randn(b, s, n, d, device="cuda", generator=gen
                               ).to(dtype) for n in (h, hkv, hkv, h))
    out, lse = (t.contiguous() for t in fa.flash_attention_reference(
        q, k, v, causal, None, window, return_lse=True))
    runs = {n: backward(lib, q, k, v, out, lse, do, causal, window)
            for n, lib in builds.items()}
    rq, rdelta = fa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, do, causal, None, window)
    rk, rv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, lse, do, rdelta, causal, None, window)
    want = {"dq": rq, "dk": rk, "dv": rv}
    shares = {n: max(chip_smoke._err_share(r["out"][o], want[o], dname)[1]
                     for o in want)
              for n, r in runs.items()}
    del rq, rdelta, rk, rv, want
    ms = in_turns(runs, ("dq", "dkv"))
    return {"kernel": "bwd", "case": name, "dtype": dname,
            "shape_bshd": [b, s, h, d], "kv_heads": hkv, "causal": causal,
            "window": window, "ms": ms, "err_share_of_tol": shares,
            "pair_speedup": (ms["ref"]["dq"] + ms["ref"]["dkv"])
            / (ms["new"]["dq"] + ms["new"]["dkv"])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ref-csrc", required=True, type=Path)
    parser.add_argument("--kernels", default="fwd,bwd",
                        help="comma-separated: fwd, bwd")
    args = parser.parse_args()
    which = args.kernels.split(",")
    if not set(which) <= set(SOURCES):
        parser.error(f"--kernels takes {sorted(SOURCES)}")
    import torch
    if not torch.cuda.is_available():
        print("time_simt_builds: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "time_simt_builds"
    sources = tuple(SOURCES[w] for w in which)
    builds = {"ref": build(args.ref_csrc.resolve(), out_dir / "ref",
                           sources),
              "new": build(ROOT / "distkeras_tpu_torch" / "csrc",
                           out_dir / "new", sources)}
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 7)
    cases = (*chip_smoke.KERNEL_TRAIN_CASES, chip_smoke.WIDE_CASE)
    plans = {"fwd": ((*cases, chip_smoke.ODD_CASE), fa._forward_variant,
                     forward_case),
             "bwd": (cases, fa._backward_variant, backward_case)}
    all_ok = True
    totals = {w: {"ref": 0.0, "new": 0.0} for w in which}
    for w in which:
        kernel_cases, variant, run_case = plans[w]
        for case in kernel_cases:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                if variant(dtype, case[5]) != "simt":
                    continue
                row = run_case(fa, builds, gen, case, dtype)
                for n, ms in row["ms"].items():
                    totals[w][n] += sum(ms.values())
                shares = row["err_share_of_tol"]
                all_ok &= all(max(s.values()) <= 1.0 if isinstance(s, dict)
                              else s <= 1.0 for s in shares.values())
                print(json.dumps(row), flush=True)
                torch.cuda.empty_cache()
    print(smi, flush=True)
    print(json.dumps({"all_within_tol": all_ok, "total_ms": totals,
                      "ref_csrc": str(args.ref_csrc)}), flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
