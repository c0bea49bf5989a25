#!/usr/bin/env python3
"""The SIMT flash forward's error on a CUDA card, at the inputs on which its
CPU model is checked.

    python3 tools/simt_forward_share.py

``tests/test_torch_flash_fwd_split_tf32.py`` models the arithmetic of
``csrc/flash_attention_fwd.cu`` (split-TF32 ``mma.sync`` products) in torch
and holds the model's error against the error that the kernel shows on the
card at the same inputs.  This script makes those inputs (:func:`inputs`:
unit normals from a numpy seed, the cases of ``simt_backward_share.py``),
runs the port's forward wrappers on them on the card (the SIMT variant at
every case of ``CARD_CASES``: the inference form and the form with lse),
and prints one JSON line per case: the output's largest error as a share of
``chip_smoke.py``'s per-element ``KERNEL_TOL`` and the lse's as a share of
phase kernel_train's band (``TRAIN_TOL_F32`` of the largest value), each
against the plain version run in f64.  Then the card's name and power
limit.  It exits non-zero if an output misses its tolerance, the two forms'
outputs differ, or a case is not served by the SIMT variant.  Imports
nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from simt_backward_share import CASES, H, S  # noqa: E402  (no JAX)

CARD_CASES = ([(case, d, "float32") for case in sorted(CASES)
               for d in (16, 36, 64, 200, 320)]
              + [("causal_gqa", d, dt) for d in (36, 320)
                 for dt in ("bfloat16", "float16")])
# chip_smoke.py's KERNEL_TOL: |got - want| <= rel * |want| + abs
KERNEL_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 1e-5),
              "float16": (2.0 ** -10, 1e-5)}
TRAIN_TOL_F32 = 1e-4


def inputs(case: str, d: int, dname: str):
    """(q, k, v) on the CPU: (1, S, H, d) q and (1, S, Hkv, d) k and v,
    unit normals from a numpy seed rounded to ``dname``."""
    import torch
    _, window, hkv = CASES[case]
    rng = np.random.default_rng(d * 10 + hkv + (window or 0) + 7)
    q = rng.standard_normal((1, S, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, hkv, d)).astype(np.float32)
            for _ in range(2))
    dtype = getattr(torch, dname)
    return tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v))


def plain(q, k, v, case: str):
    """The port's plain forward in f64 on those inputs: (out rounded to the
    inputs' dtype, lse in f64)."""
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    causal, window, _ = CASES[case]
    out, lse = fa.flash_attention_reference(
        q.double(), k.double(), v.double(), causal, None, window,
        return_lse=True)
    return out.to(q.dtype), lse


def out_share(got, want, dname: str) -> float:
    """The largest |got - want| as a share of its element's KERNEL_TOL."""
    rel, atol = KERNEL_TOL[dname]
    g, w = got.double(), want.double()
    return ((g - w).abs() / (rel * w.abs() + atol)).max().item()


def lse_share(got, want) -> float:
    """The largest |got - want| as a share of TRAIN_TOL_F32 of max|want|."""
    g, w = got.double(), want.double()
    return ((g - w).abs().max() / (TRAIN_TOL_F32 * w.abs().max())).item()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("simt_forward_share: no CUDA device is available",
              file=sys.stderr)
        return 1
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    ok = True
    for case, d, dname in CARD_CASES:
        causal, window, _ = CASES[case]
        cpu = inputs(case, d, dname)
        want, want_lse = plain(*cpu, case)
        q, k, v = (t.cuda() for t in cpu)
        variant = fa._forward_variant(q.dtype, d)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        out_lse, lse = fa.flash_attention_forward(q, k, v, causal, None,
                                                  window)
        shares = {"out": out_share(out.cpu(), want, dname),
                  "lse": lse_share(lse.cpu(), want_lse)}
        same = torch.equal(out, out_lse)
        ok &= variant == "simt" and same and max(shares.values()) <= 1.0
        print(json.dumps({"case": case, "d": d, "dtype": dname,
                          "variant": variant, "forms_equal": same,
                          "share_of_tol": shares}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"all_within_tol": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
