#!/usr/bin/env python3
"""The SIMT flash backward's error on a CUDA card, at the inputs on which its
CPU model is checked.

    python3 tools/simt_backward_share.py

``tests/test_torch_flash_bwd_split_tf32.py`` models the arithmetic of
``csrc/flash_attention_bwd.cu`` (split-TF32 ``mma.sync`` products) in torch
and holds the model's error against the error that the kernels show on the
card at the same inputs.  This script makes those inputs (:func:`inputs`:
unit normals from a numpy seed, out and lse from the port's plain forward in
f64), runs the port's dq and dk/dv wrappers on them on the card (the SIMT
variant at every case of ``CARD_CASES``), and prints one JSON line per case:
each output's largest error as a share of ``chip_smoke.py``'s per-element
tolerance (``TRAIN_TOL_ULP`` of the value + ``TRAIN_TOL_F32`` of the
largest value) against the plain version run in f64.  Then the card's name
and power limit.  It exits non-zero if an output misses the tolerance or a
case is not served by the SIMT variant.  Imports nothing of JAX.
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

# causal, window, kv heads (of H query heads)
CASES = {"causal_gqa": (True, None, 2), "window_gqa": (True, 24, 2),
         "full_mha": (False, None, 4)}
# 80 = 64 + 16: a ragged last tile in both kernels
S, H = 80, 4
CARD_CASES = ([(case, d, "float32") for case in sorted(CASES)
               for d in (16, 64, 200, 320)]
              + [("causal_gqa", d, dt) for d in (36, 200)
                 for dt in ("bfloat16", "float16")])
TRAIN_TOL_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7,
                 "float16": 2.0 ** -10}
TRAIN_TOL_F32 = 1e-4
OUTPUTS = ("dq", "dk", "dv")


def inputs(case: str, d: int, dname: str):
    """(q, k, v, dO, out, lse) on the CPU: (1, S, H, d) q and dO, (1, S,
    Hkv, d) k and v, unit normals from a numpy seed rounded to ``dname``;
    out (in ``dname``) and the f32 (1, H, S) lse of the port's plain
    forward run in f64 on them."""
    import torch
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    causal, window, hkv = CASES[case]
    dtype = getattr(torch, dname)
    rng = np.random.default_rng(d * 10 + hkv + (window or 0))
    q, do = (rng.standard_normal((1, S, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, S, hkv, d)).astype(np.float32)
            for _ in range(2))
    q, do, k, v = (torch.from_numpy(a).to(dtype) for a in (q, do, k, v))
    out, lse = fa.flash_attention_reference(
        q.double(), k.double(), v.double(), causal, None, window,
        return_lse=True)
    return q, k, v, do, out.to(dtype).contiguous(), lse.float().contiguous()


def plain(q, k, v, do, out, lse, case: str) -> dict:
    """The port's plain backward in f64 on those inputs, each output
    rounded to the inputs' dtype."""
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    causal, window, _ = CASES[case]
    f64 = [t.double() for t in (q, k, v, out, lse, do)]
    dq, dk, dv = fa.flash_attention_backward_reference(
        *f64, causal, None, window)
    return {"dq": dq.to(q.dtype), "dk": dk.to(q.dtype),
            "dv": dv.to(q.dtype)}


def share_of_tol(got, want, dname: str) -> float:
    """The largest |got - want| as a share of its element's tolerance."""
    g, w = got.double(), want.double()
    tol = TRAIN_TOL_ULP[dname] * w.abs() + TRAIN_TOL_F32 * w.abs().max()
    return ((g - w).abs() / tol).max().item()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("simt_backward_share: no CUDA device is available",
              file=sys.stderr)
        return 1
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    ok = True
    for case, d, dname in CARD_CASES:
        causal, window, _ = CASES[case]
        cpu = inputs(case, d, dname)
        want = plain(*cpu, case)
        q, k, v, do, out, lse = (t.cuda() for t in cpu)
        variant = fa._backward_variant(q.dtype, d)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal,
                                              None, window)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, causal,
                                            None, window)
        got = {"dq": dq.cpu(), "dk": dk.cpu(), "dv": dv.cpu()}
        shares = {n: share_of_tol(got[n], want[n], dname) for n in OUTPUTS}
        ok &= variant == "simt" and max(shares.values()) <= 1.0
        print(json.dumps({"case": case, "d": d, "dtype": dname,
                          "variant": variant, "share_of_tol": shares}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"all_within_tol": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
