#!/usr/bin/env python3
"""Are two builds of the SIMT flash kernels bit-identical, on a CUDA card?

    python3 tools/compare_simt_builds.py --ref-csrc OTHER/distkeras_tpu_torch/csrc

Compiles ``flash_attention_fwd.cu`` and ``flash_attention_bwd.cu`` from
``--ref-csrc`` (for example the csrc directory of an older checkout,
unpacked with ``git archive``) and from this checkout, with the flags of
``distkeras_tpu_torch/kernels.py``, into ``build/compare_simt/``.  It then
runs the forward (inference form and the form with lse) and the backward
(dq, then dk/dv) of both builds on the same random inputs, at head dims
that the kernels pad (16 ... 256), in f32, bf16 and f16, causal, windowed
and not, and prints one JSON line per case with whether every output is
equal to the last bit.  It exits non-zero if one is not.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
# name, B, S, H, Hkv, D, causal, window
CASES = (("d16", 2, 300, 4, 2, 16, True, None),
         ("d32", 2, 1024, 8, 2, 32, True, None),
         ("d32_window", 2, 1024, 8, 2, 32, True, 100),
         ("d64_noncausal", 2, 512, 4, 4, 64, False, None),
         ("d96", 2, 512, 4, 1, 96, True, None),
         ("d128", 2, 512, 4, 2, 128, True, None),
         ("d200", 2, 1000, 8, 2, 200, True, None),
         ("d256", 1, 512, 4, 2, 256, True, None))


def build(csrc: Path, out_dir: Path) -> dict:
    """Compile both sources of ``csrc`` in parallel; name -> CDLL."""
    sys.path.insert(0, str(ROOT))
    from distkeras_tpu_torch import kernels
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        lib = out_dir / f"lib{name}.so"
        cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
               str(csrc / f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def entry(libs: dict, lib: str, name: str, n_ptrs: int):
    fn = getattr(libs[lib], name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run(libs: dict, q, k, v, do, causal, window) -> dict:
    """Every output of both kernels' entries on these inputs."""
    import torch
    b, s, h, d = q.shape
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    tail = (b, s, h, k.shape[2], d, code, d ** -0.5, int(causal),
            window or 0, torch.cuda.current_stream().cuda_stream)
    out_inf, out = torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    p = lambda *ts: [None if t is None else t.data_ptr() for t in ts]
    calls = (
        (entry(libs, "flash_attention_fwd", "flash_attention_fwd", 5),
         p(q, k, v, out_inf, None)),
        (entry(libs, "flash_attention_fwd", "flash_attention_fwd", 5),
         p(q, k, v, out, lse)),
        (entry(libs, "flash_attention_bwd", "flash_attention_bwd_dq", 8),
         p(q, k, v, out, do, lse, delta, dq)),
        (entry(libs, "flash_attention_bwd", "flash_attention_bwd_dkv", 8),
         p(q, k, v, do, lse, delta, dk, dv)))
    for fn, ptrs in calls:
        rc = fn(*ptrs, *tail)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    return {"out_inference": out_inf, "out": out, "lse": lse,
            "delta": delta, "dq": dq, "dk": dk, "dv": dv}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ref-csrc", required=True, type=Path)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_simt_builds: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "compare_simt"
    ref = build(args.ref_csrc.resolve(), out_dir / "ref")
    new = build(ROOT / "distkeras_tpu_torch" / "csrc", out_dir / "new")
    gen = torch.Generator(device="cuda").manual_seed(0)
    all_equal = True
    for name, b, s, h, hkv, d, causal, window in CASES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, do = (torch.randn(b, s, n, d, device="cuda",
                                       generator=gen).to(dtype)
                           for n in (h, hkv, hkv, h))
            got_ref = run(ref, q, k, v, do, causal, window)
            got_new = run(new, q, k, v, do, causal, window)
            equal = {n: torch.equal(got_ref[n], got_new[n])
                     for n in got_ref}
            all_equal &= all(equal.values())
            print(json.dumps({"case": name, "dtype": str(dtype)[6:],
                              "shape_bshd": [b, s, h, d], "kv_heads": hkv,
                              "bit_identical": equal}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"all_bit_identical": all_equal,
                      "ref_csrc": os.fspath(args.ref_csrc)}), flush=True)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
