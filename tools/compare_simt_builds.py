#!/usr/bin/env python3
"""Are two builds of the SIMT flash backward bit-identical, on a CUDA card?

    python3 tools/compare_simt_builds.py --ref-csrc OTHER/distkeras_tpu_torch/csrc

Compiles ``flash_attention_bwd.cu`` from ``--ref-csrc`` (for example the
csrc directory of an older checkout, unpacked with ``git archive``) and
from this checkout, with the flags of ``distkeras_tpu_torch/kernels.py``,
into ``build/compare_simt/``.  It then runs the dq and dk/dv entries of both
builds on the same random inputs (out and lse from the plain forward), at
head dims that the kernels pad (16 ... 128) and take in chunks (200, 320),
in f32, bf16 and f16, causal, windowed and not, and prints one JSON line per
case with whether dq, Delta, dk and dv are equal to the last bit.  It exits
non-zero if one is not.  This is the check for a change that must not move
the backward's arithmetic, such as moving its helpers into a header.
Imports nothing of JAX.

The SIMT forward (``flash_attention_fwd.cu``) is left out: since its
products moved to the TF32 tensor cores with split operands, a build from
before that design differs from it in the last bits by design.
``tools/time_simt_builds.py`` times two builds of either kernel instead and
holds each against the plain version.
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
SOURCES = ("flash_attention_bwd",)
# name, B, S, H, Hkv, D, causal, window
CASES = (("d16", 2, 300, 4, 2, 16, True, None),
         ("d32", 2, 1024, 8, 2, 32, True, None),
         ("d32_window", 2, 1024, 8, 2, 32, True, 100),
         ("d36", 2, 500, 4, 2, 36, True, None),
         ("d64_noncausal", 2, 512, 4, 4, 64, False, None),
         ("d96", 2, 512, 4, 1, 96, True, None),
         ("d128", 2, 512, 4, 2, 128, True, None),
         ("d200", 2, 1000, 8, 2, 200, True, None),
         ("d320", 1, 512, 4, 2, 320, True, None))


def build(csrc: Path, out_dir: Path, sources=SOURCES) -> dict:
    """Compile ``sources`` of ``csrc`` in parallel; name -> CDLL."""
    sys.path.insert(0, str(ROOT))
    from distkeras_tpu_torch import kernels
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources:
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


def tail_args(q, hkv: int, causal, window) -> tuple:
    """The C entries' arguments after the pointers: B, S, H, Hkv, D,
    dtype code, scale, causal, window, stream."""
    import torch
    b, s, h, d = q.shape
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    return (b, s, h, hkv, d, code, d ** -0.5, int(causal), window or 0,
            torch.cuda.current_stream().cuda_stream)


def launcher(fn, ptrs, tail):
    """A call of ``fn`` on these arguments that raises if the launch
    fails."""
    def launch():
        rc = fn(*ptrs, *tail)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return launch


def run(libs: dict, q, k, v, out, lse, do, causal, window) -> dict:
    """dq, Delta, dk and dv of the backward's two entries on these
    inputs."""
    import torch
    tail = tail_args(q, k.shape[2], causal, window)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    p = lambda *ts: [t.data_ptr() for t in ts]
    launcher(entry(libs, SOURCES[0], "flash_attention_bwd_dq", 8),
             p(q, k, v, out, do, lse, delta, dq), tail)()
    launcher(entry(libs, SOURCES[0], "flash_attention_bwd_dkv", 8),
             p(q, k, v, do, lse, delta, dk, dv), tail)()
    torch.cuda.synchronize()
    return {"dq": dq, "delta": delta, "dk": dk, "dv": dv}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ref-csrc", required=True, type=Path)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_simt_builds: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_attention_reference)
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
            out, lse = (t.contiguous() for t in flash_attention_reference(
                q, k, v, causal, None, window, return_lse=True))
            got_ref = run(ref, q, k, v, out, lse, do, causal, window)
            got_new = run(new, q, k, v, out, lse, do, causal, window)
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
