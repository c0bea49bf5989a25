#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``distkeras_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port only (no JAX is needed or imported) through four
phases, each printing one JSON line, and fails with a non-zero exit if
any phase fails:

1. device: the card's name and power limit, the torch and CUDA versions,
   and the build of every kernel from the checkout's sources (``nvcc``);
2. kernel: the flash-attention kernel against its plain PyTorch version
   on the card, at the serving slice's shapes and a few more (head dims
   that the kernel pads, f16), in f32 and bf16, with the error beside its
   per-element tolerance, and the kernel's, plain
   version's and ``scaled_dot_product_attention``'s times (a yardstick
   only: the port never calls it) beside the card's bound;
3. slice: ``ModelPredictor`` over a full-width ``transformer_lm`` (the
   widest LM the JAX package benchmarks: vocab 512, seq 2048, d_model 256,
   8 heads, 2 kv heads, 4 layers, mlp 1024) in its ``"full"`` and
   ``"rolling_window"`` forms, in bf16 (the slice's dtype) and f32, with
   random weights from a numpy seed loaded through ``load_jax_weights``;
   the kernel route is held against the plain route
   (``attention_impl="xla"``) and must have launched the kernel once per
   layer and batch;
4. blob: ``FittedModel.save`` → ``load`` → ``predict`` gives bit-identical
   logits.

Then it prints the kernel summary line, the ``nvidia-smi`` name and power
limit line, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
card, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
# the serving slice: scripts/bench_kernels.py's transformer_lm widths
LM = dict(vocab_size=512, seq_len=2048, d_model=256, num_heads=8,
          num_kv_heads=2, num_layers=4, mlp_dim=1024,
          compute_dtype="bfloat16")
FORMS = {"full": dict(),
         "rolling_window": dict(positional="rope", attention_window=256)}
ROWS, BATCH = 16, 8
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s, and
# flop/s by input type: bf16 on the tensor cores, f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# kernel vs plain version, per element: |kernel - plain| <= rel * |plain| +
# abs.  Both compute in f32 and differ only in the order of f32 sums (abs
# 2e-5 on unit-normal inputs); in bf16 and f16 each then rounds once to
# the output dtype, so they may differ by one ulp of it, at most 2**-7
# (bf16) or 2**-10 (f16) of the value, plus the f32 noise.
KERNEL_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 1e-5),
              "float16": (2.0 ** -10, 1e-5)}
# full-width slice, kernel route vs plain route (logits ~unit scale).  At
# f32 the two routes compute the same function and differ only in the
# order of f32 sums.  At bf16 the plain route rounds probabilities to bf16
# before P.V (the JAX XLA path's rule) where the kernel keeps them f32, and
# each route's bf16 rounding moves logits by up to ~0.05 against an f32
# model of the same weights (chip runs on this model), so at bf16 the
# argmax is compared where the plain route's top-2 margin exceeds twice
# that; the agreement over all positions is printed beside it.
LOGIT_TOL = {"bfloat16": 0.1, "float32": 1e-3}
ARGMAX_MARGIN = {"bfloat16": 0.1, "float32": 0.0}
ARGMAX_MIN = 0.99
# the raw bf16 agreement over all positions read 98.8-99.1% in probe runs
# (the plain bf16 route against an f32 model: 98.5-99.1%); a kernel that
# flipped near-ties more often than bf16 rounding does would fall below
ARGMAX_ALL_MIN = {"bfloat16": 0.98, "float32": 0.99}
# the main path: the slice's form and dtype
MAIN_PATH = ("full", "bfloat16")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, warmup: int, reps: int) -> float:
    """Median over ``reps`` CUDA-event timings of one call each."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def live_pairs(s: int, causal: bool, window) -> int:
    """Unmasked (q, k) pairs of one head."""
    if not causal:
        return s * s
    w = window or s
    return sum(min(p + 1, w) for p in range(s))


def phase_device():
    import torch
    from distkeras_tpu_torch import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    compiled = kernels.build()
    build_s = time.perf_counter() - t0
    # the plain reference path states its precision: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "kernels_compiled": compiled, "build_s": build_s})
    return smi


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from distkeras_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [  # name, B, S, H, Hkv, D, causal, window, dtypes
        ("causal", 8, 2048, 8, 2, 32, True, None, (f32, bf16, f16)),
        ("window256", 8, 2048, 8, 2, 32, True, 256, (f32, bf16)),
        ("noncausal", 8, 2048, 8, 2, 32, False, None, (f32, bf16)),
        ("d64", 8, 1024, 8, 2, 64, True, None, (f32, bf16)),
        ("d128", 8, 1024, 8, 2, 128, True, None, (f32, bf16)),
        ("ragged200", 8, 200, 8, 2, 32, True, None, (f32, bf16)),
        # head dims the kernel pads: 16 -> 32, 96 -> 128, 200 -> 256
        ("d16", 8, 1024, 8, 2, 16, True, None, (f32, bf16)),
        ("d96", 4, 1024, 8, 2, 96, True, 128, (bf16, f16)),
        ("d200", 2, 1000, 8, 2, 200, True, None, (f32, bf16)),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for name, b, s, h, hkv, d, causal, window, dtypes in cases:
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            q = torch.randn(b, s, h, d, device="cuda", generator=gen)
            k = torch.randn(b, s, hkv, d, device="cuda", generator=gen)
            v = torch.randn(b, s, hkv, d, device="cuda", generator=gen)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_reference(q, k, v, causal, None, window)
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            rel, atol = KERNEL_TOL[dname]
            # the largest error as a share of its own element's tolerance
            err_share = (diff / (rel * ref.float().abs() + atol)).max().item()

            kernel_ms = median_ms(lambda: flash_attention(
                q, k, v, causal=causal, window=window), 3, 20)
            plain_ms = median_ms(lambda: flash_attention_reference(
                q, k, v, causal, None, window), 2, 5)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            else:
                pos = torch.arange(s, device="cuda")
                keep = ((pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - window))
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep, enable_gqa=True)
            lib_out = sdpa().transpose(1, 2)
            library_ms = median_ms(sdpa, 3, 20)

            flops = 4 * b * h * d * live_pairs(s, causal, window)
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
            flop_ms = flops / PEAK_FLOPS[dname] * 1e3
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"phase": "kernel", "case": name, "dtype": dname,
                   "shape_bshd": [b, s, h, d], "kv_heads": hkv,
                   "causal": causal, "window": window,
                   "max_abs_err": err, "tol_rel": rel, "tol_abs": atol,
                   "err_share_of_tol": err_share,
                   "library_max_abs_err": (lib_out.float()
                                           - ref.float()).abs().max().item(),
                   "ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": max(flop_ms, byte_ms),
                   "bound_by": "operations" if flop_ms >= byte_ms
                   else "bytes"}
            emit(row)
            check(err_share <= 1.0, f"flash kernel {name}/{dname}: error "
                  f"{err_share:.3g}x its tolerance ({rel} * |plain| + "
                  f"{atol}; max abs err {err})")
            results[(name, dname)] = row
            del q, k, v, out, ref, diff, lib_out
    torch.cuda.empty_cache()
    return results


def _random_jax_weights(model, rng):
    """Weights in the JAX package's layout, from a numpy seed: kernels
    ~N(0, 1/fan_in), embedding tables ~N(0, 0.02²), LayerNorm scales
    ~1 + N(0, 0.1²), biases and offsets ~N(0, 0.02²)."""
    from distkeras_tpu_torch.core.model import jax_leaves
    out = []
    for path, p in jax_leaves(model):
        shape = tuple(p.shape)
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "embedding":
            w = 0.02 * rng.standard_normal(shape)
        elif len(shape) == 2:
            w = rng.standard_normal(shape) / (shape[0] ** 0.5)
        elif leaf == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            w = 0.02 * rng.standard_normal(shape)
        out.append(w.astype("float32"))
    return out


def _predict_route(extra, weights, data):
    """Build the LM, load ``weights``, warm up, then time one counted
    ``ModelPredictor.predict``; returns (fitted, logits, seconds,
    kernel launches during the counted run)."""
    from distkeras_tpu_torch import (FittedModel, ModelPredictor,
                                     load_jax_weights, transformer_lm)
    from distkeras_tpu_torch.ops.flash_attention import flash_attention
    model = transformer_lm(**{**LM, **extra})  # device=None: the card
    load_jax_weights(model, weights)
    fitted = FittedModel(model)
    predictor = ModelPredictor(fitted, batch_size=BATCH)
    predictor.predict(data)  # warm-up: cuBLAS handles, allocator
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits = predictor.predict(data)["prediction"]
    seconds = time.perf_counter() - t0
    return fitted, logits, seconds, flash_attention.launches


def phase_slice():
    import numpy as np
    import torch
    from distkeras_tpu_torch import Dataset, transformer_lm
    rng = np.random.default_rng(SEED)
    data = Dataset({"features": rng.integers(
        0, LM["vocab_size"], (ROWS, LM["seq_len"])).astype(np.int32)})
    batches = -(-ROWS // BATCH)
    want_launches = LM["num_layers"] * batches
    shape = (ROWS, LM["seq_len"], LM["vocab_size"])
    tokens = ROWS * LM["seq_len"]
    launches, kept = {}, {}
    for form, extra in FORMS.items():
        # one weight set per form, from the numpy seed, in the JAX layout
        weights = _random_jax_weights(
            transformer_lm(**LM, **extra, device="meta"), rng)
        for dtype in ("bfloat16", "float32"):
            kw = {**extra, "compute_dtype": dtype}
            fitted, logits, seconds, n_kernel = _predict_route(
                kw, weights, data)
            launches[f"{form}/{dtype}"] = n_kernel
            _, want, plain_seconds, n_plain = _predict_route(
                {**kw, "attention_impl": "xla"}, weights, data)
            torch.cuda.empty_cache()

            diff = float(np.abs(logits - want).max())
            same = logits.argmax(-1) == want.argmax(-1)
            top2 = np.sort(want, axis=-1)[..., -2:]
            decided = (top2[..., 1] - top2[..., 0]) > ARGMAX_MARGIN[dtype]
            agree = float(same[decided].mean())
            agree_all = float(same.mean())
            emit({"phase": "slice", "form": form, "compute_dtype": dtype,
                  "rows": ROWS, "batch_size": BATCH,
                  "logits_shape": list(logits.shape),
                  "finite": bool(np.isfinite(logits).all()),
                  "logit_abs_max": float(np.abs(want).max()),
                  "max_abs_diff_vs_plain": diff, "tol": LOGIT_TOL[dtype],
                  "argmax_agreement_all": agree_all,
                  "argmax_all_min": ARGMAX_ALL_MIN[dtype],
                  "argmax_margin": ARGMAX_MARGIN[dtype],
                  "decided_share": float(decided.mean()),
                  "argmax_agreement": agree, "argmax_min": ARGMAX_MIN,
                  "kernel_launches": n_kernel,
                  "expected_launches": want_launches,
                  "plain_route_launches": n_plain,
                  "tokens_per_s": tokens / seconds,
                  "ms_per_batch": seconds / batches * 1e3,
                  "plain_tokens_per_s": tokens / plain_seconds,
                  "plain_ms_per_batch": plain_seconds / batches * 1e3})
            tag = f"{form}/{dtype}"
            check(logits.shape == shape and want.shape == shape,
                  f"{tag}: logits shape {logits.shape}, want {shape}")
            check(bool(np.isfinite(logits).all()), f"{tag}: non-finite")
            check(diff <= LOGIT_TOL[dtype], f"{tag}: kernel vs plain route "
                  f"max abs diff {diff} > {LOGIT_TOL[dtype]}")
            check(agree >= ARGMAX_MIN, f"{tag}: argmax agreement {agree} < "
                                       f"{ARGMAX_MIN}")
            check(agree_all >= ARGMAX_ALL_MIN[dtype], f"{tag}: argmax "
                  f"agreement over all positions {agree_all} < "
                  f"{ARGMAX_ALL_MIN[dtype]}")
            check(n_kernel == want_launches, f"{tag}: {n_kernel} kernel "
                  f"launches, want {want_launches}")
            check(n_plain == 0, f"{tag}: the plain route launched the "
                                f"kernel {n_plain} times")
            if dtype == LM["compute_dtype"]:
                kept[form] = (fitted, data, logits)
    return launches, kept


def phase_blob(fitted, data, logits):
    import numpy as np
    from distkeras_tpu_torch import FittedModel
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "transformer_lm_full.npz")
    fitted.save(path)
    loaded = FittedModel.load(path)  # device=None: the card
    again = loaded.predict(data["features"], batch_size=BATCH)
    same = bool(np.array_equal(again, logits))
    emit({"phase": "blob", "path": os.path.relpath(path),
          "bytes": os.path.getsize(path), "bit_identical": same})
    check(same, "blob round trip changed the logits")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distkeras_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    kernel_rows = phase_kernel()
    launches, kept = phase_slice()
    phase_blob(*kept["full"])

    main_row = kernel_rows[("causal", "bfloat16")]  # the slice's shape
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "distkeras_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "distkeras_tpu/ops/flash_attention.py:78",
        # the main path's counted run; every counted run beside it
        "launches": launches["/".join(MAIN_PATH)],
        "launches_by_path": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
