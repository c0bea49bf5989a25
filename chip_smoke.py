#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``distkeras_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port only (no JAX is needed or imported) through thirteen
phases, each printing JSON lines, and fails with a non-zero exit if any
phase fails:

1. device: the card's name, power limit, SM count and maximum SM clock
   (for the exponential rate of the bounds), the torch and CUDA versions,
   and the build of every kernel from the checkout's sources (``nvcc``);
2. kernel: the flash-attention forward against its plain PyTorch version
   on the card, at the serving slice's shapes and a few more (head dims
   that the kernels pad, the parallel LM's Ulysses shape: B 8, S 2048,
   8 heads, MHA, D 64), in f32, bf16 and f16 (each served by the variant
   its dtype and head dim select: sm90 for 16-bit, SIMT for f32), with
   the error beside its per-element tolerance, and the kernel's, plain
   version's and ``scaled_dot_product_attention``'s times (a yardstick
   only: the port never calls it) beside the card's bound (bytes,
   products or one exponential per live pair, whichever is largest); at
   the slice's and the Ulysses shape in bf16 the SIMT kernel is timed too,
   through the private launcher, so the two variants are compared on one
   card;
3. slice: ``ModelPredictor`` over a full-width ``transformer_lm`` (the
   widest LM the JAX package benchmarks: vocab 512, seq 2048, d_model 256,
   8 heads, 2 kv heads, 4 layers, mlp 1024) in its ``"full"`` and
   ``"rolling_window"`` forms, in bf16 (the slice's dtype) and f32, with
   random weights from a numpy seed loaded through ``load_jax_weights``;
   the kernel route is held against the plain route
   (``attention_impl="xla"``) and must have launched the kernel once per
   layer and batch, every bf16 launch on the sm90 variant and every f32
   one on the SIMT variant;
4. blob: ``FittedModel.save`` → ``load`` → ``predict`` gives bit-identical
   logits;
5. kernel_train: the training form of the forward (out and lse) and the
   two backward kernels (dq, dk/dv) against their plain versions on the
   card, at phase 2's shapes in f32, bf16 and f16 with a random dO (the
   backward on the variant its dtype and head dim select: sm90 for
   16-bit head dims up to 128, SIMT for f32 and wider heads; every sm90
   pair run twice on the same inputs and bit-identical), with each error
   beside its per-element tolerance, and the kernels', plain versions'
   and ``scaled_dot_product_attention`` backward's times (a yardstick
   only, under each SDPA backend that takes the case, the least kept)
   beside the card's bound; at the slice's and the Ulysses shape in bf16
   the SIMT forward and the SIMT backward pair are timed too, as in
   phase 2;
6. memory: forward and backward (the sm90 kernels) at S 8192 allocate
   nothing of size S²;
7. train: ``SingleTrainer`` trains the full-width LM (both forms, bf16
   and f32) on the x+1 next-token task, 16 steps, on the kernel route
   and on the plain route (``attention_impl="xla"``) from the same
   weights: the kernel route must have launched the training forward,
   dq and dk/dv once per layer and step (each on the variant of the
   dtype: sm90 at bf16, SIMT at f32) and the plain route never, the
   routes must agree (first-step gradients and loss traces at f32, loss
   traces within a measured band at bf16), the loss must fall, and
   ``ModelPredictor`` must serve the trained model through the
   inference kernel;
8. kernel_ce: the fused cross-entropy kernels (forward, backward) against
   their plain versions at the parallel LM's (16384, 32768) in f32 and
   bf16, ragged (300, 1000), GPT-2's vocab (4096, 50257), (8, 16) in
   f16, +-1e4 logits, out-of-range labels and misaligned rows, each
   error beside its tolerance, and the kernels', plain versions' and
   ``cross_entropy``'s times (a yardstick only) beside the bytes bound;
9. memory_ce: loss forward + backward at (16384, 32768) f32 holds one
   (T, V) tensor above the logits on the fused route (the gradient) and
   at least one more on the plain route;
10. parallel_train: the full-width ``ParallelTransformerLM`` of
    ``scripts/bench_transformer.py`` (vocab 32768, d_model 512, 8 heads,
    8 layers, mlp 2048, RoPE, bf16, batch 8 x 2048, adam 1e-3) from one
    numpy-seeded weight set through ``load_jax_params``, 8 steps each on
    the fused-CE ring, plain-CE ring and fused-CE Ulysses routes: the
    fused CE kernels launch once per step on the fused routes and never
    on the plain one, the flash kernels once per layer and step on the
    Ulysses route (forward, dq and dk/dv on sm90 at bf16, on SIMT at f32)
    and never on the ring, the loss falls on every route,
    the routes agree within measured bf16 bands, and at f32 (2 layers)
    fused and plain CE agree in loss traces (1e-5) and first-step
    gradients, and so do Ulysses and ring (loss traces 1e-4);
11. wide: a head dim above 256 (B 2, S 1024, H 4, Hkv 2, D 320, causal,
    f32 and bf16) through ``attention`` forward, backward and inference
    form, every launch on the SIMT kernels (their 256-column chunks),
    each kernel against its plain version under phases 2 and 5's rules,
    with the kernels', plain versions' and SDPA's times beside the bound;
12. views: q, k, v as ``chunk(3, dim=2)`` of one bf16 projection at the
    serving slice's widths, as contiguous views off a 16-byte boundary,
    and (T, V) logits that are a transpose, through ``attention`` and
    ``fused_softmax_cross_entropy`` forward and backward: the kernels
    launch, the results equal the same calls on contiguous copies to the
    bit, the gradients come in the views' shapes, and the plain versions
    agree under phases 5 and 8's rules;
13. zoo: the MNIST flow (MinMax → OneHot → ``SingleTrainer`` →
    ``ModelPredictor`` → LabelIndex → Accuracy) with ``mnist_convnet`` in
    bf16 on 60000 rows, batch 512, adam 1e-3, 2 epochs: accuracy >= 0.8
    on 10000 test rows, the epoch loss falls, examples/s and predict
    rows/s on the host clock; the trained model's blob round trip
    bit-identical; bf16 against f32 from the same weights on the first
    batch within measured bands; the CIFAR-10 ConvNet and the Higgs MLP
    for an epoch (the loss falls); one step of the digits models and of
    a batch-norm stack (finite, the running statistics move); and no
    attention or cross-entropy kernel launched on any of it.

Then it prints the kernel summary line (each variant of each flash
kernel with its source and the runs it served, and the SIMT kernels at
the wide head dim), the ``nvidia-smi`` name
and power limit line, and last ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout, it exits non-zero and prints
no result.
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
# the flash kernels' third term: one exponential per live (q, k) pair on
# the MUFU units, 16 ex2 per clock per SM; phase_device sets the rate from
# the card's SM count and the SM clock that nvidia-smi reports as its
# maximum (clocks.max.sm)
EX2_PER_CLOCK_PER_SM = 16
EXP_PER_S = None
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
# the training kernels vs their plain versions, per element: |kernel -
# plain| <= ulp * |plain| + 1e-4 * max|plain|.  Both compute in f32; the
# backward's sums run S long with cancellation in dp - Delta, so the f32
# term is relative to the tensor's largest value; bf16 and f16 outputs
# may then round one ulp apart (2**-7 and 2**-10 of the value).
TRAIN_TOL_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7,
                 "float16": 2.0 ** -10}
TRAIN_TOL_F32 = 1e-4
# the training slice: the x+1 next-token task of tests/test_attention.py
# at full width, SingleTrainer with adam 3e-3, 64 rows in batches of 8,
# 2 epochs (16 steps), from the same numpy-seeded weights on both routes
TRAIN_ROWS, TRAIN_EPOCHS = 64, 2
TRAINER = dict(loss="sparse_categorical_crossentropy_from_logits",
               worker_optimizer="adam", learning_rate=3e-3,
               batch_size=BATCH, num_epoch=TRAIN_EPOCHS)
# kernel route vs plain route.  f32: first-step gradients per parameter
# tensor, |g_kernel - g_plain| <= GRAD_RTOL * max|g_plain| over the tensor
# + GRAD_ATOL * the largest |g_plain| of any tensor (the second term
# covers tensors whose true gradient is 0, e.g. a key bias without RoPE,
# where both routes hold only f32 rounding), and the loss traces to
# LOSS_RTOL_F32 (relative).  The routes differ only in the order of f32
# sums: probe runs on the H100 read gradient differences of ~1e-6 of
# each tensor's max and loss traces within 8e-6.  bf16: the plain route
# rounds probabilities to bf16 before P.V (the JAX XLA path's rule) where
# the kernels keep f32, so the traces drift apart over 16 steps; probe
# runs read 8.9e-4 (full) and 3.1e-3 (rolling_window), and the band is
# LOSS_BAND_BF16.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL_F32 = 1e-4
LOSS_BAND_BF16 = 0.02
# the last loss of the 16 steps below this share of the first (probe
# runs: 0.22 full, 0.056 rolling_window, on both routes and dtypes)
LOSS_DROP = 0.5
# the fused cross-entropy kernels vs their plain versions, per element:
# loss and lse within CE_TOL_REL * |plain| + CE_TOL_ABS (the JAX test's
# rtol/atol, tests/test_fused_ce.py:36-38: both sum in f32, in other
# orders); dlogits within one ulp of the dtype (0 at f32) * |plain| +
# CE_GRAD_F32 * max|plain| (both compute in f32 and round once)
CE_TOL_REL, CE_TOL_ABS = 1e-5, 1e-5
CE_GRAD_F32 = 1e-6
# f32 operations per logit (max, subtract, exp, add in the forward; the
# backward's subtract, exp, compare, subtract, multiply) against the f32
# CUDA-core peak, for the bound beside the bytes
CE_OPS = {"fwd": 4, "bwd": 5}
# the parallel-LM slice: scripts/bench_transformer.py:101-104, the JAX
# package's single-chip ParallelTransformerLM configuration, at batch 8 x
# seq 2048 (the first cell of its sweep, :96-99, that reaches seq 2048),
# optax.adam(1e-3), random tokens, labels (tokens + 1) % V
PLM = dict(vocab_size=32768, seq_len=2048, d_model=512, num_heads=8,
           num_layers=8, mlp_dim=2048, positional="rope")
PLM_BATCH, PLM_STEPS, PLM_LR = 8, 8, 1e-3
PLM_ROUTES = {"fused_ring": dict(fused_ce=True),
              "plain_ring": dict(fused_ce=False),
              "fused_ulysses": dict(fused_ce=True, sp_impl="ulysses")}
# the flash kernels' shape on the Ulysses route: name, B, S, H, Hkv, D,
# causal, window
PLM_ULYSSES_CASE = ("plm_ulysses", PLM_BATCH, PLM["seq_len"],
                    PLM["num_heads"], PLM["num_heads"],
                    PLM["d_model"] // PLM["num_heads"], True, None)
# the f32 routes at cut depth: fused vs plain CE against the JAX
# package's own rtol for fused vs XLA CE (tests/test_fused_ce.py:116);
# Ulysses vs ring (flash kernels vs the ring's own f32 online softmax)
# by the training slice's rule for kernel vs plain attention at f32,
# LOSS_RTOL_F32 and GRAD_RTOL/GRAD_ATOL
PLM_F32_LAYERS = 2
PLM_LOSS_RTOL_F32 = 1e-5
# bf16 loss traces over the 8 steps, relative; the traces are the same
# to the last bit from one chip run to the next.  The fused and plain CE
# routes read the same f32 logits and their gradients differ only in f32
# rounding, but the backward then rounds through bf16 activations and 8
# Adam steps carry the odd flipped ulp forward: chip runs read 1.3e-4,
# and the band is PLM_CE_BAND_BF16.  The Ulysses route attends through
# the flash kernels where the ring runs its own f32 online softmax, each
# rounding its output to bf16 at other points: chip runs read 4.2e-3,
# against PLM_SCHEDULE_BAND_BF16.  These bands catch a gross fault only;
# the flash kernels are held per element at the route's shape (phases 2
# and 5) and the schedules' f32 gradients against each other.
PLM_CE_BAND_BF16 = 1e-3
PLM_SCHEDULE_BAND_BF16 = 0.01
# the cases at which phases kernel and kernel_train also time the SIMT
# kernels (the forward; the backward pair in kernel_train) on bf16 inputs,
# beside the sm90 kernels that serve them: the serving and training
# slices' shape, and the Ulysses route's
SIMT_TIMED = ("causal", PLM_ULYSSES_CASE[0])
# the SDPA backends under which phase kernel_train times the yardstick
# backward (those that refuse a case are left out of it)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
# a head dim above 256 (the reference's kernel takes any): the SIMT kernels
# take it in ceil(320 / 256) = 2 chunks of 256 columns.  name, B, S, H,
# Hkv, D, causal, window
WIDE_CASE = ("d320", 2, 1024, 4, 2, 320, True, None)
# strided and misaligned views at the public entry points: q, k, v as
# chunks of one (B, S, 3H, D) projection at the serving slice's widths
# (MHA: a chunk of three equal parts), q, k, v each a contiguous view one
# element off a 16-byte boundary, and (T, V) logits that are the transpose
# of a (V, T) tensor.  name, B, S, H, Hkv, D (attention); name, T, V (CE)
VIEW_QKV_CASE = ("qkv_chunk", BATCH, LM["seq_len"], LM["num_heads"],
                 LM["num_heads"], LM["d_model"] // LM["num_heads"])
VIEW_MISALIGNED_CASE = ("misaligned", 2, 1024, 8, 2, 32)
VIEW_CE_CASE = ("transposed_logits", 4096, 32768)
# the ConvNet slice: the MNIST flow of the verify recipe (MinMax → OneHot
# → SingleTrainer → ModelPredictor → LabelIndex → Accuracy) at the
# north-star configuration's full size: mnist_convnet in bf16, the 60000
# rows and 10000 test rows of MNIST (load_mnist's synthetic stand-in
# where no mnist.npz is found), batch 512 (bench.py's on-chip batch,
# bench.py:1109-1110), adam 1e-3, 2 epochs.  Pass mark: the recipe's 0.8
ZOO_ROWS, ZOO_TEST_ROWS, ZOO_BATCH, ZOO_EPOCHS = 60000, 10000, 512, 2
ZOO_TRAINER = dict(batch_size=ZOO_BATCH, worker_optimizer="adam",
                   learning_rate=1e-3, label_col="label_encoded",
                   loss="categorical_crossentropy")
ZOO_ACCURACY_MIN = 0.8
# bf16 vs f32 from the same weights on the first batch of 512: the loss
# relative and each parameter's gradient against its largest f32 value.
# The bf16 model rounds every conv and Dense operand and runs the conv
# backward in bf16 (the JAX _conv_f32_acc contract); the same computation
# on the CPU read a loss gap of 1.3e-4 to 7.0e-4 and gradient gaps of 0.4%
# to 3.1% of each tensor's largest value over three weight seeds
ZOO_BF16_LOSS_BAND, ZOO_BF16_GRAD_BAND = 5e-3, 0.1
# the other zoo models: one epoch on this many synthetic rows, batch 128
ZOO_SMALL_ROWS, ZOO_SMALL_BATCH = 4096, 128


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
    global EXP_PER_S
    import torch
    from distkeras_tpu_torch import kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    EXP_PER_S = EX2_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6
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
          "sm_count": sms, "sm_clock_max_mhz": sm_mhz,
          "exp2_per_s": EXP_PER_S,
          "kernels_compiled": compiled, "build_s": build_s})
    return smi


def phase_kernel():
    import importlib
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    flash_attention = fa.flash_attention
    flash_attention_reference = fa.flash_attention_reference
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    every = (f32, bf16, f16)
    cases = [  # name, B, S, H, Hkv, D, causal, window, dtypes
        ("causal", 8, 2048, 8, 2, 32, True, None, every),
        ("window256", 8, 2048, 8, 2, 32, True, 256, every),
        ("noncausal", 8, 2048, 8, 2, 32, False, None, every),
        ("d64", 8, 1024, 8, 2, 64, True, None, every),
        ("d128", 8, 1024, 8, 2, 128, True, None, every),
        ("ragged200", 8, 200, 8, 2, 32, True, None, every),
        # head dims the kernels pad: 16 -> 32, 96 -> 128, 200 -> 256
        ("d16", 8, 1024, 8, 2, 16, True, None, every),
        ("d96", 4, 1024, 8, 2, 96, True, 128, (bf16, f16)),
        ("d200", 2, 1000, 8, 2, 200, True, None, every),
        # the parallel LM's attention on its Ulysses route (MHA, D 64)
        PLM_ULYSSES_CASE + (every,),
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

            pairs = b * h * live_pairs(s, causal, window)
            nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
            bound = _bound(4 * d * pairs, nbytes, dname, pairs)
            row = {"phase": "kernel", "case": name, "dtype": dname,
                   "variant": fa._forward_variant(dtype, d),
                   "shape_bshd": [b, s, h, d], "kv_heads": hkv,
                   "causal": causal, "window": window,
                   "max_abs_err": err, "tol_rel": rel, "tol_abs": atol,
                   "err_share_of_tol": err_share,
                   "library_max_abs_err": (lib_out.float()
                                           - ref.float()).abs().max().item(),
                   "ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "bound_term": bound[3]}
            if dname == "bfloat16" and name in SIMT_TIMED:
                row["simt_ms"] = _simt_forward_ms(q, k, v, causal, window,
                                                  lse=False)
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


def _want_variant(dtype: str, n: int) -> dict:
    """A flash kernel's launches by variant when ``n`` launches of a model
    in ``dtype`` (head dims multiples of 8, at most 128) are all served as
    the rules say: 16-bit by the sm90 kernels, f32 by the SIMT kernels."""
    return {"sm90": 0 if dtype == "float32" else n,
            "simt": n if dtype == "float32" else 0}


def _predict_route(extra, weights, data):
    """Build the LM, load ``weights``, warm up, then time one counted
    ``ModelPredictor.predict``; returns (fitted, logits, seconds,
    kernel launches during the counted run, and those by variant)."""
    from distkeras_tpu_torch import (FittedModel, ModelPredictor,
                                     load_jax_weights, transformer_lm)
    from distkeras_tpu_torch.ops.flash_attention import flash_attention
    model = transformer_lm(**{**LM, **extra})  # device=None: the card
    load_jax_weights(model, weights)
    fitted = FittedModel(model)
    predictor = ModelPredictor(fitted, batch_size=BATCH)
    predictor.predict(data)  # warm-up: cuBLAS handles, allocator
    _zero_counts()
    t0 = time.perf_counter()
    logits = predictor.predict(data)["prediction"]
    seconds = time.perf_counter() - t0
    return (fitted, logits, seconds, flash_attention.launches,
            dict(flash_attention.launches_by_variant))


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
    launches, variants, kept = {}, {}, {}
    for form, extra in FORMS.items():
        # one weight set per form, from the numpy seed, in the JAX layout
        weights = _random_jax_weights(
            transformer_lm(**LM, **extra, device="meta"), rng)
        for dtype in ("bfloat16", "float32"):
            kw = {**extra, "compute_dtype": dtype}
            fitted, logits, seconds, n_kernel, by_variant = _predict_route(
                kw, weights, data)
            launches[f"{form}/{dtype}"] = n_kernel
            variants[f"{form}/{dtype}"] = by_variant
            _, want, plain_seconds, n_plain, _ = _predict_route(
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
                  "kernel_launches_by_variant": by_variant,
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
            check(by_variant == _want_variant(dtype, want_launches),
                  f"{tag}: forward launches by variant {by_variant}")
            check(n_plain == 0, f"{tag}: the plain route launched the "
                                f"kernel {n_plain} times")
            if dtype == LM["compute_dtype"]:
                kept[form] = (fitted, data, logits)
    return launches, variants, kept


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

def _err_share(got, want, dname: str):
    """(max abs error, largest error as a share of its element's
    tolerance) of a kernel output against its plain version."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = TRAIN_TOL_ULP[dname] * w.abs() + TRAIN_TOL_F32 * w.abs().max()
    return diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()


def _bound(flops: float, nbytes: float, dname: str, exps: float = 0):
    """(bound ms at the dtype's peak, what bounds it: "bytes" or
    "operations", bound ms with the products at the f32 CUDA-core peak,
    the term that bounds it: "bytes", "tensor_core", "cuda_core" or
    "exponentials").  The bound is the largest of bytes over the HBM rate,
    flops over the dtype's peak and ``exps`` exponentials over the MUFU
    rate (EXP_PER_S)."""
    unit = "cuda_core" if dname == "float32" else "tensor_core"
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             unit: flops / PEAK_FLOPS[dname] * 1e3,
             "exponentials": exps / EXP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    f32_ms = max(flops / PEAK_FLOPS["float32"] * 1e3, terms["bytes"],
                 terms["exponentials"])
    return (terms[term], "bytes" if term == "bytes" else "operations",
            f32_ms, term)


def _simt_forward_ms(q, k, v, causal, window, lse: bool) -> float:
    """The forward's SIMT kernel timed on 16-bit inputs that the wrappers
    send to the sm90 kernel: through the private launcher, for timing
    only (these launches are not counted)."""
    import importlib
    import torch
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    out = torch.empty_like(q)
    b, s, h, _ = q.shape
    res = torch.empty(b, h, s, dtype=torch.float32, device=q.device) \
        if lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if res is None else res.data_ptr())
    return median_ms(lambda: fa._launch(
        fa.FORWARD_VARIANTS["simt"], ptrs, q, k.shape[2], fa._scale(q, None),
        causal, window), 3, 20)


def _simt_backward_ms(q, k, v, out, lse, do, delta, causal, window) -> dict:
    """The backward's SIMT kernels timed on 16-bit inputs that the
    wrappers send to the sm90 kernels: through the private launcher, for
    timing only (these launches are not counted)."""
    import importlib
    import torch
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta_out = torch.empty_like(delta)
    names = fa.BACKWARD_VARIANTS["simt"]
    rest = (q, k.shape[2], fa._scale(q, None), causal, window)
    dq_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               do.data_ptr(), lse.data_ptr(), delta_out.data_ptr(),
               dq.data_ptr())
    dkv_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr())
    return {"dq": median_ms(lambda: fa._launch(names["dq"], dq_ptrs, *rest),
                            3, 10),
            "dkv": median_ms(lambda: fa._launch(names["dkv"], dkv_ptrs,
                                                *rest), 3, 10)}


def _sdpa_backward_ms(sdpa, outputs, cotangent) -> dict:
    """SDPA's backward alone, on a graph kept from its forward, under
    each backend of SDPA_BACKENDS that takes the case (a yardstick only:
    the port never calls it); ms by backend."""
    import warnings
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:  # a backend that refuses the case warns why, then raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                lib_out = sdpa()
                times[name.lower()] = median_ms(lambda: torch.autograd.grad(
                    lib_out, outputs, cotangent, retain_graph=True), 3, 10)
        except RuntimeError:
            pass
        lib_out = None
    return times


def phase_kernel_train():
    import importlib
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    cases = [  # name, B, S, H, Hkv, D, causal, window: phase 2's shapes
        ("causal", 8, 2048, 8, 2, 32, True, None),
        ("window256", 8, 2048, 8, 2, 32, True, 256),
        ("noncausal", 8, 2048, 8, 2, 32, False, None),
        ("d64", 8, 1024, 8, 2, 64, True, None),
        ("d128", 8, 1024, 8, 2, 128, True, None),
        ("ragged200", 8, 200, 8, 2, 32, True, None),
        # head dims the kernels pad: 16 -> 32, 200 -> 256
        ("d16", 8, 1024, 8, 2, 16, True, None),
        ("d200", 2, 1000, 8, 2, 200, True, None),
        PLM_ULYSSES_CASE,
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    for name, b, s, h, hkv, d, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            dname = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(b, s, n, d, device="cuda",
                                       generator=gen).to(dtype)
                           for n in (h, hkv, hkv, h))
            args = (causal, None, window)
            out, lse = fa.flash_attention_forward(q, k, v, *args)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                                  *args)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta,
                                                *args)
            torch.cuda.synchronize()
            bwd_variant = fa._backward_variant(dtype, d)
            repeat_same = None
            if bwd_variant == "sm90":  # no atomics: the same bits again
                dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, out, lse,
                                                        do, *args)
                dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, lse, do,
                                                      delta2, *args)
                torch.cuda.synchronize()
                repeat_same = all(torch.equal(a, b) for a, b in (
                    (dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
                del dq2, delta2, dk2, dv2
            # each plain version on the kernel's own inputs
            ro, rl = fa.flash_attention_reference(q, k, v, *args,
                                                  return_lse=True)
            rq, rdelta = fa.flash_attention_bwd_dq_reference(
                q, k, v, out, lse, do, *args)
            rk, rv = fa.flash_attention_bwd_dkv_reference(
                q, k, v, lse, do, delta, *args)
            errs = {"out": _err_share(out, ro, dname),
                    "lse": _err_share(lse, rl, "float32"),
                    "delta": _err_share(delta, rdelta, "float32"),
                    "dq": _err_share(dq, rq, dname),
                    "dk": _err_share(dk, rk, dname),
                    "dv": _err_share(dv, rv, dname)}
            del ro, rl, rq, rdelta, rk, rv

            ms = {
                "fwd_lse": median_ms(lambda: fa.flash_attention_forward(
                    q, k, v, *args), 3, 20),
                "dq": median_ms(lambda: fa.flash_attention_bwd_dq(
                    q, k, v, out, lse, do, *args), 3, 10),
                "dkv": median_ms(lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, lse, do, delta, *args), 3, 10)}
            plain_ms = {
                "fwd_lse": median_ms(lambda: fa.flash_attention_reference(
                    q, k, v, *args, return_lse=True), 1, 3),
                "dq": median_ms(lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, out, lse, do, *args), 1, 3),
                "dkv": median_ms(
                    lambda: fa.flash_attention_bwd_dkv_reference(
                        q, k, v, lse, do, delta, *args), 1, 3)}
            # the yardstick: SDPA forward, and its backward alone on a
            # kept graph (never on the port's path)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask = {}
            if window is not None:
                pos = torch.arange(s, device="cuda")
                mask["attn_mask"] = ((pos[None, :] <= pos[:, None])
                                     & (pos[None, :] > pos[:, None] - window))
            else:
                mask["is_causal"] = causal
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **mask)
            sdpa_fwd_ms = median_ms(sdpa, 3, 10)
            sdpa_bwd = _sdpa_backward_ms(sdpa, (qt, kt, vt),
                                         do.transpose(1, 2))
            del qt, kt, vt

            # each kernel takes one exponential per live pair (the
            # backward kernels recompute p = exp(s - lse))
            pairs = b * h * live_pairs(s, causal, window)
            bounds = {
                "fwd_lse": _bound(4 * d * pairs,
                                  nbytes(q, k, v, out, lse), dname, pairs),
                "dq": _bound(6 * d * pairs,
                             nbytes(q, k, v, out, do, lse, dq, delta),
                             dname, pairs),
                "dkv": _bound(8 * d * pairs,
                              nbytes(q, k, v, do, lse, delta, dk, dv),
                              dname, pairs)}
            bwd_bytes = nbytes(q, k, v, out, do, lse, dq, dk, dv)
            bwd_bound = _bound(10 * d * pairs, bwd_bytes, dname, 2 * pairs)
            schedule_bound = _bound(14 * d * pairs, bwd_bytes, dname,
                                    3 * pairs)
            row = {"phase": "kernel_train", "case": name, "dtype": dname,
                   "variant": fa._forward_variant(dtype, d),
                   "bwd_variant": bwd_variant,
                   "bwd_repeat_bit_identical": repeat_same,
                   "shape_bshd": [b, s, h, d], "kv_heads": hkv,
                   "causal": causal, "window": window,
                   "max_abs_err": {n: e[0] for n, e in errs.items()},
                   "err_share_of_tol": {n: e[1] for n, e in errs.items()},
                   "tol_ulp": TRAIN_TOL_ULP[dname],
                   "tol_f32_of_max": TRAIN_TOL_F32,
                   "ms": ms, "plain_ms": plain_ms,
                   "bwd_ms": ms["dq"] + ms["dkv"],
                   "bwd_plain_ms": plain_ms["dq"] + plain_ms["dkv"],
                   "library_fwd_ms": sdpa_fwd_ms,
                   "library_bwd_ms": min(sdpa_bwd.values(), default=None),
                   "library_bwd_ms_by_backend": sdpa_bwd,
                   "bound_ms": {n: bd[0] for n, bd in bounds.items()},
                   "bound_by": {n: bd[1] for n, bd in bounds.items()},
                   "bound_term": {n: bd[3] for n, bd in bounds.items()},
                   "bound_ms_f32_cuda_cores": {n: bd[2] for n, bd in
                                               bounds.items()},
                   "bwd_bound_ms": bwd_bound[0],
                   "bwd_bound_ms_f32_cuda_cores": bwd_bound[2],
                   "bwd_schedule_bound_ms": schedule_bound[0],
                   "bwd_schedule_bound_ms_f32_cuda_cores":
                       schedule_bound[2]}
            if dname == "bfloat16" and name in SIMT_TIMED:
                row["simt_ms"] = {"fwd_lse": _simt_forward_ms(
                    q, k, v, causal, window, lse=True),
                    **_simt_backward_ms(q, k, v, out, lse, do, delta, causal,
                                        window)}
                row["simt_bwd_ms"] = row["simt_ms"]["dq"] + row["simt_ms"][
                    "dkv"]
            emit(row)
            worst = max(errs, key=lambda n: errs[n][1])
            check(errs[worst][1] <= 1.0, f"training kernels {name}/{dname}:"
                  f" {worst} error {errs[worst][1]:.3g}x its tolerance "
                  f"(max abs err {errs[worst][0]})")
            check(repeat_same is not False, f"sm90 backward {name}/{dname}: "
                  f"two runs on the same inputs differ")
            results[(name, dname)] = row
            del q, k, v, do, out, lse, dq, delta, dk, dv
            torch.cuda.empty_cache()
    return results


def phase_memory():
    """Forward and backward through the kernels at S 8192 (bf16, B 1,
    H 8, Hkv 2, D 32): the peak allocation above the inputs stays a small
    multiple of one (S, H, D) tensor, where one f32 (H, S, S) score
    tensor alone would take 2.1 GB."""
    import importlib
    import torch
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    b, s, h, hkv, d = 1, 8192, 8, 2, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q, k, v, do = (torch.randn(b, s, n, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for n in (h, hkv, hkv, h))
    for t in (q, k, v):
        t.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    unit = q.numel() * q.element_size()  # one (S, H, D) bf16 tensor
    limit = 8 * unit
    scores = b * h * s * s * 4
    counts = _read_counts()
    launches = [counts[n] for n in ("flash_fwd_lse_sm90", "flash_dq_sm90",
                                    "flash_dkv_sm90")]
    finite = all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    emit({"phase": "memory", "shape_bshd": [b, s, h, d], "kv_heads": hkv,
          "dtype": "bfloat16", "peak_bytes_above_inputs": peak,
          "sd_tensor_bytes": unit, "limit_bytes": limit,
          "peak_in_sd_tensors": peak / unit,
          "one_score_tensor_bytes": scores,
          "launches_fwd_dq_dkv_sm90": launches, "launches": counts,
          "grads_finite": finite})
    check(peak <= limit, f"fwd+bwd at S {s} allocated {peak} bytes above "
                         f"its inputs, over {limit}")
    check(launches == [1, 1, 1] and counts["flash_fwd_lse"]
          == counts["flash_dq"] == counts["flash_dkv"] == 1,
          f"fwd+bwd launches {counts}, want one each, all sm90")
    check(finite, "non-finite gradients at S 8192")


def _train_route(extra, weights, data, warm):
    """Build the LM with ``weights``, warm up with one short training,
    then run the counted ``SingleTrainer`` training; returns (fitted,
    history, seconds, launches of the four kernel entry points)."""
    import importlib
    import torch
    from distkeras_tpu_torch import (FittedModel, SingleTrainer,
                                     load_jax_weights, transformer_lm)
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    model = transformer_lm(**{**LM, **extra})  # device=None: the card
    load_jax_weights(model, weights)
    fitted = FittedModel(model)
    SingleTrainer(fitted, **{**TRAINER, "num_epoch": 1}).train(warm)
    torch.cuda.synchronize()
    _zero_counts()
    trainer = SingleTrainer(fitted, **TRAINER)
    t0 = time.perf_counter()
    trained = trainer.train(data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd_lse": fa.flash_attention_forward.launches,
                "dq": fa.flash_attention_backward.dq_launches,
                "dkv": fa.flash_attention_backward.dkv_launches,
                "inference": fa.flash_attention.launches,
                "fwd_lse_by_variant": dict(
                    fa.flash_attention_forward.launches_by_variant),
                "dq_by_variant": dict(
                    fa.flash_attention_backward.dq_launches_by_variant),
                "dkv_by_variant": dict(
                    fa.flash_attention_backward.dkv_launches_by_variant)}
    return trained, trainer.get_history(), seconds, launches


def _first_step_grads(extra, weights, data):
    """The gradient of every parameter for the first batch, through the
    trainer's own masked loss."""
    import torch
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    from distkeras_tpu_torch.core.train import (make_masked_loss_fn,
                                                model_params)
    model = transformer_lm(**{**LM, **extra})
    load_jax_weights(model, weights)
    compute = make_masked_loss_fn(model, TRAINER["loss"])
    x = torch.as_tensor(data["features"][:BATCH], device="cuda")
    y = torch.as_tensor(data["label"][:BATCH], device="cuda")
    value, _ = compute(x, y, torch.ones(BATCH, device="cuda"))
    params = model_params(model)
    grads = torch.autograd.grad(value, list(params.values()))
    return dict(zip(params, grads))


def phase_train(card: str):
    import importlib
    import numpy as np
    import torch
    from distkeras_tpu_torch import Dataset, ModelPredictor, transformer_lm
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    rng = np.random.default_rng(SEED + 3)
    x = rng.integers(0, LM["vocab_size"],
                     (TRAIN_ROWS, LM["seq_len"])).astype(np.int32)
    data = Dataset({"features": x,
                    "label": ((x + 1) % LM["vocab_size"]).astype(np.int64)})
    warm = Dataset({c: data[c][:BATCH] for c in data.columns})
    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // BATCH)
    want = LM["num_layers"] * steps
    runs = {}
    for form, extra in FORMS.items():
        weights = _random_jax_weights(
            transformer_lm(**LM, **extra, device="meta"), rng)
        for dtype in ("bfloat16", "float32"):
            tag = f"{form}/{dtype}"
            kw = {**extra, "compute_dtype": dtype}
            fitted, hist, seconds, launches = _train_route(
                kw, weights, data, warm)
            runs[tag] = launches
            _, plain_hist, plain_seconds, plain_launches = _train_route(
                {**kw, "attention_impl": "xla"}, weights, data, warm)
            torch.cuda.empty_cache()
            hist, plain_hist = np.asarray(hist), np.asarray(plain_hist)
            loss_rel = float(np.max(np.abs(hist - plain_hist)
                                    / np.abs(plain_hist)))
            row = {"phase": "train", "form": form, "compute_dtype": dtype,
                   "steps": steps, "rows": TRAIN_ROWS, "batch_size": BATCH,
                   "losses": hist.tolist(),
                   "plain_losses": plain_hist.tolist(),
                   "loss_max_rel_diff": loss_rel,
                   "loss_tol": (LOSS_RTOL_F32 if dtype == "float32"
                                else LOSS_BAND_BF16),
                   "last_over_first": float(hist[-1] / hist[0]),
                   "plain_last_over_first": float(plain_hist[-1]
                                                  / plain_hist[0]),
                   "launches": launches, "expected_launches": want,
                   "plain_route_launches": plain_launches,
                   "card": card, "ms_per_step": seconds / steps * 1e3,
                   "examples_per_s": TRAIN_ROWS * TRAIN_EPOCHS / seconds,
                   "plain_ms_per_step": plain_seconds / steps * 1e3,
                   "plain_examples_per_s":
                       TRAIN_ROWS * TRAIN_EPOCHS / plain_seconds}
            if dtype == "float32":
                got = _first_step_grads(kw, weights, data)
                ref = _first_step_grads({**kw, "attention_impl": "xla"},
                                        weights, data)
                gmax = max(g.abs().max().item() for g in ref.values())
                shares = {n: ((got[n] - ref[n]).abs().max().item()
                              / (GRAD_RTOL * ref[n].abs().max().item()
                                 + GRAD_ATOL * gmax)) for n in ref}
                worst = max(shares, key=shares.get)
                row.update({"grad_worst_tensor": worst,
                            "grad_worst_share_of_tol": shares[worst],
                            "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL})
                del got, ref
            emit(row)
            check(bool(np.isfinite(hist).all()), f"{tag}: non-finite loss")
            check(all(launches[n] == want for n in ("fwd_lse", "dq", "dkv"))
                  and launches["inference"] == 0,
                  f"{tag}: kernel launches {launches}, want {want} each")
            for key in ("fwd_lse_by_variant", "dq_by_variant",
                        "dkv_by_variant"):
                check(launches[key] == _want_variant(dtype, want),
                      f"{tag}: training launches {key} {launches[key]}")
            check(not any(n for n in plain_launches.values()
                          if isinstance(n, int))
                  and not any(any(n.values()) for n in plain_launches.values()
                              if isinstance(n, dict)),
                  f"{tag}: the plain route launched kernels {plain_launches}")
            check(loss_rel <= row["loss_tol"], f"{tag}: loss traces differ "
                  f"by {loss_rel} > {row['loss_tol']}")
            check(hist[-1] < LOSS_DROP * hist[0]
                  and plain_hist[-1] < LOSS_DROP * plain_hist[0],
                  f"{tag}: the loss did not fall below {LOSS_DROP} of the "
                  f"first ({hist[0]} -> {hist[-1]}, plain {plain_hist[0]} "
                  f"-> {plain_hist[-1]})")
            if dtype == "float32":
                check(row["grad_worst_share_of_tol"] <= 1.0,
                      f"{tag}: first-step gradient of {worst} differs "
                      f"{shares[worst]:.3g}x its tolerance")
            if (form, dtype) == MAIN_PATH:
                _zero_counts()
                served = ModelPredictor(fitted, batch_size=BATCH).predict(
                    Dataset({"features": x[:ROWS]}))["prediction"]
                n_serve = fa.flash_attention.launches
                serve_variant = dict(fa.flash_attention.launches_by_variant)
                emit({"phase": "train_serve", "form": form,
                      "compute_dtype": dtype, "rows": ROWS,
                      "inference_launches": n_serve,
                      "inference_launches_by_variant": serve_variant,
                      "finite": bool(np.isfinite(served).all())})
                n_want = LM["num_layers"] * -(-ROWS // BATCH)
                check(n_serve == n_want and serve_variant
                      == _want_variant(dtype, n_want),
                      f"serving the trained model launched the inference "
                      f"kernel {n_serve} times ({serve_variant})")
                check(bool(np.isfinite(served).all()),
                      "trained model served non-finite logits")
    return runs


def _ce_shares(got, want, rel: float, abs_of_max: float, atol: float = 0.0):
    """(max abs error, largest error as a share of its element's
    tolerance rel * |plain| + abs_of_max * max|plain| + atol)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = rel * w.abs() + abs_of_max * w.abs().max() + atol
    return diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()


def phase_kernel_ce():
    """The fused cross-entropy kernels (B1 forward, B2 backward) against
    their plain versions on the card, with a random per-row cotangent;
    kernel, plain and library times at the timed shapes."""
    import importlib
    import torch
    import torch.nn.functional as F
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [  # name, T, V, dtype, logits kind, timed
        ("slice", 16384, 32768, f32, "normal", True),
        ("slice", 16384, 32768, bf16, "normal", True),
        ("ragged", 300, 1000, f32, "normal", False),
        ("gpt2_vocab", 4096, 50257, f32, "normal", True),
        ("tiny", 8, 16, f16, "normal", False),
        ("extreme", 64, 4096, f32, "extreme", False),
        ("out_of_range_labels", 256, 1000, f32, "out_of_range", False),
        # rows 4 bytes off a 16-byte boundary, and off their gradient's
        ("offset_view", 512, 1000, bf16, "offset", False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    results = {}
    for name, t, v, dtype, kind, timed in cases:
        dname = str(dtype).split(".")[-1]
        if kind == "offset":
            flat = torch.randn(t * v + 2, device="cuda", generator=gen)
            logits = (3.0 * flat).to(dtype)[2:].view(t, v)
        else:
            logits = (3.0 * torch.randn(t, v, device="cuda", generator=gen)
                      ).to(dtype)
        if kind == "extreme":  # the JAX test's +-1e4 rows
            logits = torch.tensor([1e4, 0.0, -1e4, 5.0], device="cuda"
                                  ).repeat(t, v // 4).to(dtype)
        labels = torch.randint(0, v, (t,), device="cuda", generator=gen,
                               dtype=torch.int32)
        if kind == "out_of_range":
            labels[:6] = torch.tensor([-1, v, v + 7, -1000, 2 ** 31 - 1,
                                       v + 1000], dtype=torch.int32)
        ct = torch.randn(t, device="cuda", generator=gen)
        loss, lse = ce.fused_ce_fwd(logits, labels)
        dlogits = ce.fused_ce_bwd(logits, labels, lse, ct)
        torch.cuda.synchronize()
        rloss, rlse = ce.fused_ce_forward_reference(logits, labels)
        rdl = ce.fused_ce_backward_reference(logits, labels, lse, ct)
        ulp = TRAIN_TOL_ULP[dname]
        errs = {"loss": _ce_shares(loss, rloss, CE_TOL_REL, 0.0, CE_TOL_ABS),
                "lse": _ce_shares(lse, rlse, CE_TOL_REL, 0.0, CE_TOL_ABS),
                "dlogits": _ce_shares(dlogits, rdl, ulp, CE_GRAD_F32)}
        finite = bool(torch.isfinite(loss).all()
                      and torch.isfinite(dlogits).all())
        del rloss, rlse, rdl
        row = {"phase": "kernel_ce", "case": name, "dtype": dname,
               "shape_tv": [t, v], "finite": finite,
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "err_share_of_tol": {n: e[1] for n, e in errs.items()},
               "tol": {"loss_lse": [CE_TOL_REL, CE_TOL_ABS],
                       "dlogits_ulp": ulp, "dlogits_of_max": CE_GRAD_F32}}
        if kind == "out_of_range":
            bad = slice(0, 6)
            row["out_of_range_loss_minus_lse"] = (
                loss[bad] - lse[bad]).abs().max().item()
            check(row["out_of_range_loss_minus_lse"] == 0.0,
                  "out-of-range labels picked a logit")
        if timed:
            es = logits.element_size()
            fwd_bytes = t * v * es + 12 * t
            bwd_bytes = 2 * t * v * es + 12 * t
            bound = {"fwd": _bound(CE_OPS["fwd"] * t * v, fwd_bytes,
                                   "float32"),
                     "bwd": _bound(CE_OPS["bwd"] * t * v, bwd_bytes,
                                   "float32")}
            row["ms"] = {
                "fwd": median_ms(lambda: ce.fused_ce_fwd(logits, labels),
                                 3, 20),
                "bwd": median_ms(lambda: ce.fused_ce_bwd(
                    logits, labels, lse, ct), 3, 20)}
            row["plain_ms"] = {
                "fwd": median_ms(lambda: ce.fused_ce_forward_reference(
                    logits, labels), 1, 5),
                "bwd": median_ms(lambda: ce.fused_ce_backward_reference(
                    logits, labels, lse, ct), 1, 5)}
            # the yardstick, never on the port's path: cross_entropy's
            # forward, and its backward alone on a kept graph
            x = logits.detach().requires_grad_()
            lab64 = labels.long()
            lib = lambda: F.cross_entropy(x, lab64, reduction="none")
            lib_fwd = median_ms(lib, 3, 20)
            lib_out = lib()
            lib_bwd = median_ms(lambda: torch.autograd.grad(
                lib_out, x, ct.to(lib_out.dtype), retain_graph=True), 3, 20)
            del lib_out, x
            row.update({
                "library_ms": {"fwd": lib_fwd, "bwd": lib_bwd},
                "bound_ms": {n: b[0] for n, b in bound.items()},
                "bound_by": {n: b[1] for n, b in bound.items()},
                "bytes": {"fwd": fwd_bytes, "bwd": bwd_bytes},
                "hbm_share_of_peak": {
                    n: b[0] / row["ms"][n] for n, b in bound.items()}})
        emit(row)
        check(finite, f"fused CE {name}/{dname}: non-finite output")
        worst = max(errs, key=lambda n: errs[n][1])
        check(errs[worst][1] <= 1.0, f"fused CE {name}/{dname}: {worst} "
              f"error {errs[worst][1]:.3g}x its tolerance (max abs err "
              f"{errs[worst][0]})")
        results[(name, dname)] = row
        del logits, labels, ct, loss, lse, dlogits
        torch.cuda.empty_cache()
    return results


def phase_memory_ce():
    """Loss forward + backward at the parallel LM's (T, V) in f32: the
    peak allocation above the logits.  The fused route holds the gradient
    and O(T) vectors; the plain route (``log_softmax`` and a gather, the
    model's ``fused_ce=False`` loss) at least one (T, V) f32 more."""
    import importlib
    import torch
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    t, v = PLM_BATCH * PLM["seq_len"], PLM["vocab_size"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    logits = torch.randn(t, v, device="cuda", generator=gen)
    logits.requires_grad_(True)
    labels = torch.randint(0, v, (t,), device="cuda", generator=gen)
    tv_bytes = t * v * 4
    fused_limit = tv_bytes + 16 * t * 4
    peaks = {}
    for route in ("fused", "plain"):
        logits.grad = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ce.fused_ce_fwd.launches = ce.fused_ce_bwd.launches = 0
        if route == "fused":
            loss = ce.fused_softmax_cross_entropy(logits, labels).mean()
        else:
            logp = torch.log_softmax(logits, dim=-1)
            loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
            del logp
        loss.backward()
        torch.cuda.synchronize()
        peaks[route] = torch.cuda.max_memory_allocated() - base
        launches = [ce.fused_ce_fwd.launches, ce.fused_ce_bwd.launches]
        check(launches == ([1, 1] if route == "fused" else [0, 0]),
              f"memory_ce {route}: launches {launches}")
        check(bool(torch.isfinite(logits.grad).all()),
              f"memory_ce {route}: non-finite gradient")
        del loss
    emit({"phase": "memory_ce", "shape_tv": [t, v], "dtype": "float32",
          "tv_f32_bytes": tv_bytes,
          "fused_peak_bytes_above_logits": peaks["fused"],
          "fused_limit_bytes": fused_limit,
          "plain_peak_bytes_above_logits": peaks["plain"],
          "peak_in_tv_tensors": {r: p / tv_bytes for r, p in peaks.items()}})
    check(peaks["fused"] <= fused_limit, f"fused CE allocated "
          f"{peaks['fused']} bytes above the logits, over {fused_limit}")
    check(peaks["plain"] >= peaks["fused"] + tv_bytes, f"the plain CE "
          f"allocated {peaks['plain']} bytes, not a (T, V) f32 more than "
          f"the fused {peaks['fused']}")
    del logits
    torch.cuda.empty_cache()


def _parallel_tree(lm, rng):
    """Weights in the JAX ``ParallelTransformerLM`` tree's layout (nested
    dicts, a list of layers), drawn from a numpy seed by the JAX init's
    rules: LayerNorm scales ones, biases zeros, ``embed`` N(0, 0.02²),
    the other matrices N(0, 1) / sqrt(fan_in)."""
    import numpy as np
    tree = {"layers": [{} for _ in range(lm.num_layers)]}
    for name, shape in lm._shapes().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("ln"):
            w = np.ones(shape, np.float32)
        elif leaf.startswith("b"):
            w = np.zeros(shape, np.float32)
        elif leaf in ("embed", "pos"):
            w = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        else:
            w = (rng.standard_normal(shape, dtype=np.float32)
                 / np.float32(np.sqrt(shape[-2])))
        parts = name.split(".")
        if parts[0] == "layers":
            tree["layers"][int(parts[1])][parts[2]] = w
        else:
            tree[name] = w
    return tree


def _zero_counts():
    import importlib
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    ce.fused_ce_fwd.launches = ce.fused_ce_bwd.launches = 0
    fa.flash_attention.launches = fa.flash_attention_forward.launches = 0
    fa.flash_attention_backward.dq_launches = 0
    fa.flash_attention_backward.dkv_launches = 0
    for fn in (fa.flash_attention, fa.flash_attention_forward):
        fn.launches_by_variant = dict.fromkeys(fa.FORWARD_VARIANTS, 0)
    for kernel in ("dq", "dkv"):
        setattr(fa.flash_attention_backward, f"{kernel}_launches_by_variant",
                dict.fromkeys(fa.BACKWARD_VARIANTS, 0))


def _read_counts():
    import importlib
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    bwd = fa.flash_attention_backward
    by_variant = {"fwd_lse": fa.flash_attention_forward.launches_by_variant,
                  "dq": bwd.dq_launches_by_variant,
                  "dkv": bwd.dkv_launches_by_variant}
    return {"fused_ce_fwd": ce.fused_ce_fwd.launches,
            "fused_ce_bwd": ce.fused_ce_bwd.launches,
            "flash_fwd_lse": fa.flash_attention_forward.launches,
            "flash_dq": bwd.dq_launches,
            "flash_dkv": bwd.dkv_launches,
            "flash_inference": fa.flash_attention.launches,
            **{f"flash_{kernel}_{variant}": n
               for kernel, counts in by_variant.items()
               for variant, n in counts.items()}}


def _parallel_route(cfg, tree, toks, labels):
    """Build the LM from ``tree`` on the card and train it PLM_STEPS
    steps through ``compile_train_step``, the counts set to 0 just before
    and read just after; returns (losses, step seconds, launches)."""
    import torch
    from distkeras_tpu_torch.core.optimizers import adam
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              load_jax_params)
    lm = ParallelTransformerLM(**cfg, mesh=Mesh())  # the card
    params = load_jax_params(lm, tree)
    opt_state, step = lm.compile_train_step(adam(PLM_LR), params)
    dev = lm.batch_sharding()
    tokens = torch.as_tensor(toks, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    torch.cuda.synchronize()
    _zero_counts()
    losses, seconds = [], []
    for _ in range(PLM_STEPS):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, labels)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = _read_counts()
    losses = [float(x) for x in losses]
    del params, opt_state, lm
    torch.cuda.empty_cache()
    return losses, seconds, launches


def _first_step_parallel_grads(cfg, tree, toks, labels):
    import torch
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              load_jax_params)
    lm = ParallelTransformerLM(**cfg, mesh=Mesh())
    params = load_jax_params(lm, tree)
    dev = lm.batch_sharding()
    loss = lm._loss(params, torch.as_tensor(toks, device=dev),
                    torch.as_tensor(labels, device=dev))
    return dict(zip(params, torch.autograd.grad(loss,
                                                list(params.values()))))


def phase_parallel_train(card: str):
    """The full-width ParallelTransformerLM (bf16) from one numpy-seeded
    weight set, PLM_STEPS steps on each route, and the f32 pair (fused
    and plain CE) at PLM_F32_LAYERS layers."""
    import numpy as np
    import torch
    from distkeras_tpu_torch.parallel import Mesh, ParallelTransformerLM
    rng = np.random.default_rng(SEED + 5)
    v, s = PLM["vocab_size"], PLM["seq_len"]
    toks = rng.integers(0, v, (PLM_BATCH, s)).astype(np.int32)
    labels = (toks + 1) % v
    tokens_per_step = PLM_BATCH * s
    bf16 = {**PLM, "compute_dtype": "bfloat16"}
    tree = _parallel_tree(ParallelTransformerLM(
        **bf16, mesh=Mesh(device="meta")), rng)
    runs = {}
    for route, extra in PLM_ROUTES.items():
        losses, seconds, launches = _parallel_route(
            {**bf16, **extra}, tree, toks, labels)
        runs[route] = (losses, launches)
        fused = extra["fused_ce"]
        ulysses = extra.get("sp_impl") == "ulysses"
        flash_want = PLM["num_layers"] * PLM_STEPS if ulysses else 0
        step_ms = statistics.median(seconds[1:]) * 1e3
        emit({"phase": "parallel_train", "route": route,
              "compute_dtype": "bfloat16", "config": PLM,
              "batch": PLM_BATCH, "steps": PLM_STEPS, "losses": losses,
              "last_over_first": losses[-1] / losses[0],
              "launches": launches, "card": card,
              "first_step_ms": seconds[0] * 1e3, "ms_per_step": step_ms,
              "tokens_per_s": tokens_per_step / (step_ms / 1e3)})
        tag = f"parallel_train {route}"
        check(all(np.isfinite(losses)), f"{tag}: non-finite loss")
        check(losses[-1] < losses[0], f"{tag}: the loss did not fall "
              f"({losses[0]} -> {losses[-1]})")
        want_ce = PLM_STEPS if fused else 0
        check(launches["fused_ce_fwd"] == launches["fused_ce_bwd"] == want_ce,
              f"{tag}: fused CE launches {launches}, want {want_ce} each")
        check(all(launches[k] == flash_want for k in
                  ("flash_fwd_lse", "flash_dq", "flash_dkv",
                   "flash_fwd_lse_sm90", "flash_dq_sm90", "flash_dkv_sm90"))
              and launches["flash_inference"] == 0
              and launches["flash_fwd_lse_simt"] == 0
              and launches["flash_dq_simt"] == launches["flash_dkv_simt"] == 0,
              f"{tag}: flash launches {launches}, want {flash_want} each, "
              f"every one on the sm90 kernels")
    del tree
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                    / np.abs(np.asarray(b))))
    ce_gap = rel(runs["fused_ring"][0], runs["plain_ring"][0])
    schedule_gap = rel(runs["fused_ulysses"][0], runs["fused_ring"][0])

    # the f32 routes at cut depth: loss traces and first-step gradients,
    # fused vs plain CE (both ring) and Ulysses vs ring (both fused CE)
    f32 = {**PLM, "num_layers": PLM_F32_LAYERS, "compute_dtype": "float32"}
    tree32 = _parallel_tree(ParallelTransformerLM(
        **f32, mesh=Mesh(device="meta")), np.random.default_rng(SEED + 7))
    traces, grads = {}, {}
    for route, extra in PLM_ROUTES.items():
        losses, seconds, launches = _parallel_route(
            {**f32, **extra}, tree32, toks, labels)
        traces[route] = losses
        want_ce = PLM_STEPS if extra["fused_ce"] else 0
        want_flash = (PLM_F32_LAYERS * PLM_STEPS
                      if extra.get("sp_impl") == "ulysses" else 0)
        check(launches["fused_ce_fwd"] == launches["fused_ce_bwd"] == want_ce
              and all(launches[k] == want_flash for k in
                      ("flash_fwd_lse", "flash_dq", "flash_dkv",
                       "flash_fwd_lse_simt", "flash_dq_simt",
                       "flash_dkv_simt"))
              and launches["flash_fwd_lse_sm90"] == 0
              and launches["flash_dq_sm90"] == launches["flash_dkv_sm90"] == 0,
              f"f32 {route}: launches {launches}, want fused CE {want_ce} "
              f"and flash {want_flash} each, every one on the SIMT "
              f"kernels")
        grads[route] = _first_step_parallel_grads({**f32, **extra}, tree32,
                                                  toks, labels)
    del tree32

    def grad_worst(got, ref):
        gmax = max(g.abs().max().item() for g in ref.values())
        shares = {n: ((got[n] - ref[n]).abs().max().item()
                      / (GRAD_RTOL * ref[n].abs().max().item()
                         + GRAD_ATOL * gmax)) for n in ref}
        worst = max(shares, key=shares.get)
        return worst, shares[worst]

    pairs = {  # name: (route, reference route, loss-trace rtol)
        "ce": ("fused_ring", "plain_ring", PLM_LOSS_RTOL_F32),
        "schedule": ("fused_ulysses", "fused_ring", LOSS_RTOL_F32)}
    f32_rows = {}
    for name, (route, ref, rtol) in pairs.items():
        worst, share = grad_worst(grads[route], grads[ref])
        f32_rows[name] = {"routes": [route, ref],
                          "loss_gap": rel(traces[route], traces[ref]),
                          "loss_rtol": rtol, "grad_worst_tensor": worst,
                          "grad_worst_share_of_tol": share}
    del grads
    torch.cuda.empty_cache()
    emit({"phase": "parallel_train_check",
          "bf16_ce_route_gap": ce_gap, "bf16_ce_band": PLM_CE_BAND_BF16,
          "bf16_schedule_gap": schedule_gap,
          "bf16_schedule_band": PLM_SCHEDULE_BAND_BF16,
          "f32_layers": PLM_F32_LAYERS, "f32_losses": traces,
          "f32": f32_rows, "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL})
    check(ce_gap <= PLM_CE_BAND_BF16, f"bf16 fused vs plain CE loss traces "
          f"differ by {ce_gap} > {PLM_CE_BAND_BF16}")
    check(schedule_gap <= PLM_SCHEDULE_BAND_BF16, f"bf16 Ulysses vs ring "
          f"loss traces differ by {schedule_gap} > {PLM_SCHEDULE_BAND_BF16}")
    for name, r in f32_rows.items():
        check(r["loss_gap"] <= r["loss_rtol"], f"f32 {name} pair {r['routes']}"
              f": loss traces differ by {r['loss_gap']} > {r['loss_rtol']}")
        check(r["grad_worst_share_of_tol"] <= 1.0, f"f32 {name} pair "
              f"{r['routes']}: first-step gradient of "
              f"{r['grad_worst_tensor']} differs "
              f"{r['grad_worst_share_of_tol']:.3g}x its tolerance")
    check(all(t[-1] < t[0] for t in traces.values()),
          f"f32: the loss did not fall: {traces}")
    return {route: launches for route, (_, launches) in runs.items()}


def _sdpa_forward_ms(sdpa) -> dict:
    """SDPA's forward under each backend of SDPA_BACKENDS that takes the
    case (a yardstick only); ms by backend."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:  # a backend that refuses the case warns why, then raises
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                times[name.lower()] = median_ms(sdpa, 3, 10)
        except RuntimeError:
            pass
    return times


def phase_wide():
    """A head dim above 256 on the SIMT kernels (WIDE_CASE, f32 and bf16):
    ``attention`` forward and backward through the public entry point,
    its launches counted (the forward with lse, dq and dk/dv once each,
    every one on ``simt``); the inference form; each kernel against its
    plain version on its own inputs under the rules of phases kernel and
    kernel_train, the path's outputs bit-equal to the kernels'; and the
    kernels', plain versions' and SDPA's times (each backend that takes
    D 320) beside the bound."""
    import importlib
    import torch
    import torch.nn.functional as F
    from distkeras_tpu_torch.ops.attention import attention
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    name, b, s, h, hkv, d, causal, window = WIDE_CASE
    args = (causal, None, window)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v, do = (torch.randn(b, s, n, d, device="cuda",
                                   generator=gen).to(dtype)
                       for n in (h, hkv, hkv, h))
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        torch.cuda.synchronize()
        _zero_counts()
        out_path = attention(*leaves, causal=causal, window=window)
        grads = torch.autograd.grad(out_path, leaves, do)
        with torch.no_grad():  # the inference form
            inference = attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        launches = _read_counts()
        check(launches["flash_inference"] == 1
              and fa.flash_attention.launches_by_variant["simt"] == 1
              and all(launches[f"flash_{n}_simt"] == 1
                      for n in ("fwd_lse", "dq", "dkv"))
              and all(launches[f"flash_{n}_sm90"] == 0
                      for n in ("fwd_lse", "dq", "dkv")),
              f"wide {name}/{dname}: launches {launches}, want the inference "
              f"forward, the forward with lse, dq and dk/dv once each on "
              f"simt")
        launches["flash_inference_simt"] = fa.flash_attention.\
            launches_by_variant["simt"]
        out, lse = fa.flash_attention_forward(q, k, v, *args)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, *args)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, *args)
        torch.cuda.synchronize()
        same = (torch.equal(out_path, out)
                and all(torch.equal(g, w) for g, w in zip(grads,
                                                          (dq, dk, dv))))
        ref = fa.flash_attention_reference(q, k, v, *args)
        ro, rl = fa.flash_attention_reference(q, k, v, *args,
                                              return_lse=True)
        rq, rdelta = fa.flash_attention_bwd_dq_reference(q, k, v, out, lse,
                                                         do, *args)
        rk, rv = fa.flash_attention_bwd_dkv_reference(q, k, v, lse, do,
                                                      delta, *args)
        rel, atol = KERNEL_TOL[dname]
        diff = (inference.float() - ref.float()).abs()
        errs = {"inference": (diff.max().item(), (diff / (
                    rel * ref.float().abs() + atol)).max().item()),
                "out": _err_share(out, ro, dname),
                "lse": _err_share(lse, rl, "float32"),
                "delta": _err_share(delta, rdelta, "float32"),
                "dq": _err_share(dq, rq, dname),
                "dk": _err_share(dk, rk, dname),
                "dv": _err_share(dv, rv, dname)}
        del ref, ro, rl, rq, rdelta, rk, rv, diff, grads, out_path
        ms = {"fwd": median_ms(lambda: fa.flash_attention(q, k, v, *args),
                               3, 10),
              "fwd_lse": median_ms(lambda: fa.flash_attention_forward(
                  q, k, v, *args), 3, 10),
              "dq": median_ms(lambda: fa.flash_attention_bwd_dq(
                  q, k, v, out, lse, do, *args), 3, 10),
              "dkv": median_ms(lambda: fa.flash_attention_bwd_dkv(
                  q, k, v, lse, do, delta, *args), 3, 10)}
        plain_ms = {
            "fwd": median_ms(lambda: fa.flash_attention_reference(
                q, k, v, *args), 1, 3),
            "fwd_lse": median_ms(lambda: fa.flash_attention_reference(
                q, k, v, *args, return_lse=True), 1, 3),
            "dq": median_ms(lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, out, lse, do, *args), 1, 3),
            "dkv": median_ms(lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, lse, do, delta, *args), 1, 3)}
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        sdpa_fwd = _sdpa_forward_ms(sdpa)
        sdpa_bwd = _sdpa_backward_ms(sdpa, (qt, kt, vt), do.transpose(1, 2))
        del qt, kt, vt
        pairs = b * h * live_pairs(s, causal, window)
        bounds = {
            "fwd": _bound(4 * d * pairs, nbytes(q, k, v, out), dname, pairs),
            "fwd_lse": _bound(4 * d * pairs, nbytes(q, k, v, out, lse),
                              dname, pairs),
            "dq": _bound(6 * d * pairs,
                         nbytes(q, k, v, out, do, lse, dq, delta), dname,
                         pairs),
            "dkv": _bound(8 * d * pairs,
                          nbytes(q, k, v, do, lse, delta, dk, dv), dname,
                          pairs)}
        row = {"phase": "wide", "case": name, "dtype": dname,
               "shape_bshd": [b, s, h, d], "kv_heads": hkv,
               "causal": causal, "window": window,
               "head_dim_chunks": -(-d // fa.SIMT_HEAD_DIM_CHUNK),
               "variant": fa._forward_variant(dtype, d),
               "bwd_variant": fa._backward_variant(dtype, d),
               "launches": launches, "path_equals_kernels": same,
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "err_share_of_tol": {n: e[1] for n, e in errs.items()},
               "ms": ms, "plain_ms": plain_ms,
               "library_fwd_ms": min(sdpa_fwd.values(), default=None),
               "library_fwd_ms_by_backend": sdpa_fwd,
               "library_bwd_ms": min(sdpa_bwd.values(), default=None),
               "library_bwd_ms_by_backend": sdpa_bwd,
               "bound_ms": {n: bd[0] for n, bd in bounds.items()},
               "bound_by": {n: bd[1] for n, bd in bounds.items()},
               "bound_term": {n: bd[3] for n, bd in bounds.items()}}
        emit(row)
        worst = max(errs, key=lambda n: errs[n][1])
        check(errs[worst][1] <= 1.0, f"wide {name}/{dname}: {worst} error "
              f"{errs[worst][1]:.3g}x its tolerance (max abs err "
              f"{errs[worst][0]})")
        check(same, f"wide {name}/{dname}: attention's outputs or gradients "
              f"differ from the kernels' on the same inputs")
        rows[dname] = row
        del q, k, v, do, leaves, inference, out, lse, dq, delta, dk, dv
        torch.cuda.empty_cache()
    return rows


def phase_views():
    """Strided and misaligned views at the public entry points: each view
    case runs forward and backward through ``attention`` or
    ``fused_softmax_cross_entropy``, launches the kernels (counted), gives
    gradients in the views' shapes, is bit-equal to the same call on
    contiguous copies, and holds against the plain versions under the
    rules of phases kernel_train and kernel_ce."""
    import importlib
    import torch
    from distkeras_tpu_torch.ops.attention import attention
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    ce = importlib.import_module("distkeras_tpu_torch.ops.fused_ce")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    bf16 = torch.bfloat16
    rows = []

    def attention_case(name, leaf, views, do):
        """``views`` of ``leaf`` through attention, against contiguous
        copies of them and the plain versions."""
        torch.cuda.synchronize()
        _zero_counts()
        out = attention(*views, causal=True)
        (grad,) = torch.autograd.grad(out, leaf, do)
        torch.cuda.synchronize()
        launches = _read_counts()
        copies = tuple(t.detach().clone().requires_grad_() for t in views)
        out_c = attention(*copies, causal=True)
        grads_c = torch.autograd.grad(out_c, copies, do)
        grads_v = torch.autograd.grad(attention(*views, causal=True),
                                      views, do)
        q, k, v = copies
        args = (True, None, None)
        out_k, lse = fa.flash_attention_forward(q, k, v, *args)
        ro = fa.flash_attention_reference(q, k, v, *args)
        rq, rk, rv = fa.flash_attention_backward_reference(
            q.detach(), k.detach(), v.detach(), out_k, lse, do, *args)
        errs = {"out": _err_share(out, ro, "bfloat16"),
                **{n: _err_share(g, r, "bfloat16")
                   for n, g, r in zip(("dq", "dk", "dv"), grads_v,
                                      (rq, rk, rv))}}
        same = (torch.equal(out, out_c)
                and all(torch.equal(a, c) for a, c in zip(grads_v, grads_c)))
        row = {"phase": "views", "case": name, "dtype": "bfloat16",
               "shape_bshd": list(views[0].shape),
               "kv_shape": list(views[1].shape),
               "view_strides": [list(t.stride()) for t in views],
               "view_offsets_bytes": [t.storage_offset() * t.element_size()
                                      for t in views],
               "launches": launches, "equals_contiguous": same,
               "grad_shape_is_leaf_shape": grad.shape == leaf.shape,
               "max_abs_err": {n: e[0] for n, e in errs.items()},
               "err_share_of_tol": {n: e[1] for n, e in errs.items()}}
        emit(row)
        check(launches["flash_fwd_lse"] == launches["flash_dq"]
              == launches["flash_dkv"] == 1,
              f"views {name}: launches {launches}, want one of each")
        check(same and row["grad_shape_is_leaf_shape"], f"views {name}: "
              f"differs from the same call on contiguous copies")
        worst = max(errs, key=lambda n: errs[n][1])
        check(errs[worst][1] <= 1.0, f"views {name}: {worst} error "
              f"{errs[worst][1]:.3g}x its tolerance")
        rows.append(row)

    name, b, s, h, hkv, d = VIEW_QKV_CASE
    qkv = torch.randn(b, s, 3 * h, d, device="cuda", generator=gen).to(bf16)
    qkv.requires_grad_()
    do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(bf16)
    attention_case(name, qkv, qkv.chunk(3, dim=2), do)
    del qkv, do

    name, b, s, h, hkv, d = VIEW_MISALIGNED_CASE
    sizes = (b * s * h * d, b * s * hkv * d, b * s * hkv * d)
    flat = torch.randn(1 + sum(sizes), device="cuda", generator=gen).to(bf16)
    flat.requires_grad_()
    parts = flat[1:].split(sizes)  # each one bf16 element off the boundary
    views = tuple(p.view(b, s, n, d) for p, n in zip(parts, (h, hkv, hkv)))
    check(all(t.data_ptr() % 16 for t in views),
          "views misaligned: a view is not off a 16-byte boundary")
    do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(bf16)
    attention_case(name, flat, views, do)
    del flat, parts, views, do

    name, t, v = VIEW_CE_CASE
    base = 3.0 * torch.randn(v, t, device="cuda", generator=gen)
    base.requires_grad_()
    logits = base.t()  # (T, V), column-major
    labels = torch.randint(0, v, (t,), device="cuda", generator=gen)
    torch.cuda.synchronize()
    _zero_counts()
    loss = ce.fused_softmax_cross_entropy(logits, labels)
    (dbase,) = torch.autograd.grad(loss.sum(), base)
    torch.cuda.synchronize()
    launches = _read_counts()
    copy = logits.detach().contiguous().requires_grad_()
    loss_c = ce.fused_softmax_cross_entropy(copy, labels)
    (dcopy,) = torch.autograd.grad(loss_c.sum(), copy)
    # each plain version on the kernel's own inputs (the backward's on the
    # forward kernel's lse), as in phase kernel_ce
    rloss, _ = ce.fused_ce_forward_reference(copy.detach(), labels)
    _, lse = ce.fused_ce_fwd(copy.detach(), labels)
    rgrad = ce.fused_ce_backward_reference(copy.detach(), labels, lse,
                                           torch.ones_like(rloss))
    errs = {"loss": _ce_shares(loss, rloss, CE_TOL_REL, 0.0, CE_TOL_ABS),
            "dlogits": _ce_shares(dbase.t(), rgrad, 0.0, CE_GRAD_F32)}
    same = torch.equal(loss, loss_c) and torch.equal(dbase.t(), dcopy)
    row = {"phase": "views", "case": name, "dtype": "float32",
           "shape_tv": [t, v], "view_strides": list(logits.stride()),
           "launches": {k: launches[k] for k in ("fused_ce_fwd",
                                                 "fused_ce_bwd")},
           "equals_contiguous": same,
           "grad_shape_is_leaf_shape": dbase.shape == base.shape,
           "max_abs_err": {n: e[0] for n, e in errs.items()},
           "err_share_of_tol": {n: e[1] for n, e in errs.items()}}
    emit(row)
    check(launches["fused_ce_fwd"] == launches["fused_ce_bwd"] == 1,
          f"views {name}: launches {launches}, want one of each")
    check(same and row["grad_shape_is_leaf_shape"], f"views {name}: differs "
          f"from the same call on a contiguous copy")
    worst = max(errs, key=lambda n: errs[n][1])
    check(errs[worst][1] <= 1.0, f"views {name}: {worst} error "
          f"{errs[worst][1]:.3g}x its tolerance")
    rows.append(row)
    del base, logits, copy, dbase, dcopy, rgrad
    torch.cuda.empty_cache()
    return rows


def _zoo_weights(model, rng):
    """Weights in the JAX package's layout, from a numpy seed: kernels
    (Dense and Conv2D) ~N(0, 2/fan_in), biases and BatchNorm offsets 0,
    BatchNorm scales and variances 1, means 0 (the JAX init's values)."""
    import numpy as np
    from distkeras_tpu_torch.core.model import jax_leaves
    out = []
    for path, p in jax_leaves(model):
        shape = tuple(p.shape)
        if len(shape) >= 2:
            fan_in = float(np.prod(shape[:-1]))
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif path.endswith(("scale", "var")):
            w = np.ones(shape)
        else:
            w = np.zeros(shape)
        out.append(w.astype("float32"))
    return out


def _first_batch_grads(model, x, y):
    """The masked loss of one batch and every parameter's gradient
    (zeros for BatchNorm's statistics), through the trainer's own loss."""
    import torch
    from distkeras_tpu_torch.core.train import (_gradients,
                                                make_masked_loss_fn,
                                                model_params)
    value, _ = make_masked_loss_fn(model, ZOO_TRAINER["loss"])(
        x, y, torch.ones(len(x), device=x.device))
    params = model_params(model)
    return value.item(), dict(zip(params, _gradients(value,
                                                     list(params.values()))))


def _synthetic_rows(rng, rows, features, classes):
    """Rows of a learnable synthetic task: class prototypes plus noise
    in [0, 1], and one-hot labels."""
    import numpy as np
    protos = rng.uniform(0.2, 0.8, (classes, features))
    labels = rng.integers(0, classes, rows)
    x = np.clip(protos[labels] + 0.3 * rng.standard_normal(
        (rows, features)), 0.0, 1.0).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[labels]


def phase_zoo(card: str):
    """The ConvNet/MLP zoo on the card: the MNIST flow at full size
    (examples/s and predict rows/s on the host clock), bf16 against f32
    from the same weights, the blob round trip, the CIFAR-10 ConvNet and
    the Higgs MLP for an epoch, one step of the digits models and of a
    batch-norm stack; no attention or cross-entropy kernel launches on
    any of it."""
    import numpy as np
    import torch
    from distkeras_tpu_torch import (AccuracyEvaluator, FittedModel,
                                     LabelIndexTransformer,
                                     MinMaxTransformer, ModelPredictor,
                                     OneHotTransformer, Sequential,
                                     SingleTrainer, load_jax_weights)
    from distkeras_tpu_torch import models
    from distkeras_tpu_torch.core import layers as L
    from distkeras_tpu_torch.core import optimizers
    from distkeras_tpu_torch.core.train import (TrainState, make_train_step,
                                                model_params)
    from distkeras_tpu_torch.data import Dataset, has_real_data, load_mnist
    rng = np.random.default_rng(SEED + 17)

    # the MNIST flow
    train, test = load_mnist(n_train=ZOO_ROWS, n_test=ZOO_TEST_ROWS)
    scale = MinMaxTransformer(0, 1, 0, 255)
    train, test = scale.transform(train), scale.transform(test)
    train = OneHotTransformer(10).transform(train)
    weights = _zoo_weights(models.mnist_convnet("bfloat16", device="meta"),
                           rng)
    model = load_jax_weights(models.mnist_convnet("bfloat16"), weights)
    trainer = SingleTrainer(FittedModel(model), num_epoch=ZOO_EPOCHS,
                            **ZOO_TRAINER)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    fitted = trainer.train(train)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _read_counts()
    history = np.asarray(trainer.get_history())
    epochs = history.reshape(ZOO_EPOCHS, -1).mean(axis=1)
    predictor = ModelPredictor(fitted)
    predictor.predict(test.take(ZOO_BATCH))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predicted = predictor.predict(test)
    predict_s = time.perf_counter() - t0
    accuracy = AccuracyEvaluator().evaluate(
        LabelIndexTransformer().transform(predicted))
    emit({"phase": "zoo", "model": "mnist_convnet",
          "compute_dtype": "bfloat16", "rows": ZOO_ROWS,
          "test_rows": ZOO_TEST_ROWS, "epochs": ZOO_EPOCHS,
          "real_data": has_real_data("mnist"), **ZOO_TRAINER,
          "steps": len(history), "epoch_mean_loss": epochs.tolist(),
          "first_loss": float(history[0]), "last_loss": float(history[-1]),
          "accuracy": accuracy, "launches": launches, "card": card,
          "train_s": train_s,
          "examples_per_s": ZOO_ROWS * ZOO_EPOCHS / train_s,
          "predict_s": predict_s,
          "predict_rows_per_s": ZOO_TEST_ROWS / predict_s})
    check(np.isfinite(history).all(), "zoo mnist: non-finite loss")
    check(epochs[-1] < epochs[0], f"zoo mnist: the epoch mean loss did not "
          f"fall ({epochs.tolist()})")
    check(accuracy >= ZOO_ACCURACY_MIN, f"zoo mnist: accuracy {accuracy} "
          f"below {ZOO_ACCURACY_MIN}")
    check(not any(launches.values()), f"zoo mnist: attention or CE kernel "
          f"launches {launches}, want none")

    # the blob round trip of the trained model
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mnist_convnet.npz")
    fitted.save(path)
    rows = test["features"][:2048]
    same = bool(np.array_equal(FittedModel.load(path).predict(rows),
                               fitted.predict(rows)))
    emit({"phase": "zoo_blob", "path": os.path.relpath(path),
          "bytes": os.path.getsize(path), "bit_identical": same})
    check(same, "zoo blob round trip changed the predictions")

    # bf16 against f32 from the same weights, on the first batch
    x = torch.as_tensor(train["features"][:ZOO_BATCH], device="cuda")
    y = torch.as_tensor(train["label_encoded"][:ZOO_BATCH], device="cuda")
    loss16, g16 = _first_batch_grads(load_jax_weights(
        models.mnist_convnet("bfloat16"), weights), x, y)
    loss32, g32 = _first_batch_grads(load_jax_weights(
        models.mnist_convnet("float32"), weights), x, y)
    shares = {n: ((g16[n] - g32[n]).abs().max()
                  / g32[n].abs().max().clamp_min(1e-30)).item() for n in g32}
    loss_gap = abs(loss16 - loss32) / abs(loss32)
    emit({"phase": "zoo_bf16_vs_f32", "model": "mnist_convnet",
          "batch": ZOO_BATCH, "loss_bf16": loss16, "loss_f32": loss32,
          "loss_gap": loss_gap, "loss_band": ZOO_BF16_LOSS_BAND,
          "grad_gap_of_max": shares, "grad_band": ZOO_BF16_GRAD_BAND})
    check(loss_gap <= ZOO_BF16_LOSS_BAND, f"zoo bf16 vs f32: loss gap "
          f"{loss_gap} > {ZOO_BF16_LOSS_BAND}")
    worst = max(shares, key=shares.get)
    check(shares[worst] <= ZOO_BF16_GRAD_BAND, f"zoo bf16 vs f32: gradient "
          f"of {worst} off by {shares[worst]:.3g} of its max")
    del g16, g32, x, y

    # the CIFAR-10 ConvNet and the Higgs MLP: one epoch, the loss falls
    _zero_counts()
    for name, features, classes in (("cifar10_convnet", 3072, 10),
                                    ("higgs_mlp", 28, 2)):
        xs, ys = _synthetic_rows(rng, ZOO_SMALL_ROWS, features, classes)
        builder = getattr(models, name)
        small = load_jax_weights(builder("bfloat16"), _zoo_weights(
            builder("bfloat16", device="meta"), rng))
        t = SingleTrainer(FittedModel(small), num_epoch=1,
                          **{**ZOO_TRAINER, "batch_size": ZOO_SMALL_BATCH})
        t0 = time.perf_counter()
        t.train(Dataset({"features": xs, "label_encoded": ys}))
        seconds = time.perf_counter() - t0
        losses = np.asarray(t.get_history())
        quarter = len(losses) // 4
        emit({"phase": "zoo", "model": name, "compute_dtype": "bfloat16",
              "rows": ZOO_SMALL_ROWS, "batch_size": ZOO_SMALL_BATCH,
              "steps": len(losses), "first_quarter_loss":
              float(losses[:quarter].mean()), "last_quarter_loss":
              float(losses[-quarter:].mean()), "train_s": seconds,
              "card": card})
        check(np.isfinite(losses).all()
              and losses[-quarter:].mean() < losses[:quarter].mean(),
              f"zoo {name}: the loss did not fall ({losses.tolist()})")

    # one step of the digits models and of a batch-norm stack
    stacks = {
        "digits_mlp": models.digits_mlp("bfloat16"),
        "digits_convnet": models.digits_convnet("bfloat16"),
        "batchnorm_stack": Sequential(
            [L.Reshape((8, 8, 1)), L.Conv2D(16, 3, use_bias=False),
             L.BatchNormalization(), L.AveragePooling2D(2),
             L.GlobalAveragePooling2D(), L.Dense(10, activation="softmax")],
            input_shape=(64,), compute_dtype="bfloat16")}
    for name, net in stacks.items():
        load_jax_weights(net, _zoo_weights(net, rng))
        xs, ys = _synthetic_rows(rng, ZOO_SMALL_BATCH, 64, 10)
        x = torch.as_tensor(xs, device="cuda")
        y = torch.as_tensor(ys, device="cuda")
        params = model_params(net)
        tx, opt_state = optimizers.build("adam", params, learning_rate=1e-3)
        before = net.get_weights()
        _, loss = make_train_step(net, ZOO_TRAINER["loss"], tx)(
            TrainState(params, opt_state, 0), (x, y))
        with torch.no_grad():
            out = net(x)
        moved = {path: not np.array_equal(a, b) for (path, _), a, b in zip(
            model_params(net).items(), net.get_weights(), before)}
        stats_moved = [m for path, m in moved.items() if "/stats/" in path]
        emit({"phase": "zoo_step", "model": name, "loss": loss.item(),
              "outputs_finite": bool(torch.isfinite(out).all()),
              "stats_moved": stats_moved})
        check(bool(torch.isfinite(out).all()) and np.isfinite(loss.item()),
              f"zoo step {name}: non-finite outputs or loss")
        check(all(stats_moved), f"zoo step {name}: BatchNorm running "
              f"statistics did not move ({moved})")
    launches = _read_counts()
    check(not any(launches.values()), f"zoo models: attention or CE kernel "
          f"launches {launches}, want none")
    return {"train_s": train_s, "accuracy": accuracy}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import distkeras_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    kernel_rows = phase_kernel()
    launches, variants, kept = phase_slice()
    phase_blob(*kept["full"])

    train_rows = phase_kernel_train()
    phase_memory()
    train_runs = phase_train(smi)

    ce_rows = phase_kernel_ce()
    phase_memory_ce()
    plm_launches = phase_parallel_train(smi)

    wide_rows = phase_wide()
    phase_views()
    phase_zoo(smi)

    import importlib
    fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")
    csrc = "distkeras_tpu_torch/csrc/"
    # each variant with the runs that it serves: the sm90 kernels the main
    # path (bf16), the SIMT kernels the same path in f32
    served = {"sm90": ("/".join(MAIN_PATH), "bfloat16"),
              "simt": (f"{MAIN_PATH[0]}/float32", "float32")}
    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // BATCH)
    plm = PLM_ULYSSES_CASE[0]

    def forward_entry(variant):
        """The inference form at the slice's shape (phase kernel), its
        launches on the counted predict of the run it serves."""
        tag, dname = served[variant]
        r, u = kernel_rows[("causal", dname)], kernel_rows[(plm, dname)]
        return {"name": "flash_attention_fwd", "variant": variant,
                "route": "cuda",
                "source": f"{csrc}{fa.FORWARD_VARIANTS[variant]}.cu",
                "replaces": "distkeras_tpu/ops/flash_attention.py:78",
                "dtype": dname, "launches_run": tag,
                "launches": variants[tag][variant],
                "launches_by_path": {p: v[variant]
                                     for p, v in variants.items()},
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bound_term": r["bound_term"],
                "library_ms": r["library_ms"],
                "simt_ms": r.get("simt_ms"),
                "parallel_lm": {
                    "shape_bshd": u["shape_bshd"], "ms": u["ms"],
                    "simt_ms": u.get("simt_ms"), "plain_ms": u["plain_ms"],
                    "bound_ms": u["bound_ms"], "bound_term": u["bound_term"],
                    "library_ms": u["library_ms"],
                    "max_abs_err": u["max_abs_err"]}}
    outputs = {"fwd_lse": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    counters = {"fwd_lse": "flash_fwd_lse", "dq": "flash_dq",
                "dkv": "flash_dkv"}

    def train_entry(name, key, replaces, variant):
        """A training kernel's variant at the slice's shape (phase
        kernel_train), its launches on the counted SingleTrainer run of
        the path it serves and, at bf16, on the Ulysses route's counted
        steps.  SDPA's forward is the yardstick of the forward with lse
        (it computes out without returning the lse); no single library
        call computes dq alone or dk/dv alone, so those carry null and the
        SDPA backward (dq, dk and dv together) beside them."""
        tag, dname = served[variant]
        t, u = train_rows[("causal", dname)], train_rows[(plm, dname)]
        errs = outputs[key]
        by_variant = train_runs[tag][f"{key}_by_variant"]
        c_entry = (fa.FORWARD_VARIANTS[variant] if key == "fwd_lse"
                   else fa.BACKWARD_VARIANTS[variant][key])
        entry = {"name": name, "variant": variant, "route": "cuda",
                 "source": f"{csrc}{fa._ENTRIES[c_entry][0]}.cu",
                 "replaces": f"distkeras_tpu/ops/flash_attention.py:"
                             f"{replaces}",
                 "dtype": dname, "launches_run": tag,
                 "launches": by_variant[variant],
                 "launches_by_variant": by_variant,
                 "launches_per_step": by_variant[variant] // steps,
                 "max_abs_err": max(t["max_abs_err"][e] for e in errs),
                 "ms": t["ms"][key],
                 "plain_ms": t["plain_ms"][key],
                 "bound_ms": t["bound_ms"][key],
                 "bound_by": t["bound_by"][key],
                 "bound_term": t["bound_term"][key],
                 "library_ms": (t["library_fwd_ms"] if key == "fwd_lse"
                                else None),
                 "simt_ms": t.get("simt_ms", {}).get(key),
                 # the same kernel at the parallel LM's Ulysses shape
                 "parallel_lm": {
                     "shape_bshd": u["shape_bshd"], "kv_heads": u["kv_heads"],
                     "max_abs_err": max(u["max_abs_err"][e] for e in errs),
                     "ms": u["ms"][key], "plain_ms": u["plain_ms"][key],
                     "simt_ms": u.get("simt_ms", {}).get(key),
                     "bound_ms": u["bound_ms"][key],
                     "bound_by": u["bound_by"][key],
                     "bound_term": u["bound_term"][key],
                     "library_fwd_ms": u["library_fwd_ms"],
                     "library_bwd_ms": u["library_bwd_ms"],
                     "library_bwd_ms_by_backend":
                         u["library_bwd_ms_by_backend"]}}
        if key != "fwd_lse":
            entry["backward_library_ms"] = t["library_bwd_ms"]
            entry["backward_library_ms_by_backend"] = t[
                "library_bwd_ms_by_backend"]
        if dname == "bfloat16":  # its launches on the Ulysses route's steps
            entry["parallel_lm"]["launches"] = plm_launches["fused_ulysses"][
                f"{counters[key]}_{variant}"]
        return entry
    c = ce_rows[("slice", "float32")]  # the parallel LM's logits

    def ce_entry(name, key, replaces, *errs):
        return {"name": name, "route": "cuda",
                "source": "distkeras_tpu_torch/csrc/fused_ce.cu",
                "replaces": f"distkeras_tpu/ops/fused_ce.py:{replaces}",
                # the main path's counted run: the fused ring route's
                # PLM_STEPS steps; every counted route beside it
                "launches": plm_launches["fused_ring"][name],
                "launches_per_step":
                    plm_launches["fused_ring"][name] / PLM_STEPS,
                "launches_by_route": {r: n[name] for r, n in
                                      plm_launches.items()},
                "max_abs_err": max(c["max_abs_err"][e] for e in errs),
                "ms": c["ms"][key], "plain_ms": c["plain_ms"][key],
                "bound_ms": c["bound_ms"][key],
                "bound_by": c["bound_by"][key],
                "library_ms": c["library_ms"][key],
                "bf16_ms": ce_rows[("slice", "bfloat16")]["ms"][key]}

    def wide_entry(name, key, replaces):
        """A SIMT kernel at WIDE_CASE's head dim above 256 (bf16; f32
        beside it): its launches on phase wide's counted drive of
        ``attention`` forward, backward and inference form."""
        w, w32 = wide_rows["bfloat16"], wide_rows["float32"]
        errs = {"fwd": ("inference",), **outputs}[key]
        count = {"fwd": "flash_inference"}.get(key, counters.get(key))
        c_entry = (fa.FORWARD_VARIANTS["simt"] if key in ("fwd", "fwd_lse")
                   else fa.BACKWARD_VARIANTS["simt"][key])
        return {"name": name, "variant": "simt", "route": "cuda",
                "source": f"{csrc}{fa._ENTRIES[c_entry][0]}.cu",
                "replaces": f"distkeras_tpu/ops/flash_attention.py:"
                            f"{replaces}",
                "dtype": "bfloat16", "shape_bshd": w["shape_bshd"],
                "kv_heads": w["kv_heads"],
                "head_dim_chunks": w["head_dim_chunks"],
                "launches_run": f"wide {WIDE_CASE[0]}",
                "launches": w["launches"][f"{count}_simt"],
                "max_abs_err": max(w["max_abs_err"][e] for e in errs),
                "ms": w["ms"][key], "plain_ms": w["plain_ms"][key],
                "bound_ms": w["bound_ms"][key],
                "bound_by": w["bound_by"][key],
                "library_ms": (w["library_fwd_ms"]
                               if key in ("fwd", "fwd_lse") else None),
                "backward_library_ms": w["library_bwd_ms"],
                "float32": {"launches": w32["launches"][f"{count}_simt"],
                            "max_abs_err": max(w32["max_abs_err"][e]
                                               for e in errs),
                            "ms": w32["ms"][key],
                            "plain_ms": w32["plain_ms"][key],
                            "bound_ms": w32["bound_ms"][key],
                            "library_fwd_ms": w32["library_fwd_ms"],
                            "library_bwd_ms": w32["library_bwd_ms"]}}
    emit({"kernels": [
        forward_entry("sm90"),
        forward_entry("simt"),
        *(train_entry(name, key, replaces, v)
          for name, key, replaces in (
              ("flash_attention_fwd_lse", "fwd_lse", 78),
              ("flash_attention_bwd_dq", "dq", 182),
              ("flash_attention_bwd_dkv", "dkv", 221))
          for v in ("sm90", "simt")),
        ce_entry("fused_ce_fwd", "fwd", 54, "loss", "lse"),
        ce_entry("fused_ce_bwd", "bwd", 97, "dlogits"),
        *(wide_entry(name, key, replaces) for name, key, replaces in (
            ("flash_attention_fwd", "fwd", 78),
            ("flash_attention_fwd_lse", "fwd_lse", 78),
            ("flash_attention_bwd_dq", "dq", 182),
            ("flash_attention_bwd_dkv", "dkv", 221))),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
