#!/usr/bin/env python3
"""Where the time of the port's slices goes, on a CUDA card.

    python3 tools/profile_torch_slice.py [--out build/profile.json]
        [--slices predict,train,parallel,zoo]

Builds the full-width ``transformer_lm`` of ``chip_smoke.py`` (vocab 512,
seq 2048, d_model 256, 8 heads, 2 kv heads, 4 layers, mlp 1024, bf16) in
its ``"full"`` and ``"rolling_window"`` forms, with random weights drawn
from a numpy seed by ``chip_smoke.py``'s rule, and traces under
``torch.profiler``:

- serving: one ``ModelPredictor.predict`` of 16 rows (2 batches of 8),
  after two warm-up calls;
- training: one masked train step of ``SingleTrainer`` (the x+1 task,
  adam 3e-3, a batch of 8 rows), after three warm-up steps; the update
  rule's own time (``tx.update`` plus the in-place apply) is then taken
  with CUDA events, as a median over 5 calls, because its many small
  elementwise kernels carry no name of their own;
- parallel: one ``compile_train_step`` step of the full-width
  ``ParallelTransformerLM`` of ``chip_smoke.py`` (vocab 32768, d_model
  512, 8 heads, 8 layers, mlp 2048, RoPE, bf16, batch 8 x 2048, adam
  1e-3) on the fused-CE route, with the ``"ring"`` and the ``"ulysses"``
  schedule, after three warm-up steps, the update rule timed as above;
- zoo: one masked ``SingleTrainer`` step of ``mnist_convnet`` in bf16
  (the north-star MNIST ConvNet of ``chip_smoke.py``'s zoo phase: batch
  512 of synthetic MNIST rows, adam 1e-3, numpy-seeded weights), after
  three warm-up steps, the update rule timed as above.

It prints one JSON line per slice and form: the wall time (host clock
around work that ends in a synchronise), the device's busy time (the sum
of kernel and copy durations on the card; one stream, so they do not
overlap) and idle share, and the device time by kernel, largest first,
grouped as the flash kernels (the sm90 and SIMT variants of the forward
and of the backward's dq and dk/dv kernels apart), the fused
cross-entropy kernels, convolutions (cuDNN's forward, data- and
weight-gradient kernels), matrix products, copies and the rest
(elementwise kernels, pooling, reductions).  The whole result also goes to ``--out``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def group(name: str) -> str:
    low = name.lower()
    for kernel, label in (("flash_fwd_sm90_kernel",
                           "flash_attention_fwd_sm90"),
                          ("flash_fwd_kernel", "flash_attention_fwd"),
                          ("flash_bwd_dq_sm90_kernel",
                           "flash_attention_bwd_dq_sm90"),
                          ("flash_bwd_dkv_sm90_kernel",
                           "flash_attention_bwd_dkv_sm90"),
                          ("flash_bwd_dq_kernel", "flash_attention_bwd_dq"),
                          ("flash_bwd_dkv_kernel", "flash_attention_bwd_dkv"),
                          ("fused_ce_fwd_kernel", "fused_ce_fwd"),
                          ("fused_ce_bwd_kernel", "fused_ce_bwd")):
        if kernel in low:
            return label
    if "memcpy" in low or "memset" in low:
        return "copy"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
        return "conv"
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul"
    return "other"


def device_summary(prof, wall_ms):
    import torch
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms
            else None,
            "by_group_ms": {k: v / 1e3 for k, v in
                            sorted(by_group.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[name[:90], us / 1e3] for name, us in top]}


def build_model(extra):
    import numpy as np
    import chip_smoke
    from distkeras_tpu_torch import load_jax_weights, transformer_lm
    rng = np.random.default_rng(chip_smoke.SEED)
    model = transformer_lm(**chip_smoke.LM, **extra)
    load_jax_weights(model, chip_smoke._random_jax_weights(model, rng))
    return model


def profile_predict(form, extra, data):
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from distkeras_tpu_torch import FittedModel, ModelPredictor
    predictor = ModelPredictor(FittedModel(build_model(extra)),
                               batch_size=chip_smoke.BATCH)
    predictor.predict(data)
    predictor.predict(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(data)  # ends with a copy to the host: synced
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"slice": "predict", "form": form, "rows": len(data),
            "batch_size": chip_smoke.BATCH, **device_summary(prof, wall_ms)}


def profile_train(form, extra, x, y):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from distkeras_tpu_torch.core import optimizers
    from distkeras_tpu_torch.core.train import (TrainState, make_masked_step,
                                                model_params)
    model = build_model(extra)
    params = model_params(model)
    tx, opt_state = optimizers.build(
        chip_smoke.TRAINER["worker_optimizer"], params,
        chip_smoke.TRAINER["learning_rate"])
    step = make_masked_step(model, chip_smoke.TRAINER["loss"], tx)
    state = TrainState(params, opt_state, 0)
    w = np.ones(len(x), np.float32)
    for _ in range(3):
        state, loss, _ = step(state, x, y, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss, _ = step(state, x, y, w)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"slice": "train", "form": form, "batch_size": len(x),
            "loss": float(loss), **device_summary(prof, wall_ms),
            "optimizer_ms": update_rule_ms(tx, state.opt_state, params)}


def profile_zoo():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from distkeras_tpu_torch import (MinMaxTransformer, OneHotTransformer,
                                     load_jax_weights, mnist_convnet)
    from distkeras_tpu_torch.core import optimizers
    from distkeras_tpu_torch.core.train import (TrainState, make_masked_step,
                                                model_params)
    from distkeras_tpu_torch.data import load_mnist
    batch = chip_smoke.ZOO_BATCH
    train, _ = load_mnist(n_train=batch, n_test=1)
    train = OneHotTransformer(10).transform(
        MinMaxTransformer(0, 1, 0, 255).transform(train))
    x = torch.as_tensor(train["features"], device="cuda")
    y = torch.as_tensor(train["label_encoded"], device="cuda")
    model = mnist_convnet("bfloat16")
    load_jax_weights(model, chip_smoke._zoo_weights(
        model, np.random.default_rng(chip_smoke.SEED + 17)))
    params = model_params(model)
    cfg = chip_smoke.ZOO_TRAINER
    tx, opt_state = optimizers.build(cfg["worker_optimizer"], params,
                                     cfg["learning_rate"])
    step = make_masked_step(model, cfg["loss"], tx)
    state = TrainState(params, opt_state, 0)
    w = np.ones(batch, np.float32)
    for _ in range(3):
        state, loss, _ = step(state, x, y, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss, _ = step(state, x, y, w)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"slice": "zoo_train", "model": "mnist_convnet",
            "compute_dtype": "bfloat16", "batch_size": batch,
            "loss": float(loss), **device_summary(prof, wall_ms),
            "optimizer_ms": update_rule_ms(tx, state.opt_state, params)}


def update_rule_ms(tx, opt_state, params):
    """Median CUDA-event time of the update rule alone (``tx.update``
    plus the in-place apply) on gradient-sized random tensors."""
    import torch
    from distkeras_tpu_torch.core import optimizers
    plist = list(params.values())
    grads = [torch.randn_like(p) * 1e-3 for p in plist]
    times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            updates, _ = tx.update(grads, opt_state, plist)
            optimizers.apply_updates(plist, updates)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def profile_parallel(route):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from distkeras_tpu_torch.core.optimizers import adam
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              load_jax_params)
    cfg = {**chip_smoke.PLM, "compute_dtype": "bfloat16",
           **chip_smoke.PLM_ROUTES[route]}
    lm = ParallelTransformerLM(**cfg, mesh=Mesh())
    rng = np.random.default_rng(chip_smoke.SEED + 5)
    v, s = cfg["vocab_size"], cfg["seq_len"]
    toks = rng.integers(0, v, (chip_smoke.PLM_BATCH, s)).astype(np.int32)
    params = load_jax_params(lm, chip_smoke._parallel_tree(lm, rng))
    tx = adam(chip_smoke.PLM_LR)
    opt_state, step = lm.compile_train_step(tx, params)
    tokens = torch.as_tensor(toks, device=lm.batch_sharding())
    labels = (tokens.long() + 1) % v
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, tokens, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    row = {"slice": "parallel_train", "route": route,
           "batch_size": chip_smoke.PLM_BATCH, "seq_len": s,
           "loss": float(loss), **device_summary(prof, wall_ms),
           "optimizer_ms": update_rule_ms(tx, opt_state, params)}
    del params, opt_state, prof
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "profile_torch_slice.json"))
    ap.add_argument("--slices", default="predict,train,parallel,zoo",
                    help="comma-separated: predict, train, parallel, zoo")
    args = ap.parse_args()
    slices = set(args.slices.split(","))
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
    lm = chip_smoke.LM
    ids = np.random.default_rng(chip_smoke.SEED).integers(
        0, lm["vocab_size"], (chip_smoke.ROWS, lm["seq_len"]))
    data = Dataset({"features": ids.astype(np.int32)})
    x = torch.as_tensor(ids[:chip_smoke.BATCH].astype(np.int32),
                        device="cuda")
    y = (x.long() + 1) % lm["vocab_size"]
    results = {"card": smi, "torch": torch.__version__, "rows": []}
    runs = []
    for form, extra in chip_smoke.FORMS.items():
        if "predict" in slices:
            runs.append(lambda f=form, e=extra: profile_predict(f, e, data))
        if "train" in slices:
            runs.append(lambda f=form, e=extra: profile_train(f, e, x, y))
    if "parallel" in slices:
        runs += [lambda r=route: profile_parallel(r)
                 for route in ("fused_ring", "fused_ulysses")]
    if "zoo" in slices:
        runs.append(profile_zoo)
    for run in runs:
        row = run()
        results["rows"].append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
