"""Driver entry points, counterpart of the JAX package's
``__graft_entry__.py``.

``entry()``          — the flagship forward (the MNIST ConvNet, the ADAG
                       north-star model) and an example batch on the
                       device, for a one-device check.
``dryrun_multichip`` — runs the framework's distributed surface on
                       ``n_devices`` ranks at tiny shapes: the ADAG SPMD
                       round over a worker mesh, ``ParallelTransformerLM``
                       over (data, seq, model) with a mixture-of-experts
                       layer and then under Ulysses with FSDP,
                       ``PipelineTransformerLM`` under GPipe over (data,
                       stage), and 1F1B, in 3-D form when the count
                       factors three ways.

The ranks are one process each, started together as a coordinated
``job_deployment.Job`` over gloo (``python -m distkeras_tpu_torch.dryrun
--rank OUT DEVICE``); on a machine with fewer cards than ranks they share
them (rank ``r`` on card ``r % device_count``).  From a shell::

    python -m distkeras_tpu_torch.dryrun 4          # on the card(s)
    python -m distkeras_tpu_torch.dryrun 4 cpu      # CPU ranks

prints the ranks' losses and the JAX modules each process loaded (none)
as one JSON line.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

#: the module names a run of the port must never load
JAX_MODULES = ("jax", "jaxlib", "distkeras_tpu")


def entry(device=None):
    """Return ``(fn, example_args)``: the flagship forward (``mnist_convnet``
    in its default bf16, weights drawn from seed 0) and a zero batch of 8
    rows on the device (``None``: the card).  The port's model holds its
    parameters, so ``fn`` takes the batch alone."""
    from .models.zoo import mnist_convnet
    model = mnist_convnet(device=device,
                          generator=torch.Generator().manual_seed(0))
    x = torch.zeros((8, 784), dtype=torch.float32, device=model.device)

    def fn(x):
        return model(x)

    return fn, (x,)


def _three_factors(n: int):
    """Split n into (a, b, c) factors, as balanced as possible — compare
    sorted-descending tuples lexicographically so 16 → (4, 2, 2), not
    (4, 4, 1); 8 → (2, 2, 2); primes → (n, 1, 1)."""
    best = (n, 1, 1)
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            best = min(best, tuple(sorted((a, b, m // b), reverse=True)))
    return best


def _finite(loss, what: str) -> float:
    value = float(loss)
    if not np.isfinite(value):
        raise FloatingPointError(
            f"non-finite {what} loss in dryrun: {value}")
    return value


def _run_rank(device: str) -> Dict[str, object]:
    """This rank's four parts (``dryrun_multichip``); the losses by part."""
    import torch.distributed as dist

    from .core.optimizers import adam
    from .models.zoo import mnist_convnet
    from .parallel import (Mesh, ParallelTransformerLM,
                           PipelineTransformerLM, get_mesh)
    from .parallel.spmd import SPMDEngine, shape_epoch_data

    # one rank joins no group (initialize_from_env), and every mesh is 1
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if device == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", r % count) for r in range(n)]
        torch.cuda.set_device(devs[rank])
    out: Dict[str, object] = {"rank": rank, "device": str(devs[rank])}

    def grid(shape, names):
        arr = np.empty(n, dtype=object)
        arr[:] = devs
        return Mesh(arr.reshape(shape), names)

    # -- 1. the ADAG SPMD round (the 'workers' axis) --------------------------
    mesh = get_mesh(n, devices=devs)
    model = mnist_convnet(device=devs[rank])
    engine = SPMDEngine(model, "categorical_crossentropy", "adam", mesh,
                        "adag", communication_window=2)
    state = engine.init_state(torch.Generator().manual_seed(0), (784,))
    batch = 2
    rows = n * 2 * batch  # one round of data
    x = np.random.default_rng(0).standard_normal((rows, 784)).astype(
        np.float32)
    y = np.eye(10, dtype=np.float32)[np.arange(rows) % 10]
    xb, yb, mb, _ = shape_epoch_data(x, y, n, 2, batch)
    state, losses = engine.run_epoch(state, xb, yb, mb,
                                     engine.worker_rngs(0))
    out["adag"] = [_finite(v, "ADAG") for v in losses.cpu()]

    # -- 2. dp × sp × tp (+ MoE) ParallelTransformerLM step -------------------
    dp, sp, tp = _three_factors(n)
    tmesh = grid((dp, sp, tp), ("data", "seq", "model"))
    heads = 2 * tp  # 2 query heads per kv head: the GQA grouping (G=2)
    seq_len = 8 * sp
    lm = ParallelTransformerLM(
        vocab_size=32, seq_len=seq_len, d_model=8 * heads, num_heads=heads,
        num_layers=2, mlp_dim=16 * tp, mesh=tmesh, moe_layers=(1,),
        num_experts=tp, compute_dtype="float32", num_kv_heads=tp,
        attention_window=max(seq_len // 2, 1), positional="rope")
    params = lm.init(torch.Generator().manual_seed(0))
    opt_state, step = lm.compile_train_step(adam(1e-2), params)
    rng_np = np.random.default_rng(1)
    # per-rank batch = tp so the MoE token slices divide evenly for any
    # factorization
    toks = rng_np.integers(0, 32, (tp * dp, seq_len)).astype(np.int32)
    labels = (toks + 1) % 32
    params, opt_state, loss = step(params, opt_state, lm.shard_batch(toks),
                                   lm.shard_batch(labels))
    out["transformer"] = _finite(loss, "transformer")

    # -- 2b. the same mesh under Ulysses, with FSDP over the data axis --------
    heads_u = 2 * sp * tp
    lm_u = ParallelTransformerLM(
        vocab_size=32, seq_len=seq_len, d_model=4 * heads_u,
        num_heads=heads_u, num_layers=1, mlp_dim=16 * tp, mesh=tmesh,
        compute_dtype="float32", sp_impl="ulysses", num_kv_heads=tp,
        attention_window=max(seq_len // 2, 1), positional="rope")
    params_u = lm_u.init(torch.Generator().manual_seed(2))
    opt_u, step_u = lm_u.compile_train_step(adam(1e-2), params_u, fsdp=True)
    params_u, opt_u, loss_u = step_u(params_u, opt_u,
                                     lm_u.shard_batch(toks),
                                     lm_u.shard_batch(labels))
    out["ulysses_fsdp"] = _finite(loss_u, "ulysses")

    # -- 3. dp × pp PipelineTransformerLM (GPipe) -----------------------------
    # the smallest divisor >= sqrt(n) stages: 8 → (2, 4), primes → (1, n)
    pp = min(f for f in range(1, n + 1) if n % f == 0 and f * f >= n)
    dp2 = n // pp
    pmesh = grid((dp2, pp), ("data", "stage"))
    plm = PipelineTransformerLM(
        vocab_size=32, seq_len=8, d_model=8, num_heads=2, num_layers=pp,
        mlp_dim=16, mesh=pmesh, num_microbatches=2, compute_dtype="float32")
    pparams = plm.init(torch.Generator().manual_seed(4))
    popt, pstep = plm.compile_train_step(adam(1e-2), pparams)
    ptoks = rng_np.integers(0, 32, (dp2 * 2, 8)).astype(np.int32)
    pparams, popt, ploss = pstep(pparams, popt, plm.shard_batch(ptoks),
                                 plm.shard_batch((ptoks + 1) % 32))
    out["pipeline_gpipe"] = _finite(ploss, "pipeline-LM")

    # -- 4. 1F1B, 3-D (dp × pp × tp) when n factors three ways ----------------
    d3, p3, t3 = _three_factors(n)
    if t3 > 1:
        mesh3 = grid((d3, p3, t3), ("data", "stage", "model"))
        plm1 = PipelineTransformerLM(
            vocab_size=32, seq_len=8, d_model=4 * t3, num_heads=2 * t3,
            num_layers=p3, mlp_dim=8 * t3, mesh=mesh3, num_microbatches=2,
            compute_dtype="float32", schedule="1f1b", model_axis="model")
        toks1 = rng_np.integers(0, 32, (d3 * 2, 8)).astype(np.int32)
    else:
        plm1 = PipelineTransformerLM(
            vocab_size=32, seq_len=8, d_model=8, num_heads=2, num_layers=pp,
            mlp_dim=16, mesh=pmesh, num_microbatches=2,
            compute_dtype="float32", schedule="1f1b")
        toks1 = ptoks
    p1 = plm1.init(torch.Generator().manual_seed(4))
    popt1, pstep1 = plm1.compile_train_step(adam(1e-2), p1)
    p1, popt1, ploss1 = pstep1(p1, popt1, plm1.shard_batch(toks1),
                               plm1.shard_batch((toks1 + 1) % 32))
    out["pipeline_1f1b"] = _finite(ploss1, "1F1B")
    out["factors"] = {"transformer": [dp, sp, tp], "pipeline": [dp2, pp],
                      "1f1b": [d3, p3, t3] if t3 > 1 else [dp2, pp]}
    from .kernels import launch_counts
    out["launches"] = launch_counts()  # this rank's, over all four parts
    return out


def _loaded_jax() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in JAX_MODULES)


def _rank_main(out_dir: str, device: str) -> None:
    """One rank: join the group, run the parts, write ``rank<r>.json``; a
    rank that raises writes its traceback and leaves at once, so its peers'
    collectives fail rather than wait."""
    rank = os.environ.get("DISTKERAS_TPU_PROCESS_ID", "?")
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        from .job_deployment import initialize_from_env
        initialize_from_env()
        import torch.distributed as dist
        result = _run_rank(device)
        rank = result["rank"]
        result["modules"] = _loaded_jax()
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout: float = 600.0) -> Dict[str, object]:
    """Run the framework's distributed surface on ``n_devices`` ranks at
    tiny shapes, as the JAX ``dryrun_multichip`` runs it on an
    ``n_devices`` mesh:

    1. the ADAG SPMD round (the 'workers' axis: local windows, one
       all_reduce of the deltas);
    2. ``ParallelTransformerLM`` over (data, seq, model) = the balanced
       three factors of ``n_devices``: ring attention, Megatron tensor
       parallelism, GQA, a sliding window, RoPE and one mixture-of-experts
       layer; then the same mesh under Ulysses with FSDP;
    3. ``PipelineTransformerLM`` under GPipe over (data, stage);
    4. the 1F1B schedule, over (data, stage, model) when the count factors
       three ways.

    ``device``: ``None`` (the card: rank ``r`` on ``cuda:(r %
    device_count)``) or ``"cpu"``.  The ranks run over gloo as one
    coordinated ``Job``; any rank's failure or a non-finite loss raises
    here, and every rank is gone when this returns.  Returns the ranks'
    results (losses by part, devices, each rank's kernel launches and the
    JAX modules each loaded)."""
    from .device import resolve_device
    from .job_deployment import Job, LocalJobRunner
    dev = resolve_device(device)
    if dev.type != "cpu":
        dev = torch.device("cuda")
    root = Path(__file__).resolve().parents[1]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out:
        env = {"PYTHONPATH": os.pathsep.join(
            p for p in (str(root), os.environ.get("PYTHONPATH")) if p)}
        if dev.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        job = Job("dryrun", "-m", args=["distkeras_tpu_torch.dryrun",
                                        "--rank", out, dev.type],
                  hosts=["127.0.0.1"] * n_devices, coordinator_port=port,
                  backend="gloo", env=env)
        deadline = time.monotonic() + timeout
        job.run(LocalJobRunner(), wait=False)
        codes = []
        try:
            for p in job.processes:
                left = max(deadline - time.monotonic(), 0.1)
                codes.append(p.wait(timeout=left))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dryrun: {n_devices} ranks did not finish in "
                               f"{timeout} s") from None
        finally:
            for p in job.processes:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        errs = [f.read_text() for f in sorted(Path(out).glob("rank*.err"))]
        if codes != [0] * n_devices or errs:
            raise RuntimeError(f"dryrun: ranks exited {codes}\n"
                               + "\n".join(errs))
        ranks = [json.loads(Path(out, f"rank{r}.json").read_text())
                 for r in range(n_devices)]
    return {"n_devices": n_devices, "ranks": ranks,
            "modules": _loaded_jax()}


def main(argv) -> int:
    if argv[:1] == ["--rank"] and len(argv) == 3:
        _rank_main(argv[1], argv[2])
        return 0
    if len(argv) not in (1, 2) or not argv[0].isdigit():
        print("usage: python -m distkeras_tpu_torch.dryrun N [cpu]",
              file=sys.stderr)
        return 2
    result = dryrun_multichip(int(argv[0]), argv[1] if len(argv) > 1
                              else None)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
