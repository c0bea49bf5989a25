"""Rank processes for the port's multi-rank tests on the CPU.

A test starts its ranks once, together, as a coordinated
``job_deployment.Job`` of n local processes over gloo (:class:`Ranks`):
each runs this file as a script, joins the group through
``job_deployment.initialize_from_env``, runs the cases of a JSON spec and
pickles its results under the test's ``tmp_path``.  A rank that raises
writes its traceback and leaves at once, so that its peers' collectives
fail rather than wait; the parent waits for every rank under one
timeout and kills them all when it runs out.

The cases:
- ``collectives``: every collective of ``parallel/collective.py`` on a
  mesh of CPU ranks, forward and backward against a seeded cotangent
  (:func:`op_inputs`, :func:`cotangent`: the tests rebuild both);
- ``lm``: ``ParallelTransformerLM`` from a numpy tree (:func:`lm_tree`):
  the step-1 loss and its gradients reduced by the train step's rule and
  gathered, then the losses of three Adam steps;
- ``pipeline``: the schedules of ``parallel/pipeline.py`` on toy
  ``tanh(h @ w)`` stages over a ('stage',) mesh (:func:`toy_inputs`):
  ``pipeline_apply``'s output and gradients against a seeded cotangent,
  or ``pipeline_1f1b``'s loss and gradients;
- ``pp_lm``: ``PipelineTransformerLM`` from a numpy tree, as ``lm``
  (and, with ``roundtrip``, the tree loaded and gathered back);
- ``zero``: a ``ParallelTransformerLM`` or ``PipelineTransformerLM`` run
  of a few steps under each of the plain step, ZeRO-1 and FSDP: the
  losses, the moments' and the parameters' local shapes and the
  gathered final parameters;
- ``spmd``: the SPMD engine on a worker mesh of the ranks, an epoch of
  each algorithm from a numpy weight set (:func:`engine_model`,
  :func:`engine_optimizer`): the losses, the center, this rank's worker
  and every worker gathered; with ``modes`` also ``run_round`` round by
  round and ``run_epoch_streaming`` through ``prefetch_to_device(
  shardings=)``; ``spmd_packed`` the same for the packed engine over a
  tiny RoPE LM (:func:`packed_setup`);
- ``place``: ``put_replicated``, ``put_worker_sharded`` and
  ``prefetch_to_device(shardings=)`` of the spec's arrays;
- ``trainers``: the distributed trainers on the ranks' mesh (histories,
  returned weights, metrics), checkpoints written for and resumed from
  another process, early stopping;
- ``predict``: ``ModelPredictor`` with ``mesh=`` the ranks' mesh and with
  no mesh inside the group;
- ``dryrun``: the ranks' part of ``dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: the collectives each case runs: (name, op, axes, keywords, the output
#: every rank of the axes holds alike)
ONE_AXIS_OPS = (
    ("psum", "psum", ("x",), {}, True),
    ("pmean", "pmean", ("x",), {}, True),
    ("pvary", "pvary", ("x",), {}, False),
    ("all_gather0", "all_gather", ("x",), {"axis": 0}, True),
    ("all_gather1", "all_gather", ("x",), {"axis": 1}, True),
    ("all_to_all01", "all_to_all", ("x",), {"split_axis": 0,
                                            "concat_axis": 1}, False),
    ("all_to_all10", "all_to_all", ("x",), {"split_axis": 1,
                                            "concat_axis": 0}, False),
    ("all_to_all00", "all_to_all", ("x",), {"split_axis": 0,
                                            "concat_axis": 0}, False),
    ("ppermute_ring", "ppermute", ("x",), {"shift": -1}, False),
    ("ppermute_one", "ppermute", ("x",), {"pairs": [[0, 1]]}, False),
)
TWO_AXIS_OPS = (
    ("psum_a", "psum", ("a",), {}, True),
    ("psum_b", "psum", ("b",), {}, True),
    ("psum_ab", "psum", ("a", "b"), {}, True),
    ("pmean_ab", "pmean", ("a", "b"), {}, True),
    ("pvary_b", "pvary", ("b",), {}, False),
    ("all_gather_b", "all_gather", ("b",), {"axis": 1}, True),
    ("all_to_all_a", "all_to_all", ("a",), {"split_axis": 1,
                                            "concat_axis": 0}, False),
    ("ppermute_b", "ppermute", ("b",), {"shift": 1}, False),
)
SHAPE = (4, 8)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def perm_of(kw, n):
    if "pairs" in kw:
        return [tuple(p) for p in kw["pairs"]]
    return [(i, (i + kw["shift"]) % n) for i in range(n)]


def group_key(coords, axis_names, axes):
    """The coordinates that name a rank's group over ``axes``."""
    return tuple(c for a, c in zip(axis_names, coords) if a not in axes)


def op_inputs(name, rank, coords, axis_names, axes, replicated_in):
    """A rank's input to collective ``name``: the same on every rank of
    the group where the op takes a value every rank holds (``pvary``)."""
    key = (group_key(coords, axis_names, axes) if replicated_in
           else (rank,))
    seed = [sum(map(ord, name)), 1, *key]
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


def cotangent(name, rank, coords, axis_names, axes, same, shape):
    key = group_key(coords, axis_names, axes) if same else (rank,)
    seed = [sum(map(ord, name)), 2, *key]
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def lm_tree(shapes, seed):
    """Weights for every leaf of ``shapes`` (name → full shape), drawn
    with numpy by the JAX init's rules, LayerNorm scales and biases
    perturbed so their gradients are not those of ones and zeros; the
    JAX tree's layout (a list of layers for ``layers.{i}.{leaf}``
    names, a dict of stacked leaves for ``layers.{leaf}``)."""
    from distkeras_tpu_torch.parallel.transformer import _tree_of
    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        z = rng.standard_normal(shape)
        if leaf.startswith("ln"):
            z = 1.0 + 0.1 * z
        elif leaf.startswith("b"):
            z = 0.1 * z
        elif leaf in ("embed", "pos"):
            z = 0.02 * z
        else:
            z = z / np.sqrt(shape[-2])
        flat[name] = z.astype(np.float32)
    return _tree_of(flat)


def toy_inputs(case):
    """A ``pipeline`` case's inputs, the same on every rank and in the
    test: stage weights (n, d, d), microbatches and labels (M, b, d), the
    head's scale and ``pipeline_apply``'s output cotangent."""
    rng = np.random.default_rng(case["seed"])
    n, m, b, d = case["n"], case["m"], case["micro_b"], case["d"]
    f32 = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)
                                     ).astype(np.float32)
    return {"ws": f32(n, d, d, scale=0.3), "x": f32(m, b, d),
            "labels": f32(m, b, d), "scale": np.float32(1.5),
            "ct": f32(m, b, d)}


def toy_stage(w, h):
    return (h @ w).tanh()


def toy_head_loss(hp, y, lbl):
    return ((hp["scale"] * y - lbl) ** 2).sum()


def lm_batch(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    v = cfg["vocab_size"]
    toks = rng.integers(0, v, (batch, cfg["seq_len"])).astype(np.int32)
    return toks, (toks + 1) % v


class Ranks:
    """n ranks over gloo, started at once as a coordinated ``Job`` that
    runs the cases of ``spec``; :meth:`results` waits for them."""

    def __init__(self, n, spec, tmp_path, timeout=120.0):
        from distkeras_tpu_torch.job_deployment import Job, LocalJobRunner
        self.n, self.out = n, Path(tmp_path)
        self.out.mkdir(parents=True, exist_ok=True)
        spec_path = self.out / "spec.json"
        spec_path.write_text(json.dumps(spec))
        env = {"OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")])}
        self.job = Job("ranks", __file__, args=[str(spec_path),
                                                str(self.out)],
                       hosts=["127.0.0.1"] * n, env=env,
                       coordinator_port=free_port(), backend="gloo")
        self.deadline = time.monotonic() + timeout
        self.job.run(LocalJobRunner(), wait=False)
        self._results = None

    def results(self):
        if self._results is not None:
            return self._results
        codes = []
        try:
            for p in self.job.processes:
                left = max(self.deadline - time.monotonic(), 0.1)
                codes.append(p.wait(timeout=left))
        except subprocess.TimeoutExpired:
            for p in self.job.processes:
                p.kill()
                p.wait()
            raise AssertionError(f"{self.n} ranks did not finish in time")
        errs = [f.read_text() for f in sorted(self.out.glob("rank*.err"))]
        assert codes == [0] * self.n and not errs, (codes, errs)
        self._results = [pickle.loads((self.out / f"rank{r}.pkl")
                                      .read_bytes()) for r in range(self.n)]
        return self._results


# -- inside a rank ---------------------------------------------------------------
def _collectives(case, rank):
    import torch
    from distkeras_tpu_torch.parallel import Mesh, collective
    shape, names = tuple(case["shape"]), tuple(case["axis_names"])
    mesh = Mesh(np.array(["cpu"] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)
    ops = ONE_AXIS_OPS if len(names) == 1 else TWO_AXIS_OPS
    out = {"coords": mesh.coords, "rank": mesh.rank,
           "axis_index": {a: mesh.axis_index(a) for a in names}}
    for name, op, axes, kw, same in ops:
        x = torch.from_numpy(op_inputs(name, rank, mesh.coords, names, axes,
                                       op == "pvary")).requires_grad_()
        if op == "ppermute":
            y = collective.ppermute(x, axes[0],
                                    perm_of(kw, mesh.shape[axes[0]]), mesh)
        elif op in ("all_gather", "all_to_all"):
            y = getattr(collective, op)(x, axes[0], mesh=mesh, **kw)
        else:
            y = getattr(collective, op)(x, axes, mesh)
        c = torch.from_numpy(cotangent(name, rank, mesh.coords, names,
                                       axes, same, tuple(y.shape)))
        g, = torch.autograd.grad((y * c).sum(), x)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


def _lm(case, rank):
    import torch
    from distkeras_tpu_torch.core import optimizers
    from distkeras_tpu_torch.parallel import (Mesh, ParallelTransformerLM,
                                              gather_params, load_jax_params)
    from distkeras_tpu_torch.parallel.train_step import reduce_grads
    shape, cfg = tuple(case["shape"]), case["cfg"]
    mesh = Mesh(np.array(["cpu"] * int(np.prod(shape)),
                         dtype=object).reshape(shape))
    lm = ParallelTransformerLM(**cfg, mesh=mesh, compute_dtype="float32")
    tree = lm_tree(lm._shapes(), case["seed"])
    toks, labels = lm_batch(cfg, case["batch"], case["seed"] + 1)
    toks, labels = lm.shard_batch(toks), lm.shard_batch(labels)
    params = load_jax_params(lm, tree)
    loss = lm._loss(params, toks, labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    axes = lm.grad_axes()
    grads = reduce_grads(list(grads), [axes[n] for n in params], mesh)
    with torch.no_grad():
        _, stats = lm._forward(params, toks)
    out = {"loss": loss.item(), "coords": mesh.coords,
           "grads": gather_params(lm, dict(zip(params, grads))),
           "dropped": [float(s["dropped"]) for s in stats],
           "local_shapes": {n: tuple(p.shape) for n, p in params.items()}}
    params = load_jax_params(lm, tree)
    opt_state, step = lm.compile_train_step(
        optimizers.adam(case["lr"], eps=1e-4), params)
    losses = []
    for _ in range(case["steps"]):
        params, opt_state, loss = step(params, opt_state, toks, labels)
        losses.append(float(loss))
    out["losses"] = losses
    return out


def _cpu_mesh(shape, names):
    from distkeras_tpu_torch.parallel import Mesh
    return Mesh(np.array(["cpu"] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


def _pipeline(case, rank):
    import torch
    from distkeras_tpu_torch.parallel import pipeline_1f1b, pipeline_apply
    mesh = _cpu_mesh((case["n"],), ("stage",))
    s = mesh.axis_index("stage")
    inp = {k: torch.as_tensor(v) for k, v in toy_inputs(case).items()}
    if case["which"] == "apply":
        w = inp["ws"][s].clone().requires_grad_()
        x = inp["x"].clone().requires_grad_()
        out = pipeline_apply(toy_stage, w, x, "stage", mesh)
        dw, dx = torch.autograd.grad((out * inp["ct"]).sum(), [w, x])
        return {"stage": s, "out": out.detach().numpy(),
                "dw": dw.numpy(), "dx": dx.numpy(),
                "comm": {op: (st["calls"], st["bytes"])
                         for op, st in mesh.comm_stats.items()}}
    loss, dstage, dhead, dx = pipeline_1f1b(
        toy_stage, inp["ws"][s], inp["x"], inp["labels"], toy_head_loss,
        {"scale": inp["scale"]}, "stage", mesh)
    return {"stage": s, "loss": float(loss), "dw": dstage.numpy(),
            "dhead": float(dhead["scale"]), "dx": dx.numpy(),
            "comm": {op: (st["calls"], st["bytes"])
                     for op, st in mesh.comm_stats.items()}}


def _pp_lm_of(case):
    from distkeras_tpu_torch.parallel import PipelineTransformerLM
    shape = tuple(case["shape"])
    mesh = _cpu_mesh(shape, ("data", "stage", "model")[:len(shape)])
    knobs = dict(case.get("knobs", {}))
    if len(shape) == 3:
        knobs["model_axis"] = "model"
    return PipelineTransformerLM(**case["cfg"], **knobs, mesh=mesh,
                                 compute_dtype="float32")


def _pp_lm(case, rank):
    import torch
    from distkeras_tpu_torch.core import optimizers
    from distkeras_tpu_torch.parallel import gather_params, load_jax_params
    from distkeras_tpu_torch.parallel.train_step import reduce_grads
    lm = _pp_lm_of(case)
    cfg = case["cfg"]
    tree = lm_tree(lm._shapes(), case["seed"])
    toks, labels = lm_batch(cfg, case["batch"], case["seed"] + 1)
    toks, labels = lm.shard_batch(toks), lm.shard_batch(labels)
    params = load_jax_params(lm, tree)
    out = {"coords": lm.mesh.coords, "bubble": lm.bubble_fraction(),
           "local_shapes": {n: tuple(p.shape) for n, p in params.items()}}
    if case.get("roundtrip"):
        out["roundtrip"] = gather_params(lm, params)
    if lm.schedule == "1f1b":
        loss, grads = lm._local_loss_and_grads_1f1b(params, toks, labels)
    else:
        loss = lm._local_loss(params, toks, labels)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    axes = lm.grad_axes()
    grads = reduce_grads(list(grads), [axes[n] for n in params], lm.mesh)
    out["loss"] = float(loss.detach())
    out["grads"] = gather_params(lm, dict(zip(params, grads)))
    out["ppermute"] = dict(lm.mesh.comm_stats.get("ppermute", {}))
    opt_state, step = lm.compile_train_step(
        optimizers.adam(case["lr"], eps=1e-4), params)
    losses = []
    for _ in range(case["steps"]):
        params, opt_state, loss = step(params, opt_state, toks, labels)
        losses.append(float(loss))
    out["losses"] = losses
    return out


def _adam_moments(state):
    """The first moments (mu) of the ``scale_by_adam`` inside ``state``."""
    if (isinstance(state, tuple) and len(state) == 3
            and isinstance(state[0], int) and isinstance(state[1], list)):
        return state[1]
    for sub in state if isinstance(state, (tuple, list)) else ():
        found = _adam_moments(sub)
        if found is not None:
            return found
    return None


def _zero(case, rank):
    from distkeras_tpu_torch.core import optimizers
    from distkeras_tpu_torch.parallel import (ParallelTransformerLM,
                                              gather_params, load_jax_params)
    shape, cfg = tuple(case["shape"]), case["cfg"]
    if case["lm"] == "pp":
        lm = _pp_lm_of(case)
    else:
        lm = ParallelTransformerLM(**cfg, mesh=_cpu_mesh(
            shape, ("data", "seq", "model")), compute_dtype="float32")
    tree = lm_tree(lm._shapes(), case["seed"])
    toks, labels = lm_batch(cfg, case["batch"], case["seed"] + 1)
    toks, labels = lm.shard_batch(toks), lm.shard_batch(labels)
    out = {}
    for mode in case["modes"]:
        params = load_jax_params(lm, tree)
        tx = optimizers.adam(case["lr"], eps=case["eps"])
        if case.get("clip") is not None:
            tx = optimizers.chain(optimizers.clip_by_global_norm(
                case["clip"]), tx)
        opt_state, step = lm.compile_train_step(
            tx, params, zero=mode == "zero", fsdp=mode == "fsdp")
        losses = []
        for _ in range(case["steps"]):
            params, opt_state, loss = step(params, opt_state, toks, labels)
            losses.append(float(loss))
        out[mode] = {
            "losses": losses,
            "moment_shapes": [tuple(m.shape)
                              for m in _adam_moments(opt_state)],
            "param_shapes": {n: tuple(p.shape) for n, p in params.items()},
            "comm": {op: (st["calls"], st["bytes"])
                     for op, st in lm.mesh.comm_stats.items()}}
        out[mode]["final"] = gather_params(lm, params)
        lm.mesh.comm_stats.clear()
    return out


def _env(case, rank):
    import torch.distributed as dist
    import torch
    from distkeras_tpu_torch.parallel import Mesh, psum
    mesh = Mesh(np.array(["cpu"] * dist.get_world_size(), dtype=object),
                ("x",))
    total = psum(torch.tensor([float(rank + 1)]), "x", mesh)
    return {"backend": str(dist.get_backend()), "rank": dist.get_rank(),
            "world": dist.get_world_size(), "psum": float(total),
            "process_id": os.environ["DISTKERAS_TPU_PROCESS_ID"],
            "comm_stats": {op: (st["calls"], st["bytes"])
                           for op, st in mesh.comm_stats.items()},
            "modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib",
                                                     "distkeras_tpu"))}


# -- the SPMD engine, the trainers and the predictor across ranks -------------
ENGINE = dict(features=12, classes=4, rows=200, window=3, batch=8,
              lr=0.01)
ENGINE_LOSS = "categorical_crossentropy"
ENGINE_ALPHA = {"aeasgd": 0.05, "eamsgd": 0.05}
PACKED = dict(vocab_size=16, seq_len=8, d_model=8, num_heads=2,
              num_layers=1, mlp_dim=16, positional="rope",
              compute_dtype="float32")
PACKED_LOSS = "sparse_categorical_crossentropy_masked_from_logits"


def mlp_stack(m, classes, bn=False):
    """The engine tests' model in either package's layers module ``m``."""
    mid = [m.BatchNormalization()] if bn else []
    return [m.Dense(16, activation="relu"), *mid,
            m.Dense(classes, activation="softmax")]


def engine_model(case):
    from distkeras_tpu_torch.core import layers as pl
    from distkeras_tpu_torch.core.model import Sequential
    return Sequential(mlp_stack(pl, case["classes"], case.get("bn", False)),
                      input_shape=(case["features"],),
                      compute_dtype="float32", device="cpu")


def engine_optimizer(pkg, algo, bn=False):
    """The trainers' worker optimizers in package ``pkg`` (as
    tests/test_torch_spmd.py): adam, SGD for AEASGD, Nesterov SGD for
    EAMSGD, Adam at epsilon 1e-3 before BatchNormalization."""
    if algo == "aeasgd":
        return "sgd"
    if algo == "eamsgd":
        return pkg.SGD(learning_rate=0.02, momentum=0.9, nesterov=True)
    if bn:
        return pkg.Adam(learning_rate=0.01, epsilon=1e-3)
    return "adam"


def run_engine(engine, ws, x, y, n, case, modes=("epoch",), seg=None):
    """An epoch of ``engine`` from weights ``ws`` in each of ``modes``
    (``run_epoch``; ``run_round`` round by round; ``run_epoch_streaming``
    over ``round_stream``), each from a fresh state: {mode: (losses,
    state)}."""
    import torch
    from distkeras_tpu_torch.data.pipeline import round_stream
    from distkeras_tpu_torch.parallel import shape_epoch_data
    w, b = case["window"], case["batch"]
    shaped = shape_epoch_data(x, y, n, w, b, columns_seg=seg)
    if seg is None:
        (xb, yb, mb, rounds), sb = shaped, None
    else:
        xb, yb, sb, mb, rounds = shaped
    out = {}
    for mode in modes:
        state = engine.init_state(initial_params=ws)
        rngs = engine.worker_rngs(1)
        if mode == "epoch":
            state, losses = engine.run_epoch(state, xb, yb, mb, rngs, sb=sb)
            losses = losses.numpy()
        elif mode == "round":
            losses = []
            for r in range(rounds):
                state, loss = engine.run_round(
                    state, xb[r], yb[r], mb[r], rngs,
                    s=None if sb is None else sb[r])
                losses.append(loss)
            losses = torch.stack(losses).numpy()
        else:
            state, losses = engine.run_epoch_streaming(
                state, round_stream(x, y, n, w, b, seg=seg), rngs)
        out[mode] = (losses, state)
    return out


def state_arrays(state):
    """A DistState's tensors as numpy: (center, locals, round clock)."""
    arr = lambda p: {k: v.detach().numpy().copy() for k, v in p.items()}
    return arr(state.center), [arr(p) for p in state.local], state.round_idx


def _spmd(case, rank):
    from distkeras_tpu_torch.core import optimizers as popt
    from distkeras_tpu_torch.parallel import SPMDEngine, get_mesh
    import torch.distributed as dist
    n = dist.get_world_size()
    mesh = get_mesh(n, devices=["cpu"] * n)
    blob = np.load(case["data"])
    ws = [blob[f"w{i}"] for i in range(int(blob["nw"]))]
    out = {}
    for algo in case["algos"]:
        engine = SPMDEngine(engine_model(case), ENGINE_LOSS,
                            engine_optimizer(popt, algo, case["bn"]), mesh,
                            algo, case["window"], case["lr"],
                            alpha=ENGINE_ALPHA.get(algo))
        runs = run_engine(engine, ws, blob["x"], blob["y"], n, case,
                          tuple(case.get("modes", ("epoch",))))
        res = {}
        for mode, (losses, state) in runs.items():
            center, local, clock = state_arrays(state)
            res[mode] = {"losses": losses, "center": center,
                         "local": local, "round_idx": clock}
        full = engine.gather_workers(runs["epoch"][1])
        res["gathered"] = state_arrays(full)[1]
        res["gathered_counts"] = [s[0][0] for s in full.opt_state
                                  if isinstance(s[0], tuple)]
        res["workers"] = engine.workers
        res["rngs"] = engine.worker_rngs(1)
        out[algo] = res
    return out


def packed_setup(case):
    """The packed engine case's model (weights from seed 0) and corpus
    (x+1 documents packed into rows): (model, tokens, labels, segments)."""
    import torch
    from distkeras_tpu_torch.data.packing import (pack_documents,
                                                  packed_lm_labels)
    from distkeras_tpu_torch.models.zoo import transformer_lm
    model = transformer_lm(**PACKED, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(case["seed"])
    v, s = PACKED["vocab_size"], PACKED["seq_len"]
    docs = [rng.integers(0, v, rng.integers(2, s + 1)).tolist()
            for _ in range(case["docs"])]
    toks, segs = pack_documents(docs, s)
    return model, toks, packed_lm_labels(toks, segs), segs


def _spmd_packed(case, rank):
    from distkeras_tpu_torch.parallel import SPMDEngine, get_mesh
    import torch.distributed as dist
    n = dist.get_world_size()
    model, toks, labels, segs = packed_setup(case)
    engine = SPMDEngine(model, PACKED_LOSS, "adam",
                        get_mesh(n, devices=["cpu"] * n), "adag",
                        case["window"], 1e-3, packed=True)
    ws = model.get_weights()
    runs = run_engine(engine, ws, toks, labels, n, case,
                      ("epoch", "round", "stream"), seg=segs)
    return {mode: {"losses": losses, "center": state_arrays(st)[0],
                   "local": state_arrays(st)[1]}
            for mode, (losses, st) in runs.items()}


def _place(case, rank):
    import torch.distributed as dist
    from distkeras_tpu_torch.data.pipeline import prefetch_to_device
    from distkeras_tpu_torch.parallel import (get_mesh, put_replicated,
                                              put_worker_sharded,
                                              replicated, worker_sharded)
    n = dist.get_world_size()
    mesh = get_mesh(n, devices=["cpu"] * n)
    blob = np.load(case["data"])
    tree = {"a": blob["a"], "b": [blob["b"]]}
    rep = put_replicated(tree, mesh)
    shard = put_worker_sharded(tree, mesh)
    items = [(blob["a"][None].repeat(2, 0) + k, blob["c"] + k)
             for k in range(3)]
    streamed = list(prefetch_to_device(
        iter(items), shardings=(worker_sharded(mesh, 1),
                                replicated(mesh))))
    from unittest import mock
    from distkeras_tpu_torch.parallel.mesh import across_ranks, local_workers
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=1):
        default = [str(d) for d in get_mesh().devices.flat]
    return {"default_mesh": default, "across": across_ranks(mesh),
            "local_workers": local_workers(mesh),
            "replicated": {"a": rep["a"].numpy(), "b": rep["b"][0].numpy()},
            "sharded": {"a": shard["a"].numpy(),
                        "b": shard["b"][0].numpy()},
            "streamed": [(a.numpy(), c.numpy()) for a, c in streamed]}


def trainer_model(blob):
    from distkeras_tpu_torch import FittedModel, Sequential
    from distkeras_tpu_torch.core import layers as pl
    from distkeras_tpu_torch.core.model import load_jax_weights
    pm = Sequential(mlp_stack(pl, int(blob["classes"])),
                    input_shape=(int(blob["features"]),),
                    compute_dtype="float32", device="cpu")
    return FittedModel(load_jax_weights(
        pm, [blob[f"w{i}"] for i in range(int(blob["nw"]))]))


def trainer_run(name, blob, mesh, kw, resume=False, validation=None):
    """One trainer of the spec on ``mesh``: {history, weights (a list of
    members for the ensemble), metrics events, validation history}."""
    import distkeras_tpu_torch as port
    from distkeras_tpu_torch import Dataset
    t = getattr(port, name)(trainer_model(blob), mesh=mesh, **kw)
    data = Dataset({"features": blob["x"], "label_encoded": blob["y"]})
    extra = {} if validation is None else {"validation_data": validation}
    fit = t.train(data, shuffle=True, resume=resume, **extra)
    weights = ([m.get_weights() for m in fit] if isinstance(fit, list)
               else fit.get_weights())
    return {"history": list(t.get_history()), "weights": weights,
            "metrics": [e for e in t.metrics if e.get("kind") == "epoch"],
            "validation": list(getattr(t, "validation_history", [])),
            "stopped_epoch": getattr(t, "stopped_epoch", None)}


def _trainers(case, rank):
    import torch.distributed as dist
    from distkeras_tpu_torch import Dataset
    from distkeras_tpu_torch.parallel import get_mesh
    n = dist.get_world_size()
    mesh = get_mesh(n, devices=["cpu"] * n)
    blob = np.load(case["data"])
    out = {name: trainer_run(name, blob, mesh, kw)
           for name, kw in case["trainers"].items()}
    for leg, (kw, resume) in case.get("checkpoints", {}).items():
        out[leg] = trainer_run("ADAG", blob, mesh, kw, resume=resume)
    if "early" in case:
        val = Dataset({"features": blob["xv"], "label_encoded": blob["yv"]})
        out["early"] = trainer_run("ADAG", blob, mesh, case["early"],
                                   validation=val)
    return out


def _predict(case, rank):
    import torch.distributed as dist
    from distkeras_tpu_torch import Dataset, ModelPredictor
    from distkeras_tpu_torch.parallel import get_mesh
    n = dist.get_world_size()
    blob = np.load(case["data"])
    data = Dataset({"features": blob["x"]})
    out = {}
    for b in case["batch_sizes"]:
        mesh = get_mesh(n, devices=["cpu"] * n)
        p = ModelPredictor(trainer_model(blob), device="cpu", batch_size=b,
                           mesh=mesh)
        out[("mesh", b)] = p.predict(data)["prediction"]
        out[("calls", b)] = dict(mesh.comm_stats.get("all_gather", {}))
        q = ModelPredictor(trainer_model(blob), device="cpu", batch_size=b)
        out[("default", b)] = q.predict(data)["prediction"]
        out[("default_mesh", b)] = None if q.mesh is None else q.mesh.size
    if "lm" in case:
        lm, toks = predict_lm(case)
        mesh = get_mesh(n, devices=["cpu"] * n)
        out["lm"] = ModelPredictor(lm, device="cpu", batch_size=2,
                                   mesh=mesh).predict(
            Dataset({"features": toks}))["prediction"]
    return out


def predict_lm(case):
    """The predict case's tiny LM (weights from seed 0) and token rows."""
    import torch
    from distkeras_tpu_torch import FittedModel
    from distkeras_tpu_torch.models.zoo import transformer_lm
    lm = transformer_lm(**case["lm"], device="cpu",
                        compute_dtype="float32",
                        generator=torch.Generator().manual_seed(0))
    toks = np.random.default_rng(3).integers(
        0, case["lm"]["vocab_size"], (case["lm_rows"],
                                       case["lm"]["seq_len"]))
    return FittedModel(lm), toks.astype(np.int32)


def _dryrun(case, rank):
    from distkeras_tpu_torch.dryrun import _run_rank
    return _run_rank("cpu")


RUNNERS = {"collectives": _collectives, "lm": _lm, "env": _env,
           "pipeline": _pipeline, "pp_lm": _pp_lm, "zero": _zero,
           "spmd": _spmd, "spmd_packed": _spmd_packed, "place": _place,
           "trainers": _trainers, "predict": _predict, "dryrun": _dryrun}


def main(spec_path, out_dir):
    import torch
    torch.set_num_threads(1)
    out = Path(out_dir)
    rank = os.environ.get("DISTKERAS_TPU_PROCESS_ID", "?")
    try:
        from distkeras_tpu_torch.job_deployment import initialize_from_env
        initialize_from_env()
        import torch.distributed as dist
        rank = dist.get_rank()
        spec = json.loads(Path(spec_path).read_text())
        results = {c["name"]: RUNNERS[c["kind"]](c, rank)
                   for c in spec["cases"]}
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)  # closes this rank's sockets: its peers fail, not wait
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
