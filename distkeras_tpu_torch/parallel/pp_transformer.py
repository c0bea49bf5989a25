"""PipelineTransformerLM across ranks, port of
``distkeras_tpu/parallel/pp_transformer.py``.

A decoder-only causal LM over a ('data', 'stage') mesh, or ('data',
'stage', 'model') with Megatron tensor parallelism inside each stage:
the batch is split over 'data', the layer stack into ``mesh.shape
['stage']`` pipeline stages (each stage's layers stacked, ``(n, lps,
...)`` leaves sliced on their first dim), and microbatches stream
through the stages by ``pipeline.py``'s GPipe schedule (``schedule=
'gpipe'``) or its one-forward-one-backward train step (``'1f1b'``).
Each mesh position is a rank of a ``torch.distributed`` group
(``mesh.py``); a mesh of one device needs no group.

The model is the JAX class's function: a learned token and position
embedding, per layer a pre-LN block (f32 LayerNorm with population
variance, eps 1e-5, scale only; causal multi-head self-attention through
the ``ops.attention`` dispatcher, the flash kernels on the card; the
tanh-GELU MLP with ``b1`` added in f32), a final LayerNorm, an
f32-accumulated head and ``log_softmax`` over f32 logits; the loss is
the token mean over the whole batch.  Projections round their operands
to ``compute_dtype`` and accumulate in f32.

The embedding runs on every stage (stage 0's feeds the pipe) and the
head on the last stage only; a non-last stage's loss is a zero that
still ends in its pipeline, so that every rank takes the pipeline's
backward, whose transfers pair with its neighbours'.  Gradients are
summed by :meth:`grad_axes`: ``embed``, ``pos``, ``ln_f`` and ``head``
over ('data', 'stage'), since each is replicated and only stage 0 or
the last stage holds a real part; the stage-sharded layer leaves over
'data' only.  Under tp the Megatron pair hands every model rank the
whole gradient of the leaves it replicates (``ln1``, ``ln2``, ``b2``).

Parameters are f32 tensors in a name → tensor dict, named after the JAX
tree's sorted leaves (``embed``, ``head``, ``layers.{b1, b2, ln1, ln2,
w1, w2, wk, wo, wq, wv}``, ``ln_f``, ``pos``); ``transformer.
load_jax_params`` slices a full JAX tree into them and ``transformer.
gather_params`` puts them back together, for this class as for
``ParallelTransformerLM``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.layers import _project
from ..device import torch_dtype
from .collective import psum
from .mesh import Mesh
from .pipeline import pipeline_1f1b, pipeline_apply
from .tp import tp_mlp, tp_self_attention
from .transformer import LAYER_KEYS, local_slice


class PipelineTransformerLM:
    """Causal LM over a ('data', 'stage'[, 'model']) mesh with GPipe or
    1F1B microbatching, one rank a position."""

    def __init__(self, vocab_size: int, seq_len: int, d_model: int,
                 num_heads: int, num_layers: int, mlp_dim: int, mesh: Mesh,
                 *, num_microbatches: int = 2, compute_dtype=torch.bfloat16,
                 remat: bool = False, schedule: str = "gpipe",
                 data_axis: str = "data", stage_axis: str = "stage",
                 model_axis: Optional[str] = None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim
        self.mesh = mesh
        self.num_microbatches = int(num_microbatches)
        self.compute_dtype = (compute_dtype
                              if isinstance(compute_dtype, torch.dtype)
                              else torch_dtype(compute_dtype))
        # remat: each tick's stage compute recomputed in its backward
        self.remat = bool(remat)
        # the JAX class's checks, in its order
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule must be 'gpipe' or '1f1b', "
                             f"got {schedule!r}")
        self.schedule = schedule
        self.data_axis = data_axis
        self.stage_axis = stage_axis
        self.model_axis = model_axis
        self.tp = mesh.shape[model_axis] if model_axis is not None else 1
        self.n_stages = mesh.shape[stage_axis]
        self.dp = mesh.shape[data_axis]
        if num_layers % self.n_stages:
            raise ValueError(
                f"num_layers {num_layers} % stages {self.n_stages} != 0")
        self.layers_per_stage = num_layers // self.n_stages
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} % heads {num_heads} != 0")
        if num_heads % self.tp:
            raise ValueError(f"num_heads {num_heads} % tp {self.tp} != 0")
        if mlp_dim % self.tp:
            raise ValueError(f"mlp_dim {mlp_dim} % tp {self.tp} != 0")
        self.head_dim = d_model // num_heads

    @property
    def device(self) -> torch.device:
        """This rank's device (binds a mesh of ranks to its group)."""
        return self.mesh.device

    # -- params ---------------------------------------------------------------
    def _layer_leaf_shapes(self) -> Dict[str, Tuple[int, ...]]:
        d, f = self.d_model, self.mlp_dim
        return {"ln1": (d,), "ln2": (d,),
                "wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
                "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's full shape by name, in the JAX tree's leaf
        order (the layer leaves stacked (n_stages, layers_per_stage,
        ...))."""
        d, v = self.d_model, self.vocab_size
        stack = (self.n_stages, self.layers_per_stage)
        leaf = self._layer_leaf_shapes()
        out = {"embed": (v, d), "head": (d, v)}
        out.update({f"layers.{k}": stack + leaf[k] for k in LAYER_KEYS})
        out.update({"ln_f": (d,), "pos": (self.seq_len, d)})
        return out

    def param_specs(self) -> Dict[str, Tuple]:
        """Every parameter's ``PartitionSpec`` as a plain tuple, by name
        in leaf order: the layer leaves on the stage axis and, under
        ``model_axis``, Megatron's splits on top (qkv, ``w1`` and ``b1``
        by column, ``wo`` and ``w2`` by row; ``ln1``, ``ln2`` and ``b2``
        replicated over model); the rest replicated."""
        st, md = self.stage_axis, self.model_axis
        split = {"wq": "col", "wk": "col", "wv": "col", "w1": "col",
                 "b1": "col", "wo": "row", "w2": "row"}
        to_spec = {("col", 2): (st, None, None, md),   # (n, lps, in, out)
                   ("col", 1): (st, None, md),         # (n, lps, out)
                   ("row", 2): (st, None, md, None)}
        shapes = self._layer_leaf_shapes()
        specs = {"embed": (), "head": ()}
        for k in LAYER_KEYS:
            specs[f"layers.{k}"] = ((st,) if md is None else to_spec.get(
                (split.get(k), len(shapes[k])), (st,)))
        specs.update({"ln_f": (), "pos": ()})
        return specs

    def _local_slice(self, name: str, full: Tuple[int, ...]):
        """This rank's index into the full leaf ``name``."""
        return local_slice(self.param_specs()[name], full, self.mesh)

    def grad_axes(self) -> Dict[str, Tuple[str, ...]]:
        """The axes over which each parameter's gradient is summed (the
        module docstring)."""
        both = (self.data_axis, self.stage_axis)
        return {n: ((self.data_axis,) if n.startswith("layers.") else both)
                for n in self._shapes()}

    def init(self, generator: torch.Generator) -> Dict[str, nn.Parameter]:
        """Fresh f32 parameters on this rank's device, each drawn whole
        from ``generator`` (a CPU generator) by the JAX rules and cut to
        this rank's shard: LayerNorm scales ones, biases zeros, ``embed``/
        ``pos`` N(0, 0.02²), the other matrices N(0, 1) / sqrt(fan_in)
        with fan_in = ``shape[-2]``."""
        params = {}
        for name, shape in self._shapes().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("ln"):
                t = torch.ones(shape)
            elif leaf.startswith("b"):
                t = torch.zeros(shape)
            elif leaf in ("embed", "pos"):
                t = 0.02 * torch.randn(shape, generator=generator)
            else:
                t = (torch.randn(shape, generator=generator)
                     / math.sqrt(max(shape[-2], 1)))
            t = t[self._local_slice(name, shape)].contiguous()
            params[name] = nn.Parameter(t.to(self.device))
        return params

    # -- the per-layer block --------------------------------------------------
    def _ln(self, scale: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h32 = h.to(torch.float32)
        mu = h32.mean(dim=-1, keepdim=True)
        var = (h32 - mu).square().mean(dim=-1, keepdim=True)
        return ((h32 - mu) * torch.rsqrt(var + 1e-5)
                * scale).to(self.compute_dtype)

    def _block(self, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
        """One pre-LN transformer block on (B, S, D), the full width."""
        from ..ops.attention import attention
        cdt = self.compute_dtype
        b, s, d = x.shape
        h = self._ln(lp["ln1"], x)

        def proj(wname):
            y = _project(h, lp[wname], None, cdt).to(cdt)
            return y.reshape(b, s, self.num_heads, self.head_dim)

        attn = attention(proj("wq"), proj("wk"), proj("wv"), causal=True)
        attn = _project(attn.reshape(b, s, d), lp["wo"], None, cdt)
        x = x + attn.to(cdt)
        h = self._ln(lp["ln2"], x)
        y = _project(h, lp["w1"], lp["b1"], cdt)
        y = F.gelu(y, approximate="tanh").to(cdt)
        y = _project(y, lp["w2"], lp["b2"], cdt)
        return x + y.to(cdt)

    def _block_tp(self, lp: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
        """The same block with Megatron tensor parallelism over
        ``model_axis``: ``lp`` holds this rank's slices."""
        cdt = self.compute_dtype
        h = self._ln(lp["ln1"], x)
        attn = tp_self_attention(
            h, lp["wq"], lp["wk"], lp["wv"], lp["wo"],
            num_local_heads=self.num_heads // self.tp,
            head_dim=self.head_dim, axis_name=self.model_axis,
            causal=True, compute_dtype=cdt, mesh=self.mesh)
        x = x + attn.to(cdt)
        h = self._ln(lp["ln2"], x)
        y = tp_mlp(h, lp["w1"], lp["b1"], lp["w2"], lp["b2"],
                   axis_name=self.model_axis, compute_dtype=cdt,
                   mesh=self.mesh)
        return x + y.to(cdt)

    def _stage_fn(self, stage_layers: Dict[str, torch.Tensor],
                  x: torch.Tensor, tp: bool = False) -> torch.Tensor:
        """This stage's ``layers_per_stage`` blocks over the stacked
        (lps, ...) leaves, shape-preserving; ``tp=True`` the
        tensor-parallel block on this rank's slices."""
        block = self._block_tp if tp else self._block
        for i in range(next(iter(stage_layers.values())).shape[0]):
            x = block({k: v[i] for k, v in stage_layers.items()}, x)
        return x

    # -- forward/loss ---------------------------------------------------------
    def _embed(self, params: Dict[str, torch.Tensor],
               tokens: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        x = F.embedding(tokens.long(), params["embed"].to(cdt))
        return x + params["pos"].to(cdt)[None, :tokens.shape[1]]

    def _head_loss(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                   labels: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """(the loss SUM over ``x``'s tokens, the token count)."""
        x = self._ln(params["ln_f"], x)
        logits = _project(x, params["head"], None, self.compute_dtype)
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, labels.long()[..., None])[..., 0]
        return -picked.sum(), float(picked.numel())

    def _microbatch_prologue(self, params: Dict[str, torch.Tensor],
                             tokens: torch.Tensor):
        """The batch-divisibility check, this rank's stage slice of the
        stacked layer leaves ((1, lps, ...) → (lps, ...)), and the
        (optionally remat'd) shape-preserving stage program."""
        m = self.num_microbatches
        b_loc = tokens.shape[0]
        if b_loc % m:
            raise ValueError(
                f"local batch {b_loc} % microbatches {m} != 0")
        stage_layers = {k: params[f"layers.{k}"][0] for k in LAYER_KEYS}

        def stage(sp, h):
            return self._stage_fn(sp, h.to(self.compute_dtype),
                                  tp=self.tp > 1)

        if self.remat:
            return m, b_loc, stage_layers, lambda sp, h: checkpoint(
                stage, sp, h, use_reentrant=False)
        return m, b_loc, stage_layers, stage

    def _is_last(self) -> bool:
        return self.mesh.axis_index(self.stage_axis) == self.n_stages - 1

    def _local_loss(self, params: Dict[str, torch.Tensor],
                    tokens: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
        """The GPipe loss: the global token mean, an f32 scalar that every
        rank holds; its gradient flows back through the pipeline."""
        m, b_loc, stage_layers, stage = self._microbatch_prologue(params,
                                                                  tokens)
        x = self._embed(params, tokens)                  # (B_loc, S, D)
        micro = x.reshape((m, b_loc // m) + x.shape[1:])
        out = pipeline_apply(stage, stage_layers, micro,
                             axis_name=self.stage_axis, mesh=self.mesh)
        if self._is_last():
            x = out.reshape((b_loc,) + x.shape[1:]).to(self.compute_dtype)
            local_sum, _ = self._head_loss(params, x, labels)
        else:  # the outputs are zeros here: a zero that keeps the pipe
            local_sum = out.sum() * 0.0
        total = psum(local_sum, (self.data_axis, self.stage_axis),
                     self.mesh)
        # the token count is static: b_loc·S per data shard
        return total / float(self.dp * b_loc * tokens.shape[1])

    def _local_loss_and_grads_1f1b(self, params: Dict[str, torch.Tensor],
                                   tokens: torch.Tensor,
                                   labels: torch.Tensor):
        """(loss, gradients in the order of ``params``) by the 1F1B
        schedule, before the ``grad_axes`` sums: the layer gradients from
        ``pipeline_1f1b``, the head's real on the last stage, the
        embedding's from stage 0's input cotangent; all divided by the
        token count (the schedule's are of the loss SUM)."""
        m, b_loc, stage_layers, stage = self._microbatch_prologue(params,
                                                                  tokens)
        s_len = tokens.shape[1]
        embed = {k: params[k].detach().requires_grad_()
                 for k in ("embed", "pos")}
        with torch.enable_grad():
            x = self._embed(embed, tokens)
        micro = x.detach().reshape((m, b_loc // m) + x.shape[1:])
        labels_micro = labels.reshape(m, b_loc // m, s_len)
        loss_sum, dstage, dhead, dx_micro = pipeline_1f1b(
            stage, stage_layers, micro, labels_micro,
            lambda hp, y, lbl: self._head_loss(hp, y, lbl)[0],
            {"ln_f": params["ln_f"], "head": params["head"]},
            axis_name=self.stage_axis, mesh=self.mesh)
        count = float(self.dp * b_loc * s_len)
        loss = psum(loss_sum, (self.data_axis, self.stage_axis),
                    self.mesh) / count
        if self.mesh.axis_index(self.stage_axis) == 0:
            dembed = dict(zip(embed, torch.autograd.grad(
                x, list(embed.values()),
                dx_micro.reshape(x.shape).to(x.dtype))))
        else:  # the embedding's cotangent is real on stage 0 only
            dembed = {k: torch.zeros_like(v) for k, v in embed.items()}
        grads = {**dembed, **dhead,
                 **{f"layers.{k}": g[None] for k, g in dstage.items()}}
        return loss, [grads[n] / count for n in params]

    def reference_forward_loss(self, params: Dict[str, torch.Tensor],
                               tokens: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
        """The same math with no mesh on the full (n, lps, ...) leaves:
        the stages applied in turn on one device, the oracle of the
        pipelined step."""
        x = self._embed(params, tokens)
        for st in range(self.n_stages):
            x = self._stage_fn({k: params[f"layers.{k}"][st]
                                for k in LAYER_KEYS}, x)
        local_sum, count = self._head_loss(params, x.to(self.compute_dtype),
                                           labels)
        return local_sum / count

    # -- train step -----------------------------------------------------------
    def compile_train_step(self, optimizer, params: Dict[str, torch.Tensor],
                           zero: bool = False, fsdp: bool = False):
        """(opt_state, step): ``step(params, opt_state, tokens, labels) ->
        (params, opt_state, loss)``, tokens and labels this rank's
        (B/dp, S) block (:meth:`shard_batch`), the parameters updated in
        place.  ``schedule='1f1b'`` takes the gradients from the 1F1B
        schedule; ``zero=True`` slices the optimizer state over the data
        axis (ZeRO-1), ``fsdp=True`` the parameters too (see
        ``train_step.build_train_step``)."""
        from .train_step import build_train_step
        return build_train_step(
            self.mesh, self._local_loss, optimizer, params,
            zero_axis=self.data_axis if zero else None,
            fsdp_axis=self.data_axis if fsdp else None,
            grad_axes=self.grad_axes(), param_specs=self.param_specs(),
            loss_and_grads=(self._local_loss_and_grads_1f1b
                            if self.schedule == "1f1b" else None))

    def batch_sharding(self) -> torch.device:
        """Where this rank's batch goes: its device."""
        return self.device

    def shard_batch(self, batch) -> torch.Tensor:
        """A global (B, S) batch (numpy or tensor) → this rank's (B/dp, S)
        rows on its device, the block that JAX's ``P('data')`` gives the
        same mesh position."""
        t = torch.as_tensor(batch)
        if t.shape[0] % self.dp:
            raise ValueError(f"batch {tuple(t.shape)} does not split over "
                             f"dp={self.dp}")
        rows = t.shape[0] // self.dp
        i = self.mesh.axis_index(self.data_axis)
        return t[i * rows:(i + 1) * rows].contiguous().to(self.device)

    def bubble_fraction(self) -> float:
        """The analytic fill/drain bubble of this schedule: GPipe
        ``(n-1)/(M+n-1)``; 1F1B ``2(n-1)/(M+2(n-1))``."""
        m, n = self.num_microbatches, self.n_stages
        if self.schedule == "1f1b":
            return 2 * (n - 1) / (m + 2 * (n - 1))
        return (n - 1) / (m + n - 1)


__all__: List[Any] = ["PipelineTransformerLM"]
