"""ParallelTransformerLM on one card, port of
``distkeras_tpu/parallel/transformer.py``.

The JAX class is a decoder-only LM whose one jitted train step shards the
batch over a 'data' mesh axis, the sequence over 'seq' (ring or Ulysses
attention) and heads and MLP weights over 'model' (Megatron tensor
parallelism), inside one ``shard_map``.  The JAX package benchmarks it on
a single-chip (1, 1, 1) mesh (``scripts/bench_transformer.py``), where
every collective is the identity; that is the configuration ported here.
The model is the same function: embedding, learned or RoPE positions, per
layer a pre-LN block (f32 LayerNorm with population variance, eps 1e-5,
scale only; head-parallel self-attention through the ``sp_impl``
schedule; the tanh-GELU MLP), a final LayerNorm and an f32-accumulated
head product; the loss is the token mean of the softmax cross-entropy,
through the hand-written fused kernels (``ops/fused_ce.py``) when
``fused_ce`` is set, else ``log_softmax`` and a gather.

Parameters are f32 tensors in a name → tensor dict, named after the JAX
tree's leaves (``embed``, ``head``, ``layers.{i}.{b1, b2, ln1, ln2, w1,
w2, wk, wo, wq, wv}``, ``ln_f``, ``pos``) and ordered as its leaves are;
:func:`load_jax_params` copies a JAX ``init`` output into such a dict.
MoE layers and mesh axes of more than one device raise (ROADMAP queue A
item 7); ``param_specs`` (sharding annotations) is not ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.layers import _project
from ..device import torch_dtype
from .mesh import Mesh, collective
from .tp import tp_mlp, tp_self_attention

#: a dense layer's parameters, in the JAX tree's (sorted) leaf order
LAYER_KEYS = ("b1", "b2", "ln1", "ln2", "w1", "w2", "wk", "wo", "wq", "wv")


class ParallelTransformerLM:
    """Causal LM over a ('data', 'seq', 'model') mesh of one device."""

    def __init__(self, vocab_size: int, seq_len: int, d_model: int,
                 num_heads: int, num_layers: int, mlp_dim: int, mesh: Mesh,
                 *, moe_layers: Tuple[int, ...] = (),
                 compute_dtype=torch.bfloat16, remat: bool = False,
                 ring_block_k: Optional[int] = None, sp_impl: str = "ring",
                 fused_ce: bool = False,
                 num_kv_heads: Optional[int] = None,
                 attention_window: Optional[int] = None,
                 positional: str = "learned", rope_theta: float = 10000.0,
                 rope_scale: float = 1.0, data_axis: str = "data",
                 seq_axis: str = "seq", model_axis: str = "model"):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim
        self.mesh = mesh
        self.moe_layers = tuple(moe_layers)
        self.compute_dtype = (compute_dtype
                              if isinstance(compute_dtype, torch.dtype)
                              else torch_dtype(compute_dtype))
        self.remat = bool(remat)
        self.ring_block_k = ring_block_k
        self.axes = (data_axis, seq_axis, model_axis)
        self.tp = mesh.shape[model_axis]
        self.sp = mesh.shape[seq_axis]
        self.dp = mesh.shape[data_axis]
        # the JAX class's checks, in its order
        if num_heads % self.tp:
            raise ValueError(f"num_heads {num_heads} % tp {self.tp} != 0")
        if sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be 'ring' or 'ulysses', got "
                             f"{sp_impl!r}")
        self.sp_impl = sp_impl
        self.fused_ce = bool(fused_ce)
        if sp_impl == "ulysses" and (num_heads // self.tp) % self.sp:
            raise ValueError(
                f"sp_impl='ulysses' needs local head count "
                f"{num_heads // self.tp} (num_heads/tp) divisible by sp "
                f"{self.sp}; use sp_impl='ring' for this shape")
        self.num_kv_heads = (int(num_kv_heads) if num_kv_heads is not None
                             else num_heads)
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} % num_kv_heads "
                             f"{self.num_kv_heads} != 0")
        if self.num_kv_heads % self.tp:
            raise ValueError(f"num_kv_heads {self.num_kv_heads} % tp "
                             f"{self.tp} != 0 (each model shard needs whole "
                             "kv heads)")
        from ..ops.attention import validate_window
        self.attention_window = validate_window(attention_window,
                                                causal=True)
        if positional not in ("learned", "rope"):
            raise ValueError(f"positional must be 'learned' or 'rope', "
                             f"got {positional!r}")
        self.positional = positional
        if positional == "rope":
            from ..ops.rope import validate_rope_dim, validate_rope_scaling
            validate_rope_dim(d_model // num_heads)
            self.rope_theta, self.rope_scale = validate_rope_scaling(
                rope_theta, rope_scale)
        else:
            self.rope_theta, self.rope_scale = (float(rope_theta),
                                                float(rope_scale))
        if mlp_dim % self.tp:
            raise ValueError(f"mlp_dim {mlp_dim} % tp {self.tp} != 0")
        if seq_len % self.sp:
            raise ValueError(f"seq_len {seq_len} % sp {self.sp} != 0")
        # what one card does not run yet; the MoE knobs (num_experts,
        # capacity_factor, router_top_k, router_aux_weight) come with it
        if self.moe_layers:
            raise NotImplementedError(
                "moe_layers (Switch expert parallelism, parallel/moe.py) are "
                "not ported yet (ROADMAP queue A item 7)")
        for axis in self.axes:
            collective("ParallelTransformerLM", None, axis, mesh)
        self.device = mesh.device
        self.head_dim = d_model // num_heads

    # -- params ---------------------------------------------------------------
    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's shape by name, in the JAX tree's leaf order."""
        d, f, v = self.d_model, self.mlp_dim, self.vocab_size
        hd = self.num_heads * self.head_dim
        hd_kv = self.num_kv_heads * self.head_dim
        layer = {"b1": (f,), "b2": (d,), "ln1": (d,), "ln2": (d,),
                 "w1": (d, f), "w2": (f, d), "wk": (d, hd_kv),
                 "wo": (hd, d), "wq": (d, hd), "wv": (d, hd_kv)}
        shapes = {"embed": (v, d), "head": (d, v)}
        for i in range(self.num_layers):
            shapes.update({f"layers.{i}.{k}": layer[k] for k in LAYER_KEYS})
        shapes["ln_f"] = (d,)
        if self.positional == "learned":  # rope has no additive table
            shapes["pos"] = (self.seq_len, d)
        return shapes

    def init(self, generator: torch.Generator) -> Dict[str, nn.Parameter]:
        """Fresh f32 parameters on the mesh's device, drawn from
        ``generator`` (a CPU generator), by the JAX rules: LayerNorm scales
        ones, biases zeros, ``embed``/``pos`` N(0, 0.02²), the other
        matrices N(0, 1) / sqrt(fan_in) with fan_in = ``shape[-2]``."""
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
                     / math.sqrt(max(shape[-2] if len(shape) > 1
                                     else shape[0], 1)))
            params[name] = nn.Parameter(t.to(self.device))
        return params

    # -- forward --------------------------------------------------------------
    def _ln(self, scale: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h32 = h.to(torch.float32)
        mu = h32.mean(dim=-1, keepdim=True)
        var = (h32 - mu).square().mean(dim=-1, keepdim=True)
        return ((h32 - mu) * torch.rsqrt(var + 1e-5)
                * scale).to(self.compute_dtype)

    def _block(self, x: torch.Tensor, lp: Dict[str, torch.Tensor],
               rope_pos: Optional[torch.Tensor]) -> torch.Tensor:
        _, seq_axis, model_axis = self.axes
        cdt = self.compute_dtype
        h = self._ln(lp["ln1"], x)
        attn = tp_self_attention(
            h, lp["wq"], lp["wk"], lp["wv"], lp["wo"],
            num_local_heads=self.num_heads // self.tp,
            head_dim=self.head_dim, axis_name=model_axis,
            seq_axis=seq_axis, causal=True, compute_dtype=cdt,
            ring_block_k=self.ring_block_k,
            num_local_kv_heads=self.num_kv_heads // self.tp,
            window=self.attention_window, rope_positions=rope_pos,
            sp_impl=self.sp_impl, rope_theta=self.rope_theta,
            rope_scale=self.rope_scale, mesh=self.mesh)
        x = x + attn.to(cdt)
        h = self._ln(lp["ln2"], x)
        y = tp_mlp(h, lp["w1"], lp["b1"], lp["w2"], lp["b2"],
                   axis_name=model_axis, compute_dtype=cdt, mesh=self.mesh)
        return x + y.to(cdt)

    def _forward(self, params: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, V) f32.  (The JAX method also
        returns the MoE layers' router statistics, which a dense stack
        does not have.)"""
        cdt = self.compute_dtype
        s_loc = tokens.shape[1]
        seq_idx = 0  # this device's position on the sequence axis
        x = F.embedding(tokens.long(), params["embed"].to(cdt))
        if self.positional == "learned":
            pos = params["pos"][seq_idx * s_loc:(seq_idx + 1) * s_loc]
            x = x + pos.to(cdt)
        # rope: q/k rotate inside each block, by global positions
        rope_pos = (seq_idx * s_loc + torch.arange(s_loc, device=x.device)
                    if self.positional == "rope" else None)
        for i in range(self.num_layers):
            lp = {k: params[f"layers.{i}.{k}"] for k in LAYER_KEYS}
            if self.remat:
                # recompute the block's activations in the backward instead
                # of keeping them: the long-context memory/FLOPs trade
                x = checkpoint(self._block, x, lp, rope_pos,
                               use_reentrant=False)
            else:
                x = self._block(x, lp, rope_pos)
        x = self._ln(params["ln_f"], x)
        return _project(x, params["head"], None, cdt)

    def _loss(self, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        """The token mean of the softmax cross-entropy, an f32 scalar."""
        data_axis, seq_axis, model_axis = self.axes
        logits = self._forward(params, tokens)
        if self.fused_ce:
            from ..ops.fused_ce import fused_softmax_cross_entropy
            losses = fused_softmax_cross_entropy(
                logits.reshape(-1, self.vocab_size), labels.reshape(-1))
            local_sum = losses.sum()
        else:
            logp = torch.log_softmax(logits, dim=-1)
            picked = logp.gather(-1, labels.long()[..., None])[..., 0]
            local_sum = -picked.sum()
        count = float(labels.numel())
        total = collective("psum", local_sum, (data_axis, seq_axis),
                           self.mesh)
        return collective("pmean", total / count, model_axis, self.mesh)

    # -- train step -----------------------------------------------------------
    def compile_train_step(self, optimizer, params: Dict[str, torch.Tensor],
                           zero: bool = False, fsdp: bool = False):
        """(opt_state, step): ``step(params, opt_state, tokens, labels) ->
        (params, opt_state, loss)``, with ``optimizer`` a
        ``core.optimizers.Transform`` (``core.optimizers.adam`` for
        ``optax.adam``), tokens and labels (B, S) integer tensors on
        :meth:`batch_sharding`'s device, and the parameters updated in
        place.  ``zero``/``fsdp`` shard the optimizer state (and the
        parameters) over the data axis, which on one card changes nothing."""
        from .train_step import build_train_step
        data_axis = self.axes[0]
        return build_train_step(self.mesh, self._loss, optimizer, params,
                                zero_axis=data_axis if zero else None,
                                fsdp_axis=data_axis if fsdp else None)

    def batch_sharding(self) -> torch.device:
        """Where a batch goes: the mesh's one device."""
        return self.device


def _jax_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) of a nested dict/list tree, named ``a.0.b`` and
    ordered as JAX flattens it (dict keys sorted)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _jax_leaves(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _jax_leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def load_jax_params(lm: ParallelTransformerLM,
                    tree: Any) -> Dict[str, nn.Parameter]:
    """The JAX ``ParallelTransformerLM.init`` output, as nested dicts and
    lists of arrays (``jax.device_get(params)``), as the port's parameter
    dict: f32 tensors on ``lm``'s device.  Every name and every shape is
    checked against ``lm``."""
    given = dict(_jax_leaves(tree))
    shapes = lm._shapes()
    missing = sorted(set(shapes) - set(given))
    extra = sorted(set(given) - set(shapes))
    if missing or extra:
        raise ValueError(f"parameter names differ from the model's: "
                         f"missing {missing}, unexpected {extra}")
    params = {}
    for name, shape in shapes.items():
        arr = np.asarray(given[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"parameter {name}: shape {arr.shape} does not "
                             f"match the model's {shape}")
        params[name] = nn.Parameter(torch.tensor(arr, device=lm.device))
    return params
