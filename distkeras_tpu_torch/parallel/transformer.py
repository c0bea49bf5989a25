"""ParallelTransformerLM across ranks, port of
``distkeras_tpu/parallel/transformer.py``.

The JAX class is a decoder-only LM whose one jitted train step shards the
batch over a 'data' mesh axis, the sequence over 'seq' (ring or Ulysses
attention) and heads, MLP weights and Switch experts over 'model'
(Megatron tensor parallelism, ``moe.py``), inside one ``shard_map``.  The
port runs each mesh position as a rank of a ``torch.distributed`` group
(``mesh.py``): every rank holds its shard of every parameter and runs the
local forward with the collectives of ``collective.py``; a mesh of one
device needs no group, and every collective is then the identity.  The
model is the same function: embedding, learned or RoPE positions (sliced
and rotated at this rank's global sequence offset), per layer a pre-LN
block (f32 LayerNorm with population variance, eps 1e-5, scale only;
head-parallel self-attention through the ``sp_impl`` schedule; the
tanh-GELU MLP, or on ``moe_layers`` the expert-parallel MoE MLP), a final
LayerNorm and an f32-accumulated head product; the loss is the global
token mean of the softmax cross-entropy, through the hand-written fused
kernels (``ops/fused_ce.py``) when ``fused_ce`` is set, else
``log_softmax`` and a gather, plus the weighted Switch load-balance term
of each MoE layer over router statistics averaged across every rank.

Parameters are f32 tensors in a name → tensor dict, named after the JAX
tree's leaves (``embed``, ``head``, ``layers.{i}.{b1, b2, ln1, ln2,
[router,] w1, w2, wk, wo, wq, wv}``, ``ln_f``, ``pos``) and ordered as its
leaves are, each this rank's shard under :meth:`param_specs`;
:func:`load_jax_params` slices a full JAX tree into them and
:func:`gather_params` puts shards (or gradients) back together.  Every
parameter's gradient is summed over the axes in :meth:`grad_axes` by the
train step (see ``collective.py`` for why).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.layers import _project
from ..device import torch_dtype
from .collective import gather_leaf, pmean, psum
from .mesh import Mesh
from .moe import load_balance_loss, moe_mlp
from .tp import tp_mlp, tp_self_attention

#: a dense layer's parameters, in the JAX tree's (sorted) leaf order
LAYER_KEYS = ("b1", "b2", "ln1", "ln2", "w1", "w2", "wk", "wo", "wq", "wv")
#: an MoE layer's parameters, in the JAX tree's (sorted) leaf order
MOE_LAYER_KEYS = ("b1", "b2", "ln1", "ln2", "router", "w1", "w2", "wk",
                  "wo", "wq", "wv")


def local_slice(spec: Tuple, full: Tuple[int, ...], mesh: Mesh):
    """This rank's index into a leaf of shape ``full`` under ``spec``."""
    index = []
    for dim, size in enumerate(full):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            index.append(slice(None))
            continue
        part = size // mesh.shape[axis]
        start = mesh.axis_index(axis) * part
        index.append(slice(start, start + part))
    return tuple(index)


class ParallelTransformerLM:
    """Causal LM over a ('data', 'seq', 'model') mesh, one rank a
    position."""

    def __init__(self, vocab_size: int, seq_len: int, d_model: int,
                 num_heads: int, num_layers: int, mlp_dim: int, mesh: Mesh,
                 *, moe_layers: Tuple[int, ...] = (),
                 num_experts: Optional[int] = None,
                 capacity_factor: float = 2.0, router_top_k: int = 1,
                 router_aux_weight: float = 1e-2,
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
        self.capacity_factor = capacity_factor
        self.router_top_k = int(router_top_k)
        self.router_aux_weight = float(router_aux_weight)
        self.compute_dtype = (compute_dtype
                              if isinstance(compute_dtype, torch.dtype)
                              else torch_dtype(compute_dtype))
        self.remat = bool(remat)
        self.ring_block_k = ring_block_k
        self.axes = (data_axis, seq_axis, model_axis)
        self.data_axis = data_axis
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
        self.num_experts = (num_experts if num_experts is not None
                            else self.tp)
        if self.moe_layers and self.num_experts % self.tp:
            raise ValueError("num_experts must divide over the model axis")
        self.device = mesh.device  # this rank's (binds a mesh of ranks)
        self.head_dim = d_model // num_heads

    # -- params ---------------------------------------------------------------
    def _layer_shapes(self, i: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                       Tuple]]:
        """Layer ``i``'s (shape, spec) by leaf, in the JAX tree's order."""
        d, f = self.d_model, self.mlp_dim
        hd = self.num_heads * self.head_dim
        hd_kv = self.num_kv_heads * self.head_dim
        model = self.axes[2]
        shapes = {"ln1": ((d,), ()), "ln2": ((d,), ()),
                  "wq": ((d, hd), (None, model)),
                  "wk": ((d, hd_kv), (None, model)),
                  "wv": ((d, hd_kv), (None, model)),
                  "wo": ((hd, d), (model, None))}
        if i in self.moe_layers:
            e = self.num_experts
            shapes.update({"router": ((d, e), ()),
                           "w1": ((e, d, f), (model, None, None)),
                           "b1": ((e, f), (model, None)),
                           "w2": ((e, f, d), (model, None, None)),
                           "b2": ((e, d), (model, None))})
        else:
            shapes.update({"w1": ((d, f), (None, model)),
                           "b1": ((f,), (model,)),
                           "w2": ((f, d), (model, None)),
                           "b2": ((d,), ())})
        return {k: shapes[k] for k in sorted(shapes)}

    def _shapes_and_specs(self) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
        d, v = self.d_model, self.vocab_size
        out = {"embed": ((v, d), ()), "head": ((d, v), ())}
        for i in range(self.num_layers):
            out.update({f"layers.{i}.{k}": sp for k, sp in
                        self._layer_shapes(i).items()})
        out["ln_f"] = ((d,), ())
        if self.positional == "learned":  # rope has no additive table
            out["pos"] = ((self.seq_len, d), ())
        return out

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every parameter's full shape by name, in the JAX tree's leaf
        order."""
        return {n: sp[0] for n, sp in self._shapes_and_specs().items()}

    def param_specs(self) -> Dict[str, Tuple]:
        """Every parameter's ``PartitionSpec`` as a plain tuple (one entry
        per dim: a mesh axis name or None; ``()`` replicated), by name in
        leaf order."""
        return {n: sp[1] for n, sp in self._shapes_and_specs().items()}

    def _local_slice(self, name: str, full: Tuple[int, ...]):
        """This rank's index into the full leaf ``name``."""
        return local_slice(self.param_specs()[name], full, self.mesh)

    def grad_axes(self) -> Dict[str, Tuple[str, ...]]:
        """The axes over which each parameter's gradient is summed: every
        parameter is used on this rank's part of the batch and sequence,
        so 'data' and 'seq'; the MoE router also on this rank's token
        slice, so 'model' too.  The other parameters meet the model axis
        only through the Megatron pair and the gather of ``moe_mlp``,
        which hand every model rank the whole gradient."""
        data, seq, model = self.axes
        return {n: ((data, seq, model) if n.endswith(".router")
                    else (data, seq)) for n in self._shapes()}

    def init(self, generator: torch.Generator) -> Dict[str, nn.Parameter]:
        """Fresh f32 parameters on this rank's device, drawn from
        ``generator`` (a CPU generator) whole, by the JAX rules, and cut
        to this rank's shards: LayerNorm scales ones, biases zeros,
        ``embed``/``pos`` N(0, 0.02²), the other matrices N(0, 1) /
        sqrt(fan_in) with fan_in = ``shape[-2]``."""
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
            t = t[self._local_slice(name, shape)].contiguous()
            params[name] = nn.Parameter(t.to(self.device))
        return params

    # -- forward --------------------------------------------------------------
    def _ln(self, scale: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h32 = h.to(torch.float32)
        mu = h32.mean(dim=-1, keepdim=True)
        var = (h32 - mu).square().mean(dim=-1, keepdim=True)
        return ((h32 - mu) * torch.rsqrt(var + 1e-5)
                * scale).to(self.compute_dtype)

    def _block(self, i: int, x: torch.Tensor, lp: Dict[str, torch.Tensor],
               rope_pos: Optional[torch.Tensor]):
        """Layer ``i`` on (B, S, D) ``x``: (x out, router stats or
        None)."""
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
        stats = None
        if i in self.moe_layers:
            # each model rank routes its own token slice; moe_mlp gathers
            # the slices back, so every model rank holds the whole output
            y, stats = moe_mlp(h, lp["router"], lp["w1"], lp["b1"],
                               lp["w2"], lp["b2"], axis_name=model_axis,
                               capacity_factor=self.capacity_factor,
                               compute_dtype=cdt,
                               router_top_k=self.router_top_k,
                               mesh=self.mesh)
        else:
            y = tp_mlp(h, lp["w1"], lp["b1"], lp["w2"], lp["b2"],
                       axis_name=model_axis, compute_dtype=cdt,
                       mesh=self.mesh)
        return x + y.to(cdt), stats

    def _forward(self, params: Dict[str, torch.Tensor],
                 tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """This rank's tokens (B/dp, S/sp) → (logits (B/dp, S/sp, V) f32,
        each MoE layer's router stats over this rank's token slice; an
        empty list for a dense stack)."""
        cdt = self.compute_dtype
        s_loc = tokens.shape[1]
        seq_idx = self.mesh.axis_index(self.axes[1])
        x = F.embedding(tokens.long(), params["embed"].to(cdt))
        if self.positional == "learned":
            pos = params["pos"][seq_idx * s_loc:(seq_idx + 1) * s_loc]
            x = x + pos.to(cdt)
        # rope: q/k rotate inside each block, by global positions
        rope_pos = (seq_idx * s_loc + torch.arange(s_loc, device=x.device)
                    if self.positional == "rope" else None)
        router_stats = []
        for i in range(self.num_layers):
            keys = MOE_LAYER_KEYS if i in self.moe_layers else LAYER_KEYS
            lp = {k: params[f"layers.{i}.{k}"] for k in keys}
            if self.remat:
                # recompute the block's activations in the backward instead
                # of keeping them: the long-context memory/FLOPs trade
                x, stats = checkpoint(self._block, i, x, lp, rope_pos,
                                      use_reentrant=False)
            else:
                x, stats = self._block(i, x, lp, rope_pos)
            if stats is not None:
                router_stats.append(stats)
        x = self._ln(params["ln_f"], x)
        return _project(x, params["head"], None, cdt), router_stats

    def _loss(self, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        """The global token mean of the softmax cross-entropy plus the
        weighted load-balance term of each MoE layer, an f32 scalar that
        every rank holds."""
        data_axis, seq_axis, model_axis = self.axes
        logits, router_stats = self._forward(params, tokens)
        if self.fused_ce:
            from ..ops.fused_ce import fused_softmax_cross_entropy
            losses = fused_softmax_cross_entropy(
                logits.reshape(-1, self.vocab_size), labels.reshape(-1))
            local_sum = losses.sum()
        else:
            logp = torch.log_softmax(logits, dim=-1)
            picked = logp.gather(-1, labels.long()[..., None])[..., 0]
            local_sum = -picked.sum()
        total = psum(local_sum, (data_axis, seq_axis), self.mesh)
        # the psum of the counts: every (data, seq) shard holds as many
        count = float(labels.numel() * self.dp * self.sp)
        # JAX pmeans the loss over 'model' here, a no-op in value that its
        # varying-axes types need; every model rank holds this loss and
        # its whole cotangent already (collective.py), which is that
        # pmean's transpose for a value that does not vary over the axis
        loss = total / count
        for stats in router_stats:
            # average the STATS over every shard, then form f·P once: the
            # loss is then the same on any mesh shape
            fp = pmean(torch.stack([stats["fraction"], stats["prob"]]),
                       self.axes, self.mesh)
            loss = loss + self.router_aux_weight * load_balance_loss(
                {"fraction": fp[0], "prob": fp[1]})
        return loss

    # -- train step -----------------------------------------------------------
    def compile_train_step(self, optimizer, params: Dict[str, torch.Tensor],
                           zero: bool = False, fsdp: bool = False):
        """(opt_state, step): ``step(params, opt_state, tokens, labels) ->
        (params, opt_state, loss)``, with ``optimizer`` a
        ``core.optimizers.Transform`` (``core.optimizers.adam`` for
        ``optax.adam``), tokens and labels (B, S) integer tensors on
        :meth:`batch_sharding`'s device, and the parameters updated in
        place.  Tokens and labels are this rank's block (:meth:`shard_batch`).
        ``zero=True`` slices the optimizer state over the data axis
        (ZeRO-1), ``fsdp=True`` the parameters too, which then rest as
        their slices (``train_step.build_train_step``; at data-axis size 1
        the arithmetic of the plain step)."""
        from .train_step import build_train_step
        data_axis = self.axes[0]
        return build_train_step(self.mesh, self._loss, optimizer, params,
                                zero_axis=data_axis if zero else None,
                                fsdp_axis=data_axis if fsdp else None,
                                grad_axes=self.grad_axes(),
                                param_specs=self.param_specs())

    def batch_sharding(self) -> torch.device:
        """Where this rank's batch goes: its device."""
        return self.device

    def shard_batch(self, batch) -> torch.Tensor:
        """A global (B, S) batch (numpy or tensor) → this rank's
        (B/dp, S/sp) block on its device, the block that JAX's
        ``P('data', 'seq')`` gives the same mesh position."""
        t = torch.as_tensor(batch)
        b, s = t.shape
        if b % self.dp or s % self.sp:
            raise ValueError(f"batch {tuple(t.shape)} does not split over "
                             f"dp={self.dp}, sp={self.sp}")
        bi = self.mesh.axis_index(self.axes[0])
        si = self.mesh.axis_index(self.axes[1])
        bl, sl = b // self.dp, s // self.sp
        return t[bi * bl:(bi + 1) * bl, si * sl:(si + 1) * sl].contiguous(
            ).to(self.device)


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


def load_jax_params(lm, tree: Any) -> Dict[str, nn.Parameter]:
    """The JAX ``ParallelTransformerLM.init`` (or ``PipelineTransformerLM.
    init``) output, whole, as nested
    dicts and lists of arrays (``jax.device_get(params)``; a flat dict
    keyed by leaf name, ``layers.0.wq``, is taken too), as the port's
    parameter dict: each leaf sliced by its spec at this rank's
    coordinates, f32 tensors on this rank's device.  Every name and every
    full shape is checked against ``lm``."""
    given = dict(_jax_leaves(tree))
    shapes = lm._shapes()
    missing = sorted(set(shapes) - set(given))
    extra = sorted(set(given) - set(shapes))
    if missing or extra:
        raise ValueError(f"parameter names differ from the model's: "
                         f"missing {missing}, unexpected {extra}")
    arrays = {}
    for name, shape in shapes.items():  # every shape before any copy
        arrays[name] = arr = np.asarray(given[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"parameter {name}: shape {arr.shape} does not "
                             f"match the model's {shape}")
    params = {}
    for name, shape in shapes.items():
        arr = arrays[name]
        local = np.ascontiguousarray(arr[lm._local_slice(name, shape)])
        params[name] = nn.Parameter(torch.tensor(local, device=lm.device))
    return params


def _tree_of(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Leaves by dotted name → the nested tree JAX lays out: a part that
    is a number indexes a list (``layers.0.wq``), any other a dict
    (``layers.wq``)."""
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        parts = [int(p) if p.isdigit() else p for p in name.split(".")]
        node: Any = tree
        for part, nxt in zip(parts[:-1], parts[1:]):
            child = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                node.extend(None for _ in range(part + 1 - len(node)))
                if node[part] is None:
                    node[part] = child
                node = node[part]
            else:
                node = node.setdefault(part, child)
        node[parts[-1]] = leaf
    return tree


def at_rest_specs(lm) -> Dict[str, Tuple]:
    """The parameters' specs at rest under FSDP: ``param_specs`` sliced
    over the LM's data axis by ``train_step.shard_specs_over_axis``."""
    from .train_step import shard_specs_over_axis
    return shard_specs_over_axis(lm.param_specs(), lm._shapes(), lm.mesh,
                                 lm.data_axis)


def gather_params(lm, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The shards of ``params`` (parameters, or gradients of the same
    shapes) of a ``ParallelTransformerLM`` or a ``PipelineTransformerLM``
    put back together: the full tree as JAX lays it out (nested dicts, a
    list of layers where the names number them), numpy f32 arrays, on
    every rank (a collective: every rank calls it).  A parameter that
    rests as its FSDP slice is gathered by :func:`at_rest_specs`."""
    specs, shapes = lm.param_specs(), lm._shapes()
    rest = None
    flat = {}
    for name, spec in specs.items():
        t = params[name]
        local = tuple(n // lm.mesh.shape[a] if a else n for n, a in
                      zip(shapes[name], tuple(spec) + (None,) * len(t.shape)))
        if tuple(t.shape) != local:
            rest = at_rest_specs(lm) if rest is None else rest
            spec = rest[name]
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = gather_leaf(t, axis, dim, lm.mesh)
        # a copy: a CPU shard's own storage keeps training
        flat[name] = t.detach().to("cpu", torch.float32, copy=True).numpy()
    return _tree_of(flat)
