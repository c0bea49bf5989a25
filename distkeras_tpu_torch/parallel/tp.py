"""Tensor-parallel building blocks, port of
``distkeras_tpu/parallel/tp.py``.

The Megatron pattern of the JAX package: a column-parallel product needs
no communication, a row-parallel product ends in one ``psum`` over the
model axis, so an MLP (column → gelu → row) and an attention block (q/k/v
column-split by head, output row-split) each cost one collective forward.
Each block's input, which every model rank holds, enters through
``pvary`` (identity forward, all-reduce backward: Megatron's other half,
which JAX inserts from its types), so the input's gradient is whole on
every rank.  The products keep the JAX rule: operands rounded to the
compute dtype, an f32 result (``preferred_element_type=f32``), the bias
added in f32 after the psum.  Weights are this rank's shards: (D, F/tp)
columns, (F/tp, D) rows, the local heads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.layers import _project
from .collective import psum, pvary
from .mesh import Mesh

MODEL_AXIS = "model"


def column_parallel_dense(x: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ W_col_shard in f32, plus the bias: no communication."""
    return _project(x, kernel, bias, compute_dtype)


def row_parallel_dense(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       axis_name: str = MODEL_AXIS,
                       compute_dtype=torch.bfloat16,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """psum(x_shard @ W_row_shard) in f32; the bias is added once, after
    the reduce."""
    y = psum(_project(x, kernel, None, compute_dtype), axis_name, mesh)
    return y if bias is None else y + bias


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default: the tanh approximation
    return F.gelu(x, approximate="tanh")


def tp_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor, *,
           axis_name: str = MODEL_AXIS, activation=_gelu,
           compute_dtype=torch.bfloat16,
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Column → activation → row: the Megatron MLP, one psum."""
    x = pvary(x, axis_name, mesh)
    h = column_parallel_dense(x, w1, b1, compute_dtype=compute_dtype)
    h = activation(h).to(compute_dtype)
    return row_parallel_dense(h, w2, b2, axis_name=axis_name,
                              compute_dtype=compute_dtype, mesh=mesh)


def tp_self_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                      wv: torch.Tensor, wo: torch.Tensor, *,
                      num_local_heads: int, head_dim: int,
                      axis_name: str = MODEL_AXIS,
                      seq_axis: Optional[str] = None, causal: bool = True,
                      compute_dtype=torch.bfloat16,
                      ring_block_k: Optional[int] = None,
                      num_local_kv_heads: Optional[int] = None,
                      window: Optional[int] = None,
                      rope_positions: Optional[torch.Tensor] = None,
                      sp_impl: str = "ring", rope_theta: float = 10000.0,
                      rope_scale: float = 1.0,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Head-parallel self-attention on (B, S, D) ``x``: q/k/v projected
    and split into heads, RoPE-rotated by the (S,) ``rope_positions`` when
    given, attended, and projected back through ``wo`` with one psum.
    With ``seq_axis`` set the attend runs the sequence-parallel schedule
    ``sp_impl`` (``"ring"``: ``ring.ring_attention``, plain tensor code;
    ``"ulysses"``: ``ulysses.ulysses_attention``, the flash kernels on the
    card); without it, the ``ops.attention`` dispatcher.
    ``num_local_kv_heads`` < ``num_local_heads`` is grouped-query
    attention; ``window`` is sliding-window masking (requires causal)."""
    from ..ops.attention import attention
    from .ring import ring_attention
    from .ulysses import ulysses_attention

    x = pvary(x, axis_name, mesh)
    b, s, _ = x.shape
    h, dh = num_local_heads, head_dim
    hkv = num_local_kv_heads if num_local_kv_heads is not None else h

    def proj(w, heads):
        y = column_parallel_dense(x, w, compute_dtype=compute_dtype)
        return y.to(compute_dtype).reshape(b, s, heads, dh)

    q, k, v = proj(wq, h), proj(wk, hkv), proj(wv, hkv)
    if rope_positions is not None:
        from ..ops.rope import apply_rope
        q = apply_rope(q, rope_positions, rope_theta, rope_scale)
        k = apply_rope(k, rope_positions, rope_theta, rope_scale)
    if seq_axis is not None and sp_impl == "ulysses":
        out = ulysses_attention(q, k, v, seq_axis, causal=causal,
                                window=window, mesh=mesh)
    elif seq_axis is not None:
        if sp_impl != "ring":
            raise ValueError(f"unknown sp_impl {sp_impl!r} "
                             "(expected 'ring' or 'ulysses')")
        out = ring_attention(q, k, v, seq_axis, causal=causal,
                             block_k=ring_block_k, window=window, mesh=mesh)
    else:
        out = attention(q, k, v, causal=causal, window=window)
    out = out.reshape(b, s, h * dh)
    return row_parallel_dense(out, wo, axis_name=axis_name,
                              compute_dtype=compute_dtype, mesh=mesh)
