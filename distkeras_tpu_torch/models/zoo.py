"""Model zoo, port of ``distkeras_tpu/models/zoo.py``.

Only ``transformer_lm`` is ported so far; the MLP and ConvNet models
arrive with the ConvNet slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.layers import (Dense, Embedding, LayerNormalization,
                           PositionalEmbedding, TransformerBlock)
from ..core.model import Sequential
from ..device import DeviceLike


def transformer_lm(vocab_size: int = 256, seq_len: int = 128,
                   d_model: int = 128, num_heads: int = 4,
                   num_layers: int = 2, mlp_dim: int = 512,
                   dropout: float = 0.0, compute_dtype: str = "bfloat16",
                   attention_impl=None, num_kv_heads=None,
                   attention_window=None,
                   positional: str = "learned",
                   rope_theta: float = 10000.0,
                   rope_scale: float = 1.0,
                   device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Sequential:
    """Decoder-only causal transformer LM, the same stack and config JSON
    as the JAX function.  Input: (seq_len,) int token ids; output:
    (seq_len, vocab) f32 logits.  Built on ``device`` (``None`` means the
    CUDA card), with parameters drawn from ``generator``."""
    if positional not in ("learned", "rope"):
        raise ValueError(f"positional must be 'learned' or 'rope', got "
                         f"{positional!r}")
    rope = positional == "rope"
    layers = [Embedding(vocab_size, d_model)]
    if not rope:  # RoPE rotates q/k inside attention; no additive table
        layers.append(PositionalEmbedding(seq_len))
    for _ in range(num_layers):
        layers.append(TransformerBlock(
            num_heads, d_model // num_heads, mlp_dim, dropout=dropout,
            causal=True, attention_impl=attention_impl,
            num_kv_heads=num_kv_heads, attention_window=attention_window,
            rope=rope, rope_theta=rope_theta, rope_scale=rope_scale))
    layers += [LayerNormalization(), Dense(vocab_size)]
    return Sequential(layers, input_shape=(seq_len,),
                      compute_dtype=compute_dtype, name="transformer_lm",
                      device=device, generator=generator)
