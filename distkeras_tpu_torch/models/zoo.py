"""Model zoo, port of ``distkeras_tpu/models/zoo.py``: the MNIST MLP and
ConvNet, the digits MLP and ConvNet, the CIFAR-10 ConvNet, the ATLAS
Higgs MLP and the causal transformer LM, each the JAX function's stack,
widths and config JSON.  Each builds its parameters on ``device``
(``None`` means the CUDA card), drawn from ``generator`` (seed 0 when
``None``; not the JAX package's numbers: load its weights with
``load_jax_weights`` to match it).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.layers import (Conv2D, Dense, Dropout, Embedding, Flatten,
                           LayerNormalization, MaxPooling2D,
                           PositionalEmbedding, Reshape, TransformerBlock)
from ..core.model import Sequential
from ..device import DeviceLike


def mnist_mlp(compute_dtype: str = "bfloat16", device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> Sequential:
    """MLP on flat 784-dim MNIST rows: two Dense-500 relu layers and a
    10-way softmax."""
    return Sequential([
        Dense(500, activation="relu"),
        Dense(500, activation="relu"),
        Dense(10, activation="softmax"),
    ], input_shape=(784,), compute_dtype=compute_dtype, name="mnist_mlp",
        device=device, generator=generator)


def mnist_convnet(compute_dtype: str = "bfloat16", device: DeviceLike = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Sequential:
    """ConvNet on 28x28x1 MNIST, the north-star benchmark model: two
    Conv-32 and one Conv-64 (3x3, SAME, relu) with 2x2 max pools, Dense-128
    relu and a 10-way softmax."""
    return Sequential([
        Reshape((28, 28, 1)),
        Conv2D(32, 3, activation="relu"),
        Conv2D(32, 3, activation="relu"),
        MaxPooling2D(2),
        Conv2D(64, 3, activation="relu"),
        MaxPooling2D(2),
        Flatten(),
        Dense(128, activation="relu"),
        Dense(10, activation="softmax"),
    ], input_shape=(784,), compute_dtype=compute_dtype,
        name="mnist_convnet", device=device, generator=generator)


def digits_mlp(compute_dtype: str = "bfloat16", device: DeviceLike = None,
               generator: Optional[torch.Generator] = None) -> Sequential:
    """MLP on the 64-dim 8x8 digits rows (``data.datasets.load_digits``)."""
    return Sequential([
        Dense(128, activation="relu"),
        Dense(128, activation="relu"),
        Dense(10, activation="softmax"),
    ], input_shape=(64,), compute_dtype=compute_dtype, name="digits_mlp",
        device=device, generator=generator)


def digits_convnet(compute_dtype: str = "bfloat16",
                   device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Sequential:
    """ConvNet on the 8x8x1 digits rows, the conv analogue of
    ``digits_mlp`` ('same' padding keeps the 8x8 plane from vanishing
    before the pools)."""
    return Sequential([
        Reshape((8, 8, 1)),
        Conv2D(16, 3, activation="relu", padding="same"),
        Conv2D(16, 3, activation="relu", padding="same"),
        MaxPooling2D(2),
        Conv2D(32, 3, activation="relu", padding="same"),
        MaxPooling2D(2),
        Flatten(),
        Dense(64, activation="relu"),
        Dense(10, activation="softmax"),
    ], input_shape=(64,), compute_dtype=compute_dtype,
        name="digits_convnet", device=device, generator=generator)


def cifar10_convnet(compute_dtype: str = "bfloat16",
                    device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Sequential:
    """Small ConvNet on 32x32x3 CIFAR-10 rows (flat 3072-dim)."""
    return Sequential([
        Reshape((32, 32, 3)),
        Conv2D(32, 3, activation="relu"),
        Conv2D(32, 3, activation="relu"),
        MaxPooling2D(2),
        Conv2D(64, 3, activation="relu"),
        Conv2D(64, 3, activation="relu"),
        MaxPooling2D(2),
        Flatten(),
        Dense(256, activation="relu"),
        Dropout(0.5),
        Dense(10, activation="softmax"),
    ], input_shape=(3072,), compute_dtype=compute_dtype,
        name="cifar10_convnet", device=device, generator=generator)


def higgs_mlp(compute_dtype: str = "bfloat16", device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> Sequential:
    """Tabular MLP for ATLAS Higgs signal/background: two Dense-500 relu
    layers and a 2-way softmax over 28 features."""
    return Sequential([
        Dense(500, activation="relu"),
        Dense(500, activation="relu"),
        Dense(2, activation="softmax"),
    ], input_shape=(28,), compute_dtype=compute_dtype, name="higgs_mlp",
        device=device, generator=generator)


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
