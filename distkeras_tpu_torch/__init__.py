"""distkeras_tpu_torch — the PyTorch/CUDA port of ``distkeras_tpu``.

It grows slice by slice beside the JAX package, which stays the reference.
This slice serves a causal transformer LM through ``ModelPredictor``, with
attention in a hand-written Hopper flash-attention kernel
(``csrc/flash_attention_fwd.cu``).  The port imports torch and numpy,
never jax and nothing of ``distkeras_tpu``.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""

from .core import (Dense, Embedding, FittedModel, Layer, LayerNormalization,
                   MultiHeadAttention, PositionalEmbedding, Sequential,
                   TransformerBlock, load_jax_weights)
from .data import Dataset
from .models import transformer_lm
from .predictors import ModelPredictor, Predictor

__all__ = ["Dense", "Embedding", "FittedModel", "Layer",
           "LayerNormalization", "MultiHeadAttention", "PositionalEmbedding",
           "Sequential", "TransformerBlock", "load_jax_weights", "Dataset",
           "transformer_lm", "ModelPredictor", "Predictor"]
