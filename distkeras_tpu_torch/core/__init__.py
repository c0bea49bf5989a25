"""Model stack of the port (counterpart of ``distkeras_tpu.core``)."""

from .layers import (Dense, Dropout, Embedding, Layer, LayerNormalization,
                     MultiHeadAttention, PositionalEmbedding,
                     TransformerBlock)
from .model import (FittedModel, Sequential, deserialize_model,
                    load_jax_weights, read_npz_blob, serialize_model,
                    write_npz_blob)

__all__ = ["Dense", "Dropout", "Embedding", "Layer", "LayerNormalization",
           "MultiHeadAttention", "PositionalEmbedding", "TransformerBlock",
           "FittedModel", "Sequential", "deserialize_model",
           "load_jax_weights", "read_npz_blob", "serialize_model",
           "write_npz_blob"]
