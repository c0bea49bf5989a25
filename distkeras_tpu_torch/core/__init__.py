"""Model stack of the port (counterpart of ``distkeras_tpu.core``)."""

from .layers import (Activation, AveragePooling2D, BatchNormalization,
                     Conv2D, Dense, Dropout, Embedding, Flatten,
                     GlobalAveragePooling2D, Layer, LayerNormalization,
                     MaxPooling2D, MultiHeadAttention, PositionalEmbedding,
                     Reshape, TransformerBlock, get_activation)
from .model import (FittedModel, Sequential, deserialize_model,
                    load_jax_weights, read_npz_blob, serialize_model,
                    write_npz_blob)
from .train import TrainState, init_state, make_epoch_runner, make_train_step

__all__ = ["Layer", "Dense", "Conv2D", "MaxPooling2D", "AveragePooling2D",
           "GlobalAveragePooling2D", "Flatten", "Reshape", "Activation",
           "Dropout", "BatchNormalization", "Embedding", "get_activation",
           "LayerNormalization", "MultiHeadAttention", "PositionalEmbedding",
           "TransformerBlock", "FittedModel", "Sequential",
           "deserialize_model", "load_jax_weights", "read_npz_blob",
           "serialize_model", "write_npz_blob", "TrainState", "init_state",
           "make_epoch_runner", "make_train_step"]
