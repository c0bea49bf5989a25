"""distkeras_tpu_torch — the PyTorch/CUDA port of ``distkeras_tpu``.

It grows slice by slice beside the JAX package, which stays the reference.
It serves a causal transformer LM through ``ModelPredictor`` and trains it
through ``SingleTrainer``, with attention in hand-written Hopper
flash-attention kernels (``csrc/flash_attention_fwd.cu`` forward,
``csrc/flash_attention_bwd.cu`` backward), and trains
``parallel.ParallelTransformerLM`` on one card, whose fused loss runs the
hand-written cross-entropy kernels (``csrc/fused_ce.cu``).  The port
imports torch and numpy, never jax and nothing of ``distkeras_tpu``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from .core import (Dense, Dropout, Embedding, FittedModel, Layer,
                   LayerNormalization, MultiHeadAttention,
                   PositionalEmbedding, Sequential, TransformerBlock,
                   load_jax_weights)
from .core.losses import get_loss
from .core.optimizers import (SGD, Adadelta, Adagrad, Adam, Optimizer,
                              RMSprop, get_optimizer)
from .data import Dataset
from .models import transformer_lm
from .predictors import ModelPredictor, Predictor
from .trainers import SingleTrainer, Trainer

__all__ = ["Dense", "Dropout", "Embedding", "FittedModel", "Layer",
           "LayerNormalization", "MultiHeadAttention", "PositionalEmbedding",
           "Sequential", "TransformerBlock", "load_jax_weights", "get_loss",
           "SGD", "Adadelta", "Adagrad", "Adam", "Optimizer", "RMSprop",
           "get_optimizer", "Dataset", "transformer_lm", "ModelPredictor",
           "Predictor", "SingleTrainer", "Trainer"]
