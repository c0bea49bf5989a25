"""distkeras_tpu_torch — the PyTorch/CUDA port of ``distkeras_tpu``.

It grows slice by slice beside the JAX package, which stays the reference.
It serves a causal transformer LM through ``ModelPredictor`` and trains it
through ``SingleTrainer``, with attention in hand-written Hopper
flash-attention kernels (``csrc/flash_attention_fwd*.cu`` forward,
``csrc/flash_attention_bwd*.cu`` backward); trains
``parallel.ParallelTransformerLM`` on one card, whose fused loss runs the
hand-written cross-entropy kernels (``csrc/fused_ce.cu``); and trains and
serves the ConvNet/MLP zoo (MNIST, digits, CIFAR-10, ATLAS Higgs) through
``SingleTrainer`` and ``ModelPredictor`` with the dist-keras transformer
and evaluator pipeline.  The port imports torch and numpy, never jax and
nothing of ``distkeras_tpu``.  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""

from .core import (Activation, AveragePooling2D, BatchNormalization,
                   Conv2D, Dense, Dropout, Embedding, FittedModel, Flatten,
                   GlobalAveragePooling2D, Layer, LayerNormalization,
                   MaxPooling2D, MultiHeadAttention, PositionalEmbedding,
                   Reshape, Sequential, TransformerBlock, deserialize_model,
                   load_jax_weights, serialize_model)
from .core.losses import get_loss
from .core.optimizers import (SGD, Adadelta, Adagrad, Adam, Optimizer,
                              RMSprop, get_optimizer)
from .data import (Dataset, DenseTransformer, LabelIndexTransformer,
                   MinMaxTransformer, OneHotTransformer, ReshapeTransformer,
                   StandardScaleTransformer)
from .evaluators import (AccuracyEvaluator, AUCEvaluator, Evaluator,
                         F1Evaluator, LossEvaluator, TopKAccuracyEvaluator)
from .models import (cifar10_convnet, digits_convnet, digits_mlp, higgs_mlp,
                     mnist_convnet, mnist_mlp, transformer_lm)
from .predictors import ModelPredictor, Predictor
from .trainers import SingleTrainer, Trainer

__all__ = ["Activation", "AveragePooling2D", "BatchNormalization", "Conv2D",
           "Dense", "Dropout", "Embedding", "FittedModel", "Flatten",
           "GlobalAveragePooling2D", "Layer", "LayerNormalization",
           "MaxPooling2D", "MultiHeadAttention", "PositionalEmbedding",
           "Reshape", "Sequential", "TransformerBlock", "deserialize_model",
           "load_jax_weights", "serialize_model", "get_loss",
           "SGD", "Adadelta", "Adagrad", "Adam", "Optimizer", "RMSprop",
           "get_optimizer", "Dataset", "DenseTransformer",
           "LabelIndexTransformer", "MinMaxTransformer", "OneHotTransformer",
           "ReshapeTransformer", "StandardScaleTransformer",
           "AccuracyEvaluator", "AUCEvaluator", "Evaluator", "F1Evaluator",
           "LossEvaluator", "TopKAccuracyEvaluator", "cifar10_convnet",
           "digits_convnet", "digits_mlp", "higgs_mlp", "mnist_convnet",
           "mnist_mlp", "transformer_lm", "ModelPredictor", "Predictor",
           "SingleTrainer", "Trainer"]
