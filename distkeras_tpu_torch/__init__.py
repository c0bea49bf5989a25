"""distkeras_tpu_torch — the PyTorch/CUDA port of ``distkeras_tpu``.

It grows slice by slice beside the JAX package, which stays the reference.
It serves a causal transformer LM through ``ModelPredictor`` and trains it
through ``SingleTrainer``, with attention in hand-written Hopper
flash-attention kernels (``csrc/flash_attention_fwd*.cu`` forward,
``csrc/flash_attention_bwd*.cu`` backward); trains
``parallel.ParallelTransformerLM`` on one card and across
``torch.distributed`` ranks (data, sequence, tensor and Switch expert
parallelism, ZeRO-1 and FSDP over the data axis), whose fused loss runs
the hand-written cross-entropy kernels (``csrc/fused_ce.cu``), and
``parallel.PipelineTransformerLM`` over data, pipeline (GPipe, 1F1B) and
tensor ranks; and trains and
serves the ConvNet/MLP zoo (MNIST, digits, CIFAR-10, ATLAS Higgs) through
``SingleTrainer`` and ``ModelPredictor`` with the dist-keras transformer
and evaluator pipeline, and with the dist-keras distributed trainers
(ADAG, DOWNPOUR, DynSGD, AEASGD, EAMSGD, Averaging, Ensemble) on its SPMD
engine, with checkpoints and metrics; and serves the LM through the
continuous-batching ``serving.ServingEngine`` (paged KV pool and prefix
trie, speculation, quantization, multi-tenant QoS with preemption,
disaggregated prefill and decode roles) behind its socket front-end
(``ServingServer``, ``ServingClient``, ``DisaggPair``) over ``networking``,
the serving wire of the JAX package byte for byte, and routes a
replicated fleet of engines (``router.ServingRouter``: prefix-affinity
dispatch, zero-loss failover, rolling swaps) under the
``resilience`` supervisors; and runs the asynchronous trainers against a
live socket parameter server (``execution="host_ps"``:
``parameter_servers``, ``workers``, ``applykernel``), each worker a thread
training its own copy of the model on the card, or an OS process of its
own (``execution="process_ps"``: ``ps_worker_main``, ``ps_shard_main``,
launched through ``job_deployment``); trains them online from an
unbounded ``streaming.StreamSource`` (``stream=True``) while a
``ServingEngine`` hot-reloads the live center (``attach_ps``), the two
run as one system by ``deployment_online.OnlineDeployment``.  The port
imports
torch and numpy,
never jax and nothing of ``distkeras_tpu``.  Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
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
from . import networking, serving
from .networking import ChaosFault, ChaosProxy
from .serving import (DisaggPair, Draining, EngineDead, QueueFull,
                      QuotaExceeded, RequestHandle, ServingClient,
                      ServingEngine, ServingServer, TenantPolicy)
from . import resilience, router
from .resilience import EngineSupervisor, FleetSupervisor, RetryPolicy
from .router import ServingRouter
from . import checkpoint, metrics, parallel
from .checkpoint import Checkpointer, make_checkpointer
from .metrics import MetricsLogger
from . import (applykernel, job_deployment, native, parameter_servers,
               ps_sharding, streaming, utils, workers)
from .ps_sharding import PSShardDown
from .streaming import StreamBuffer, StreamSource
from . import deployment_online
from .deployment_online import FreshnessTracker, OnlineDeployment
from .trainers import (ADAG, AEASGD, DOWNPOUR, EAMSGD,
                       AsynchronousDistributedTrainer, AveragingTrainer,
                       DistributedTrainer, DynSGD, EnsembleTrainer,
                       SingleTrainer, SynchronousDistributedTrainer, Trainer)

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
           "SingleTrainer", "Trainer", "DistributedTrainer",
           "AsynchronousDistributedTrainer", "SynchronousDistributedTrainer",
           "ADAG", "DOWNPOUR", "DynSGD", "AEASGD", "EAMSGD",
           "AveragingTrainer", "EnsembleTrainer", "Checkpointer",
           "make_checkpointer", "MetricsLogger", "checkpoint", "metrics",
           "parallel", "serving", "ServingEngine", "RequestHandle",
           "QueueFull", "QuotaExceeded", "Draining", "EngineDead",
           "TenantPolicy", "ServingServer", "ServingClient", "DisaggPair",
           "networking", "ChaosFault", "ChaosProxy", "resilience",
           "router", "ServingRouter", "EngineSupervisor", "FleetSupervisor",
           "RetryPolicy", "applykernel", "parameter_servers", "workers",
           "ps_sharding", "streaming", "PSShardDown", "job_deployment",
           "StreamBuffer", "StreamSource", "deployment_online",
           "FreshnessTracker", "OnlineDeployment", "native", "utils"]
