"""The parallel layer of the port on one card (counterpart of
``distkeras_tpu.parallel``): the meshes, the SPMD engine of the
distributed trainers with its update rules, tensor-parallel blocks, the
ring and Ulysses attention schedules, the train step and
``ParallelTransformerLM``.  Every collective of the model-parallel layer
is the identity on a mesh axis of size 1 and raises above it; MoE, the
pipeline and programs across cards wait for ROADMAP queue A item 7."""

from . import rules
from .mesh import WORKER_AXIS, Mesh, get_mesh
from .spmd import DistState, SPMDEngine, shape_epoch_data
from .ring import SEQ_AXIS, ring_attention, ring_self_attention
from .tp import (MODEL_AXIS, column_parallel_dense, row_parallel_dense,
                 tp_mlp, tp_self_attention)
from .train_step import build_train_step
from .transformer import ParallelTransformerLM, load_jax_params
from .ulysses import ulysses_attention, ulysses_self_attention

__all__ = ["WORKER_AXIS", "Mesh", "get_mesh", "SPMDEngine", "DistState",
           "shape_epoch_data", "rules", "SEQ_AXIS", "ring_attention",
           "ring_self_attention", "MODEL_AXIS", "column_parallel_dense",
           "row_parallel_dense", "tp_mlp", "tp_self_attention",
           "build_train_step", "ParallelTransformerLM", "load_jax_params",
           "ulysses_attention", "ulysses_self_attention"]
