"""The model-parallel layer of the port on one card (counterpart of
``distkeras_tpu.parallel``): the mesh, tensor-parallel blocks, the ring
and Ulysses attention schedules, the train step and
``ParallelTransformerLM``.  Every collective is the identity on a mesh
axis of size 1 and raises above it; MoE, the pipeline, the SPMD engine
and programs across cards wait for ROADMAP queue A items 5 and 7."""

from .mesh import Mesh
from .ring import SEQ_AXIS, ring_attention, ring_self_attention
from .tp import (MODEL_AXIS, column_parallel_dense, row_parallel_dense,
                 tp_mlp, tp_self_attention)
from .train_step import build_train_step
from .transformer import ParallelTransformerLM, load_jax_params
from .ulysses import ulysses_attention, ulysses_self_attention

__all__ = ["Mesh", "SEQ_AXIS", "ring_attention",
           "ring_self_attention", "MODEL_AXIS", "column_parallel_dense",
           "row_parallel_dense", "tp_mlp", "tp_self_attention",
           "build_train_step", "ParallelTransformerLM", "load_jax_params",
           "ulysses_attention", "ulysses_self_attention"]
