"""The parallel layer of the port (counterpart of
``distkeras_tpu.parallel``): the meshes and their process groups, the
collectives, the SPMD engine of the distributed trainers with its update
rules, tensor-parallel blocks, the ring and Ulysses attention schedules,
expert parallelism (MoE), the pipeline schedules (GPipe and 1F1B), the
train step with ZeRO-1 and FSDP over the data axis,
``ParallelTransformerLM`` over ('data', 'seq', 'model') ranks and
``PipelineTransformerLM`` over ('data', 'stage'[, 'model']) ranks.  The
SPMD engine runs a worker mesh across ranks (one worker a rank) or, on a
mesh that repeats one device, every worker in one process
(``mesh.py``)."""

from . import collective, rules
from .collective import (all_gather, all_to_all, pmean, ppermute, psum,
                         pvary)
from .mesh import (WORKER_AXIS, Mesh, Placement, get_mesh, initialize,
                   put_replicated, put_worker_sharded, replicated,
                   worker_sharded)
from .moe import (EXPERT_AXIS, load_balance_loss, moe_mlp, top1_routing,
                  topk_routing, topk_slots)
from .spmd import DistState, SPMDEngine, shape_epoch_data
from .ring import SEQ_AXIS, ring_attention, ring_self_attention
from .tp import (MODEL_AXIS, column_parallel_dense, row_parallel_dense,
                 tp_mlp, tp_self_attention)
from .pipeline import STAGE_AXIS, pipeline_1f1b, pipeline_apply
from .pp_transformer import PipelineTransformerLM
from .train_step import (build_train_step, opt_partition_specs,
                         shard_specs_over_axis, zero_shard_specs)
from .transformer import ParallelTransformerLM, gather_params, load_jax_params
from .ulysses import ulysses_attention, ulysses_self_attention

__all__ = ["WORKER_AXIS", "Mesh", "get_mesh", "initialize", "Placement",
           "replicated", "worker_sharded", "put_replicated",
           "put_worker_sharded", "collective",
           "psum", "pmean", "pvary", "all_gather", "all_to_all", "ppermute",
           "SPMDEngine", "DistState", "shape_epoch_data", "rules",
           "SEQ_AXIS", "ring_attention", "ring_self_attention",
           "MODEL_AXIS", "column_parallel_dense", "row_parallel_dense",
           "tp_mlp", "tp_self_attention", "EXPERT_AXIS", "topk_routing",
           "topk_slots", "load_balance_loss", "top1_routing", "moe_mlp",
           "STAGE_AXIS", "pipeline_apply", "pipeline_1f1b",
           "PipelineTransformerLM", "build_train_step",
           "opt_partition_specs", "shard_specs_over_axis",
           "zero_shard_specs", "ParallelTransformerLM", "load_jax_params",
           "gather_params", "ulysses_attention", "ulysses_self_attention"]
