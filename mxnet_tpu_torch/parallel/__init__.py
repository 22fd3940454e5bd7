"""Parallel training across ranks: the mesh over the process group, the
collectives over NCCL (a card) or gloo (the CPU), ZeRO's slices,
``DataParallelTrainer`` (dense, compressed and ZeRO steps, and tensor
and expert parallel layouts over ``torch.distributed.tensor``), the
sharding planner, pipelines (GPipe and 1F1B) and ring attention."""
from . import collectives, planner, zero
from .collectives import (quantized_psum, quantized_reduce_scatter,
                          reduce_scatter, twobit_psum,
                          vocab_parallel_softmax_ce)
from .mesh import Mesh, current_mesh, make_mesh, mesh_shape, set_mesh
from .pipeline import pipeline_apply, pipeline_value_and_grad
from .planner import ShardingPlan, megatron_rules
from .planning import llama_param_rule, sharding_plan
from .ring_attention import ring_attention, ring_attention_sharded
from .trainer import DataParallelTrainer


def moe_param_rule(ep_axis="ep", inner=None):
    """The parameter rule of expert parallel: an expert tensor (named
    ``expert_*``, two dimensions or more) has its leading E dimension
    sharded over ``ep_axis``; any other parameter takes ``inner``'s rule
    (a tensor-parallel one), else is replicated."""
    from .planner import PartitionSpec as P

    def rule(name, shape):
        if "expert_" in name and len(shape) >= 2:
            return P(ep_axis, *([None] * (len(shape) - 1)))
        return inner(name, shape) if inner is not None else None

    return rule


__all__ = ["DataParallelTrainer", "Mesh", "make_mesh", "set_mesh",
           "current_mesh", "mesh_shape", "collectives", "planner", "zero",
           "ShardingPlan", "megatron_rules", "moe_param_rule",
           "llama_param_rule", "sharding_plan", "pipeline_apply",
           "pipeline_value_and_grad", "ring_attention",
           "ring_attention_sharded", "quantized_psum",
           "quantized_reduce_scatter", "reduce_scatter", "twobit_psum",
           "vocab_parallel_softmax_ce"]
