"""Sharding plans before any tensor exists, as the JAX package's
``parallel/planning.py``: the Megatron layout of the Llama family
(:func:`llama_param_rule`) and the exact per-device parameter memory of
a block on a mesh (:func:`sharding_plan`), pure shape arithmetic over
``collect_params()``.  The default budget is one H100's 80 GB.
"""
from __future__ import annotations

import re

from ..base import MXNetError

__all__ = ["llama_param_rule", "sharding_plan"]

#: one H100's device memory
_HBM_BYTES = 80 * 1000 ** 3

_COL = ("_attn_q_weight", "_attn_k_weight", "_attn_v_weight",
        "_mlp_gate_weight", "_mlp_up_weight")
_ROW = ("_attn_o_weight", "_mlp_down_weight")
_VOCAB = ("_embed_weight", "_head_weight")


def llama_param_rule(tp_axis: str = "tp"):
    """Megatron-style tensor-parallel layout for the Llama family.

    Column-parallel: q/k/v and gate/up projections (output dim
    sharded — the following op consumes the shard locally);
    row-parallel: o and down projections (input dim sharded — XLA
    inserts the psum); vocab-sharded: embedding + untied LM head;
    norms replicated.  Returns a ``(name, shape) -> PartitionSpec``
    rule for ``DataParallelTrainer(param_sharding=...)`` /
    :func:`sharding_plan`.
    """
    from .planner import PartitionSpec as P

    def rule(name, shape):
        if name.endswith(_COL) or name.endswith(_VOCAB):
            return P(tp_axis, None)
        if name.endswith(_ROW):
            return P(None, tp_axis)
        return None

    return rule


def _layer_stage(name: str, num_layers: int, num_stages: int):
    """Pipeline stage for a param: decoder layer i goes to stage
    i // ceil(L / S); embedding to the first stage, head/final norm to
    the last (the GPipe layout ``parallel.pipeline_apply`` uses)."""
    m = re.search(r"layer(\d+)_", name)
    if m:
        per = -(-num_layers // num_stages)
        return min(int(m.group(1)) // per, num_stages - 1)
    if name.endswith(_VOCAB[0]):       # embedding
        return 0
    return num_stages - 1              # head, final norm


def sharding_plan(block, mesh=None, rule=None, dtype_bytes: int = 2,
                  pp_axis: str = None, hbm_bytes: int = _HBM_BYTES):
    """Exact per-device parameter-memory plan for ``block`` on ``mesh``.

    Pure shape math over ``collect_params()`` (no initialization, no
    arrays): each param's bytes are divided by the product of the mesh
    axes its PartitionSpec uses; with ``pp_axis``, params are assigned
    to pipeline stages and the busiest stage reported.  Returns a dict:
    ``total_params``, ``per_stage_bytes`` (list, one per stage),
    ``max_device_bytes``, ``fits_hbm``, ``hbm_fraction``.

    ``rule`` may be a ``(name, shape) -> PartitionSpec`` callable OR a
    :class:`~.planner.ShardingPlan` — the planner's
    regex rules, pp axis, and mesh axes then drive the memory math
    (``mesh`` may be omitted: the plan describes it).
    """
    from .planner import ShardingPlan
    plan_obj = None
    if isinstance(rule, ShardingPlan):
        plan_obj = rule
        if pp_axis is None and plan_obj.n_stages > 1:
            pp_axis = plan_obj.pp_axis
        rule = plan_obj.partition_spec
        if mesh is None:
            mesh = dict(plan_obj.axes)   # shape math needs no devices
    elif mesh is None:
        raise MXNetError("sharding_plan needs a mesh (or a "
                         "ShardingPlan rule that describes one)")
    # a Mesh or a plain {axis: size} dict: the math only reads sizes
    axis_sizes = dict(mesh.shape) if hasattr(mesh, "shape") else \
        {str(k): int(v) for k, v in dict(mesh).items()}
    params = {name: tuple(int(d) for d in p.shape)
              for name, p in block.collect_params().items()}
    for name, shape in params.items():
        if any(d <= 0 for d in shape):
            raise MXNetError(
                f"param {name!r} has unresolved shape {shape}; declare "
                "in_units/in_channels so the plan needs no forward")
    num_stages = int(axis_sizes[pp_axis]) if pp_axis else 1
    layer_ids = [int(m.group(1)) for n in params
                 for m in [re.search(r"layer(\d+)_", n)] if m]
    num_layers = max(layer_ids) + 1 if layer_ids else 1

    total_params = 0
    per_stage = [0] * num_stages
    for name, shape in params.items():
        n_elem = 1
        for d in shape:
            n_elem *= d
        total_params += n_elem
        shards = 1
        spec = rule(name, shape) if rule is not None else None
        if spec is not None:
            for part in spec:
                for ax in ([part] if isinstance(part, str) else
                           (part or ())):
                    shards *= int(axis_sizes[ax])
        if num_stages <= 1:
            stage = 0
        elif plan_obj is not None:
            # the plan's stage_rules override the layer-number layout
            stage = plan_obj.stage_of(name, num_layers)
        else:
            stage = _layer_stage(name, num_layers, num_stages)
        per_stage[stage] += -(-n_elem // shards) * dtype_bytes
    max_dev = max(per_stage)
    return {
        "total_params": total_params,
        "per_stage_bytes": per_stage,
        "max_device_bytes": max_dev,
        "fits_hbm": max_dev <= hbm_bytes,
        "hbm_fraction": max_dev / hbm_bytes,
    }
