"""ZeRO-1/2 sharding of a dp>1 ``DataParallelTrainer``'s update, the
host side, as the JAX package's ``parallel/zero.py``: the stage
(``MXTPU_ZERO_STAGE``) and whether a trainer can shard its update.  The
step itself (the gradient leg, the update of the rank's slice, the
all-gather) is in ``parallel/trainer.py``: a parameter's flat is
zero-padded to a multiple of the dp size n, and rank r updates elements
``[r chunk, (r+1) chunk)`` against states of that slice alone (1/n of
the replicated bytes)."""
from __future__ import annotations

from typing import Optional

from ..base import MXNetError

__all__ = ["stage_from_env", "eligibility"]


def stage_from_env() -> int:
    """``MXTPU_ZERO_STAGE``: 0 (off), 1 (sharded states, all-reduce
    gradient leg) or 2 (sharded states, reduce-scatter leg)."""
    from .. import envs
    stage = int(envs.get("MXTPU_ZERO_STAGE"))
    if stage not in (0, 1, 2):
        raise MXNetError(
            f"MXTPU_ZERO_STAGE must be 0, 1, or 2, got {stage}")
    return stage


def eligibility(fuse_step, compression, optimizer,
                param_sharding=None) -> Optional[str]:
    """None when a trainer can run the sharded update, else why not (the
    reference's reasons: every fused rule is pointwise in the flat
    parameter, so only these remain)."""
    if param_sharding is not None:
        return ("ZeRO shards the UPDATE of dp-replicated params; a "
                "param_sharding (tensor-parallel) rule already shards "
                "the params themselves")
    if not fuse_step:
        return ("ZeRO needs fuse_step=True (the sharded update lives "
                "inside the step)")
    if compression and compression["type"] != "int8":
        return ("2bit compression carries full-size residuals a rank, "
                "which the sharded gradient leg cannot")
    if optimizer.multi_precision:
        return "multi-precision states are not sharded"
    return None
