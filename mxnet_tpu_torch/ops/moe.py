"""The mixture-of-experts feed-forward op ``_contrib_MoEFFN``, as the
JAX package's ``ops/moe.py``: top-k routing over a static capacity
(GShard/Switch dense dispatch), the experts as one batched product over
the (E, C, d) buffers, and the Switch load-balancing loss.  The routing
and its counts run in int32/float32 whatever the input's type (a
bfloat16 count stops at 256).  Plain PyTorch: the JAX op is XLA einsums,
outside any Pallas kernel.  Under ``DataParallelTrainer`` with
``parallel.moe_param_rule`` the experts' leading E dimension is sharded
over the ``ep`` axis and the products on it run on each rank's experts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["moe_ffn", "moe_route"]

_ACT = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu}


def moe_route(probs, k, capacity):
    """The (T, E, C) float32 combine weights of top-``k`` routing of
    ``probs`` (T, E) into buffers of ``capacity`` slots an expert:
    tokens claim slots in token order, round by round; a token past its
    expert's capacity is dropped from that round."""
    t, e = probs.shape
    combine = probs.new_zeros((t, e, capacity), dtype=torch.float32)
    p32 = probs.to(torch.float32)
    remaining = p32
    fill = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    for _ in range(k):
        choice = remaining.argmax(dim=-1)
        onehot_i = F.one_hot(choice, e).to(torch.int32)
        onehot = onehot_i.to(torch.float32)
        pos = torch.cumsum(onehot_i, dim=0) - 1 + fill[None, :]
        pos_tok = (pos * onehot_i).sum(dim=-1)
        keep = pos_tok < capacity
        gate = (p32 * onehot).sum(dim=-1) * keep
        slot = (pos_tok[:, None] == slots[None, :]).to(torch.float32)
        combine = combine + gate[:, None, None] * onehot[:, :, None] * \
            slot[:, None, :]
        fill = fill + (onehot_i * keep[:, None]).sum(dim=0, dtype=torch.int32)
        remaining = remaining * (1.0 - onehot)
    return combine


@register("_contrib_MoEFFN", num_inputs=6, num_outputs=2)
def moe_ffn(x, gate_w, w1, b1, w2, b2, *, num_experts=1, k=1,
            capacity_factor=1.25, activation="relu"):
    """Top-k routed expert FFN: x (T, d); gate_w (d, E); w1 (E, d, h);
    b1 (E, h); w2 (E, h, d); b2 (E, d).  Returns ``(out (T, d),
    aux_loss ())``, the Switch load-balancing loss (mean token fraction
    times mean router probability an expert, times E)."""
    t, _d = x.shape
    e = int(num_experts)
    k = int(k)
    if k > e:
        raise ValueError(
            f"MoEFFN: k={k} exceeds num_experts={e}; a further routing "
            "round would silently double-dispatch to expert 0")
    logits = x @ gate_w
    probs = torch.softmax(logits, dim=-1)
    capacity = max(int(math.ceil(k * t / e * capacity_factor)), 1)
    combine = moe_route(probs, k, capacity).to(x.dtype)
    dispatch = (combine > 0).to(x.dtype)
    # the JAX op's four einsums as products whose only flattened
    # dimensions lead (E before C), so a DTensor sharded over E keeps its
    # layout through them: (E*C, T) @ (T, d), batched over E, and
    # (T, E*C) @ (E*C, d)
    e_c = e * capacity
    expert_in = (dispatch.permute(1, 2, 0).reshape(e_c, t) @ x) \
        .reshape(e, capacity, -1)
    h = _ACT[activation](torch.bmm(expert_in, w1) + b1[:, None, :])
    expert_out = torch.bmm(h, w2) + b2[:, None, :]
    out = combine.reshape(t, e_c) @ expert_out.reshape(e_c, -1)
    frac_tokens = F.one_hot(logits.argmax(-1), e).to(x.dtype).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = (frac_tokens * frac_probs).sum() * e
    return out, aux
