"""Llama over a (tp, pp) mesh: a sharded checkpoint read onto the ranks,
pipelined fine-tuning, and the resharded save, as the JAX package's
``models/llama_spmd.py``.

* :func:`load_llama_stacked` reads an HF-layout (possibly sharded)
  safetensors checkpoint onto this rank: its pipeline stage's decoder
  layers, stacked ``(1, layers_per_stage, ...)``, and of each its
  Megatron shard over ``tp`` (q/k/v/gate/up by output rows, o/down by
  input columns; the q/k rows through the rotate-half -> adjacent-pair
  RoPE permutation), each sliced out of the checkpoint's memory map, so
  a rank reads only its own bytes.  Embedding, final norm and head are
  whole on every rank.
* :func:`make_stage_fn` is the decoder layer as a function (RMSNorm,
  GQA attention with adjacent-pair RoPE, SwiGLU) on a rank's shards, the
  ``LlamaModel`` layer's arithmetic: Megatron's pair of operators closes
  ``tp`` (an identity whose backward sums over ``tp`` before the
  column-parallel products, one sum over ``tp`` after each row-parallel
  one).  Attention is ``dot_product_attention``, which on the card is
  the flash kernels (K1 forward, K2/K3 backward).
* :func:`train_step` is one 1F1B step (``parallel.pipeline_value_and_
  grad``) whose loss is ``chunked_softmax_ce`` over the frozen head, and
  SGD on the layers; :func:`save_llama_stacked` gathers the layers back
  (inverse RoPE permutation) into an HF checkpoint that
  ``load_hf_llama`` reads, written by rank 0.

Parameters and activations are torch tensors on the mesh's device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..parallel import collectives as col
from ..parallel.planner import PartitionSpec as P
from .hf_loader import (_permute_qk, _plan_shards, _rope_perm,
                        _shard_paths, _write_index, read_safetensors,
                        write_safetensors)

__all__ = ["load_llama_stacked", "make_stage_fn", "make_chunked_loss",
           "forward_logits", "train_step", "save_llama_stacked"]

# layer-param short name -> (HF suffix, sharding kind): col = output rows
# over tp, row = input columns over tp, norm = whole
_LAYER_TABLE = {
    "q": ("self_attn.q_proj.weight", "col"),
    "k": ("self_attn.k_proj.weight", "col"),
    "v": ("self_attn.v_proj.weight", "col"),
    "o": ("self_attn.o_proj.weight", "row"),
    "gate": ("mlp.gate_proj.weight", "col"),
    "up": ("mlp.up_proj.weight", "col"),
    "down": ("mlp.down_proj.weight", "row"),
    "innorm": ("input_layernorm.weight", "norm"),
    "postnorm": ("post_attention_layernorm.weight", "norm"),
}


def _open_views(path):
    """Every tensor of the (possibly sharded) checkpoint as a view of its
    file's memory map; nothing is read until a slice is copied."""
    views = {}
    for shard in _shard_paths(path):
        views.update(read_safetensors(shard))
    return views


def _stacked_specs(tp_axis, pp_axis):
    """(pp stage, layer in stage, *tensor dims): the stage dim over pp,
    the Megatron dim over tp."""
    out = {}
    for name, (_, kind) in _LAYER_TABLE.items():
        if kind == "col":
            out[name] = P(pp_axis, None, tp_axis, None)
        elif kind == "row":
            out[name] = P(pp_axis, None, None, tp_axis)
        else:
            out[name] = P(pp_axis, None, None)
    return out


def _axis_of(mesh, axis):
    """(size, index) of ``axis`` on ``mesh`` ((1, 0) without it)."""
    if not axis or axis not in mesh.shape:
        return 1, 0
    return mesh.axis_size(axis), mesh.axis_index(axis)


def load_llama_stacked(path, mesh, num_heads, num_kv_heads,
                       rope_base=10000.0, *, tp_axis="tp", pp_axis="pp",
                       dtype=np.float32):
    """Read an HF Llama checkpoint onto this rank of a (tp, pp) mesh.

    Returns ``(params, specs, config)``: ``params["layers"]`` maps each
    layer tensor's short name to this rank's ``(1, layers_per_stage,
    ...)`` block (its stage, its tp shard; global layer id = stage *
    layers_per_stage + local index); ``params["embed"]``,
    ``["final_norm"]`` and ``["head"]`` (None for a tied checkpoint) are
    whole.  ``specs`` is the PartitionSpec of each layer tensor (for
    ``pipeline_value_and_grad(param_specs=)``), ``config`` the widths
    read from the shapes.  ``pp`` must divide the layer count, ``tp``
    the head counts and the hidden width."""
    views = _open_views(path)
    if "model.embed_tokens.weight" not in views:
        raise MXNetError(f"{path}: not a Llama checkpoint "
                         "(model.embed_tokens.weight missing)")
    vocab, units = views["model.embed_tokens.weight"].shape
    n_layers = 0
    while f"model.layers.{n_layers}.self_attn.q_proj.weight" in views:
        n_layers += 1
    if not n_layers:
        raise MXNetError(f"{path}: no decoder layers found")
    hidden = views["model.layers.0.mlp.gate_proj.weight"].shape[0]
    d = units // num_heads
    kv_rows = views["model.layers.0.self_attn.k_proj.weight"].shape[0]
    if kv_rows != num_kv_heads * d:
        raise MXNetError(
            f"k_proj rows {kv_rows} != num_kv_heads*head_dim "
            f"{num_kv_heads}*{d} — wrong num_heads/num_kv_heads?")
    tp, ti = _axis_of(mesh, tp_axis)
    pp, pi = _axis_of(mesh, pp_axis)
    if n_layers % pp:
        raise MXNetError(
            f"num_layers={n_layers} not divisible by mesh "
            f"{pp_axis}={pp} (stages must hold equal layer blocks)")
    lpp = n_layers // pp
    for what, val in (("num_heads", num_heads),
                      ("num_kv_heads", num_kv_heads),
                      ("hidden", hidden)):
        if val % tp:
            raise MXNetError(f"{what}={val} not divisible by "
                             f"{tp_axis}={tp}")
    dt = torch_dtype(dtype)
    dev = mesh.device
    perms = {"q": np.concatenate(
        [h * d + _rope_perm(d) for h in range(num_heads)]),
        "k": np.concatenate(
        [h * d + _rope_perm(d) for h in range(num_kv_heads)])}

    def shard(name, kind, v):
        if kind == "col":
            rows = v.shape[0] // tp
            sel = slice(ti * rows, (ti + 1) * rows)
            if name in perms:
                idx = torch.from_numpy(perms[name][sel])
                return v.index_select(0, idx)
            return v[sel]
        if kind == "row":
            cols = v.shape[1] // tp
            return v[:, ti * cols:(ti + 1) * cols]
        return v

    layers = {}
    for name, (suffix, kind) in _LAYER_TABLE.items():
        blocks = [shard(name, kind,
                        views[f"model.layers.{pi * lpp + j}.{suffix}"])
                  .to(device=dev, dtype=dt) for j in range(lpp)]
        layers[name] = torch.stack(blocks)[None]

    def whole(key):
        return views[key].to(device=dev, dtype=dt, copy=True)

    params = {"layers": layers, "embed": whole("model.embed_tokens.weight"),
              "final_norm": whole("model.norm.weight"),
              "head": whole("lm_head.weight") if "lm_head.weight" in views
              else None}
    config = dict(num_layers=n_layers, layers_per_stage=lpp, units=units,
                  hidden=hidden, vocab=vocab, head_dim=d,
                  num_heads=num_heads, num_kv_heads=num_kv_heads,
                  rope_base=rope_base)
    return params, _stacked_specs(tp_axis, pp_axis), config


def _rms(x, gamma, eps):
    ms = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


def make_stage_fn(config, tp_axis="tp", eps=1e-5, mesh=None):
    """The pipeline stage: ``stage(local, x)`` runs the
    ``layers_per_stage`` decoder layers of ``local`` (each leaf
    ``(layers_per_stage, ...)``, this rank's tp shards) on ``x`` (B, S,
    U).  ``mesh`` (default: the current one) holds the tp axis."""
    h, kv, d = (config["num_heads"], config["num_kv_heads"],
                config["head_dim"])
    base = config["rope_base"]

    def stage(local, x):
        ax = col._axis(tp_axis, mesh) if tp_axis and (
            mesh is None or tp_axis in mesh.shape) else None
        lpp = next(iter(local.values())).shape[0]
        for j in range(lpp):
            x = _decoder_layer({k: v[j] for k, v in local.items()},
                               x, h, kv, d, base, eps, ax)
        return x

    return stage


def _decoder_layer(lp, x, h, kv, d, base, eps, ax):
    """One decoder layer on this rank's tp shards (``ax``: the tp axis,
    or None)."""
    from ..ops.attention import dot_product_attention, rope
    tp = ax.n if ax is not None else 1
    b, s = x.shape[0], x.shape[1]
    hl, kvl = h // tp, kv // tp

    def fan_in(t):           # Megatron's f: the sum over tp backward
        return col._CopyToAxis.apply(t, ax) if ax is not None else t

    def fan_out(t):          # Megatron's g: one sum over tp
        return col._PSumReplicated.apply(t, ax) if ax is not None else t

    hx = fan_in(_rms(x, lp["innorm"], eps))
    q = rope((hx @ lp["q"].t()).reshape(b, s, hl, d), base=base)
    k = rope((hx @ lp["k"].t()).reshape(b, s, kvl, d), base=base)
    v = (hx @ lp["v"].t()).reshape(b, s, kvl, d)
    att = dot_product_attention(q, k, v, causal=True)
    x = x + fan_out(att.reshape(b, s, hl * d) @ lp["o"].t())
    hx = fan_in(_rms(x, lp["postnorm"], eps))
    gate = hx @ lp["gate"].t()
    up = hx @ lp["up"].t()
    return x + fan_out((torch.nn.functional.silu(gate) * up)
                       @ lp["down"].t())


def make_chunked_loss(params, config, tp_axis="tp", vocab_chunk=None,
                      eps=1e-5):
    """The pipeline's ``loss_fn``: final RMSNorm, then the streaming
    cross-entropy of each next token over the frozen head (or the tied
    embedding), the (N, V) logits never made; the microbatch mean.  The
    activations are whole on every tp rank, so is the loss."""
    from ..ops.nn import _chunked_ce
    head_w = params["head"] if params["head"] is not None \
        else params["embed"]
    gamma = params["final_norm"]
    chunk = int(vocab_chunk or max(64, config["vocab"] // 4))
    u = config["units"]

    def loss_fn(out_mb, y_mb):
        hid = _rms(out_mb, gamma, eps)
        pred = hid[:, :-1].reshape(-1, u)
        labels = y_mb[:, 1:].reshape(-1)
        return _chunked_ce(pred, head_w, None, labels, chunk, None).mean()

    return loss_fn


def _tokens(tokens, device):
    if not torch.is_tensor(tokens):
        tokens = torch.as_tensor(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.long)


def forward_logits(params, tokens, config, mesh, specs, *,
                   tp_axis="tp", pp_axis="pp", n_microbatches=None,
                   eps=1e-5):
    """The whole forward to logits through the GPipe pipeline (the
    parity and evaluation path)."""
    from ..parallel.pipeline import pipeline_apply
    m = n_microbatches or _axis_of(mesh, pp_axis)[0]
    x = params["embed"][_tokens(tokens, params["embed"].device)]
    stage = make_stage_fn(config, tp_axis=tp_axis, eps=eps, mesh=mesh)
    hid = pipeline_apply(stage, params["layers"], x, m, mesh=mesh,
                         axis=pp_axis, param_specs=specs)
    hid = _rms(hid, params["final_norm"], eps)
    head_w = params["head"] if params["head"] is not None \
        else params["embed"]
    return hid @ head_w.t()


def train_step(params, tokens, config, mesh, specs, *, lr=1e-2,
               tp_axis="tp", pp_axis="pp", n_microbatches=None,
               vocab_chunk=None, eps=1e-5):
    """One 1F1B fine-tuning step: the frozen embedding, the pipelined
    decoder layers (trained, tp x pp sharded), the chunked loss over the
    frozen head; SGD on the layers.  Returns ``(loss, params)`` with new
    layer tensors in the same layout."""
    from ..parallel.pipeline import pipeline_value_and_grad
    m = n_microbatches or _axis_of(mesh, pp_axis)[0]
    toks = _tokens(tokens, params["embed"].device)
    x = params["embed"][toks]
    stage = make_stage_fn(config, tp_axis=tp_axis, eps=eps, mesh=mesh)
    loss_fn = make_chunked_loss(params, config, tp_axis=tp_axis,
                                vocab_chunk=vocab_chunk, eps=eps)
    loss, grads = pipeline_value_and_grad(
        stage, params["layers"], x, toks, loss_fn, m, mesh=mesh,
        axis=pp_axis, param_specs=specs, grad_reduce_axes=(tp_axis,))
    with torch.no_grad():
        new_layers = {k: p - lr * grads[k]
                      for k, p in params["layers"].items()}
    return loss, {**params, "layers": new_layers}


def save_llama_stacked(params, dir_path, config, max_shard_bytes,
                       dtype=np.float32, metadata=None, mesh=None,
                       tp_axis="tp", pp_axis="pp"):
    """Gather the (trained) stacked layers back into an HF-layout sharded
    checkpoint (q/k rows through the inverse RoPE permutation) that
    ``load_hf_llama`` and HF tooling read.  Every rank of the mesh
    (default: the current one) takes part, each tensor gathered over tp
    and sent from its stage while its shard file is written; rank 0
    writes, so the host holds one shard file at a time.  Returns the
    index's path."""
    import torch.distributed as dist
    from ..parallel.mesh import current_mesh
    mesh = mesh if mesh is not None else current_mesh()
    h, kv, d = (config["num_heads"], config["num_kv_heads"],
                config["head_dim"])
    dt = torch_dtype(dtype)
    lpp = next(iter(params["layers"].values())).shape[1]
    tp, _ = _axis_of(mesh, tp_axis)
    pp, pi = _axis_of(mesh, pp_axis)
    u, hid_w, vocab = config["units"], config["hidden"], config["vocab"]
    shapes = {"q": (h * d, u), "k": (kv * d, u), "v": (kv * d, u),
              "o": (u, h * d), "gate": (hid_w, u), "up": (hid_w, u),
              "down": (u, hid_w), "innorm": (u,), "postnorm": (u,)}
    sources = {}                  # hf name -> (short name, layer)
    for name, (suffix, _) in _LAYER_TABLE.items():
        for i in range(config["num_layers"]):
            sources[f"model.layers.{i}.{suffix}"] = (name, i)
    whole = {"model.embed_tokens.weight": params["embed"],
             "model.norm.weight": params["final_norm"]}
    if params["head"] is not None:
        whole["lm_head.weight"] = params["head"]
    itemsize = torch.empty((), dtype=dt).element_size()
    sizes = {nm: int(np.prod(shapes[sources[nm][0]])) * itemsize
             for nm in sources}
    sizes.update({nm: t.numel() * itemsize for nm, t in whole.items()})

    def gathered(name, layer):
        stage, j = divmod(layer, lpp)
        kind = _LAYER_TABLE[name][1]
        if stage == pi:
            t = params["layers"][name][0, j]
            if kind != "norm" and tp > 1:
                t = col.all_gather(t.contiguous(), col._axis(tp_axis, mesh),
                                   axis=0 if kind == "col" else 1)
        else:
            t = torch.empty(shapes[name], dtype=params["layers"][name].dtype,
                            device=mesh.device)
        ppg = mesh.group(pp_axis) if pp > 1 else None
        if ppg is not None:
            dist.broadcast(t, dist.get_process_group_ranks(ppg)[stage],
                           group=ppg)
        return t

    def materialize(nm):
        if nm in whole:
            return whole[nm].detach().to(dt).cpu()
        name, layer = sources[nm]
        t = gathered(name, layer).detach()
        if name == "q":
            t = _permute_qk(t, h, d, invert=True)
        elif name == "k":
            t = _permute_qk(t, kv, d, invert=True)
        return t.to(dt).cpu()

    writer = mesh.rank == 0
    if writer:
        os.makedirs(dir_path, exist_ok=True)
    meta = metadata or {"format": "pt",
                        "producer": "mxnet_tpu.llama_spmd"}
    groups = _plan_shards(sizes, max_shard_bytes)
    weight_map = {}
    for i, names in enumerate(groups, start=1):
        shard = f"model-{i:05d}-of-{len(groups):05d}.safetensors"
        group = {nm: materialize(nm) for nm in names}
        if writer:
            write_safetensors(os.path.join(dir_path, shard), group,
                              metadata=meta)
        weight_map.update({nm: shard for nm in names})
        del group
    idx = os.path.join(dir_path, "model.safetensors.index.json")
    if writer:
        _write_index(idx, weight_map, sum(sizes.values()))
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
    return idx
