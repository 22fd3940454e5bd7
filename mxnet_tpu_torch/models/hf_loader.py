"""HuggingFace safetensors checkpoints for the Llama family and BERT, as
the JAX package's ``models/hf_loader.py``.

The format is written here, with no package: an 8-byte little-endian
header length, a UTF-8 JSON header mapping each tensor's name to
``{dtype, shape, data_offsets}`` (offsets into the data section that
follows), then the data.  :func:`read_safetensors` returns torch tensors
that are views of one copy-on-write memory map of the file, so a reader
that slices a tensor touches only those bytes; bfloat16 is torch's own.

RoPE: HF Llama rotates the two halves of each head (pairs (i, i+d/2));
this package's ``rope`` rotates adjacent pairs (2i, 2i+1).  The per-head
row permutation ``P[2i] = i, P[2i+1] = i + d/2`` applied to W_q and W_k
makes the two give the same attention, so :func:`load_hf_llama`
permutes q and k on the way in and :func:`export_hf_llama` permutes them
back.
"""
from __future__ import annotations

import json
import os
import re
import struct

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["read_safetensors", "write_safetensors",
           "write_safetensors_sharded", "load_hf_llama", "export_hf_llama",
           "load_hf_bert", "export_hf_bert"]

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _torch_dtype(st_dtype):
    try:
        return _DTYPES[st_dtype]
    except KeyError:
        raise MXNetError(f"safetensors dtype {st_dtype!r} unsupported")


def _as_tensor(x):
    """A CPU tensor of ``x`` (a tensor, an NDArray or array-like)."""
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        x = x.tensor
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().cpu().contiguous()


def read_safetensors(path, return_metadata=False):
    """``path`` -> ``{name: tensor}``, each a view of one memory map of
    the file (nothing is read until a tensor is used).  With
    ``return_metadata`` returns ``(tensors, metadata)``, the header's
    ``__metadata__`` ({} when absent)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise MXNetError(f"{path}: not a safetensors file (too short)")
        (hlen,) = struct.unpack("<Q", head)
        if hlen > size - 8:
            raise MXNetError(
                f"{path}: not a safetensors file (header length "
                f"{hlen} exceeds file size {size})")
        try:
            header = json.loads(f.read(hlen).decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise MXNetError(
                f"{path}: not a safetensors file ({e})") from e
    nbuf = size - 8 - hlen
    buf = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + hlen) \
        if nbuf else np.zeros(0, np.uint8)
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dt = _torch_dtype(spec["dtype"])
        lo, hi = spec["data_offsets"]
        if not (0 <= lo <= hi <= buf.size):
            raise MXNetError(
                f"{path}: tensor {name!r} data_offsets [{lo}, {hi}) "
                f"out of bounds for {buf.size}-byte data section "
                f"(truncated or malformed shard?)")
        itemsize = torch.empty((), dtype=dt).element_size()
        count = int(np.prod(spec["shape"], dtype=np.int64))
        if hi - lo != itemsize * count:
            raise MXNetError(
                f"{path}: tensor {name!r} data_offsets span "
                f"{hi - lo} bytes but dtype {spec['dtype']} × shape "
                f"{spec['shape']} needs {itemsize * count}")
        if count == 0:
            t = torch.empty(spec["shape"], dtype=dt)
        else:
            t = torch.frombuffer(buf, dtype=dt, count=count, offset=lo) \
                .reshape(spec["shape"])
        out[name] = t
    if return_metadata:
        return out, header.get("__metadata__", {}) or {}
    return out


def write_safetensors(path, tensors, metadata=None):
    """``{name: tensor | NDArray | array}`` -> one .safetensors file
    (sorted names, one contiguous data section, as the JAX package
    writes it)."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    blobs = []
    off = 0
    for name in sorted(tensors):
        t = _as_tensor(tensors[name])
        if t.dtype not in _NAMES:
            raise MXNetError(f"cannot write dtype {t.dtype} to safetensors")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        blobs.append(t)
        off += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def _plan_shards(sizes, max_shard_bytes):
    """Greedy sorted-name packing of ``{name: nbytes}`` into shard
    groups; a tensor larger than ``max_shard_bytes`` gets a shard of its
    own (tensors are never split).  Returns a list of name lists."""
    groups, cur, cur_bytes = [], [], 0
    for name in sorted(sizes):
        nb = int(sizes[name])
        if cur and cur_bytes + nb > max_shard_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nb
    if cur:
        groups.append(cur)
    return groups


def write_safetensors_sharded(dir_path, tensors, max_shard_bytes,
                              metadata=None, materialize=None):
    """Write ``tensors`` as HF-layout shards under ``dir_path``:
    ``model-0000i-of-0000n.safetensors`` and
    ``model.safetensors.index.json``.  Returns the index's path.

    Streaming form: ``tensors`` as ``{name: (shape, dtype)}`` with
    ``materialize(name) -> tensor``; each tensor is made only while its
    shard is written, so the host holds one shard, not the model."""
    os.makedirs(dir_path, exist_ok=True)
    if materialize is None:
        tensors = {k: _as_tensor(v) for k, v in tensors.items()}
        sizes = {k: v.numel() * v.element_size()
                 for k, v in tensors.items()}
        fetch = tensors.__getitem__
    else:
        sizes = {}
        for k, (shape, dt) in tensors.items():
            dt = dt if isinstance(dt, torch.dtype) else \
                torch.from_numpy(np.zeros(0, dt)).dtype
            sizes[k] = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dt).element_size()
        fetch = materialize
    groups = _plan_shards(sizes, max_shard_bytes)
    n = len(groups)
    weight_map, total = {}, 0
    for i, names in enumerate(groups, start=1):
        shard = f"model-{i:05d}-of-{n:05d}.safetensors"
        group = {name: fetch(name) for name in names}
        write_safetensors(os.path.join(dir_path, shard), group,
                          metadata=metadata)
        for name in names:
            weight_map[name] = shard
            total += sizes[name]
        del group
    idx_path = os.path.join(dir_path, "model.safetensors.index.json")
    _write_index(idx_path, weight_map, total)
    return idx_path


def _write_index(idx_path, weight_map, total):
    """The ``model.safetensors.index.json`` of a sharded checkpoint."""
    with open(idx_path, "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)


def _shard_paths(path):
    """A file, a sharded index json, or a directory -> ordered shards."""
    if os.path.isdir(path):
        idx = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(idx):
            return _shard_paths(idx)
        one = os.path.join(path, "model.safetensors")
        if os.path.exists(one):
            return [one]
        shards = sorted(
            os.path.join(path, p) for p in os.listdir(path)
            if p.endswith(".safetensors"))
        if shards:
            return shards
        raise MXNetError(f"no .safetensors files under {path}")
    if path.endswith(".index.json"):
        with open(path) as f:
            idx = json.load(f)
        d = os.path.dirname(path)
        return [os.path.join(d, p)
                for p in sorted(set(idx["weight_map"].values()))]
    return [path]


def _rope_perm(d):
    """Half-split -> adjacent-pair row order for one head."""
    p = np.empty(d, np.int64)
    p[0::2] = np.arange(d // 2)
    p[1::2] = np.arange(d // 2) + d // 2
    return p


def _permute_qk(w, n_heads, d, invert=False):
    """Permute the per-head rows of a (n_heads*d, U) projection between
    HF's rotate-half and this package's adjacent-pair RoPE."""
    w = _as_tensor(w) if not torch.is_tensor(w) else w
    p = _rope_perm(d)
    if invert:
        inv = np.empty_like(p)
        inv[p] = np.arange(d)
        p = inv
    idx = torch.from_numpy(p).to(w.device)
    return w.reshape(n_heads, d, -1)[:, idx].reshape(n_heads * d, -1)


_LAYER_TAILS = {
    "innorm_gamma": ("input_layernorm.weight", "plain"),
    "postnorm_gamma": ("post_attention_layernorm.weight", "plain"),
    "attn_q_weight": ("self_attn.q_proj.weight", "q"),
    "attn_k_weight": ("self_attn.k_proj.weight", "k"),
    "attn_v_weight": ("self_attn.v_proj.weight", "plain"),
    "attn_o_weight": ("self_attn.o_proj.weight", "plain"),
    "mlp_gate_weight": ("mlp.gate_proj.weight", "plain"),
    "mlp_up_weight": ("mlp.up_proj.weight", "plain"),
    "mlp_down_weight": ("mlp.down_proj.weight", "plain"),
}


def _name_map(net):
    """our param name -> (hf name, kind) for a LlamaForCausalLM."""
    ours = {}
    for name in net.collect_params():
        if name.endswith("embed_weight"):
            ours[name] = ("model.embed_tokens.weight", "plain")
        elif name.endswith("finalnorm_gamma"):
            ours[name] = ("model.norm.weight", "plain")
        elif name.endswith("head_weight"):
            ours[name] = ("lm_head.weight", "plain")
        else:
            m = re.search(r"layer(\d+)_(\w+)$", name)
            if not m or m.group(2) not in _LAYER_TAILS:
                raise MXNetError(f"unmapped param {name!r}")
            hf, kind = _LAYER_TAILS[m.group(2)]
            ours[name] = (f"model.layers.{int(m.group(1))}.{hf}", kind)
    return ours


def _read_all(path):
    tensors = {}
    for shard in _shard_paths(path):
        tensors.update(read_safetensors(shard))
    return tensors


def _assign_params(net, nmap, tensors, ctx, dtype, strict,
                   transform=None):
    """Copy each mapped checkpoint tensor into its parameter (strict:
    a missing one raises; else the parameter keeps its values), after
    the kind's transform and a shape check.  Returns the checkpoint
    names used."""
    from ..base import torch_dtype
    from ..ndarray.ndarray import NDArray
    used = set()
    for name, param in net.collect_params().items():
        hf_name, kind = nmap[name]
        if hf_name not in tensors:
            if not strict:
                continue
            raise MXNetError(
                f"checkpoint missing {hf_name!r} (for {name!r})")
        arr = tensors[hf_name].to(torch.float32)
        if transform is not None:
            arr = transform(kind, arr)
        if tuple(arr.shape) != tuple(param.shape):
            raise MXNetError(
                f"{hf_name!r} shape {tuple(arr.shape)} != {name!r} "
                f"shape {tuple(param.shape)}")
        # in place, into the parameter's own device and type (``ctx``
        # and ``dtype`` round the values through ``dtype`` first)
        param.set_data(NDArray(arr.to(torch_dtype(dtype))))
        used.add(hf_name)
    return used


def _check_extras(tensors, used, ignore):
    extra = {t for t in tensors if t not in used and not ignore(t)}
    if extra:
        raise MXNetError(
            f"checkpoint tensors with no destination: "
            f"{sorted(extra)[:8]}{'...' if len(extra) > 8 else ''}")


def load_hf_llama(net, path, ctx=None, dtype="float32", strict=True):
    """Load HF Llama/Mistral safetensors weights (one file, a sharded
    index, or a directory) into an initialized ``LlamaForCausalLM``.

    A tied net may read a checkpoint without ``lm_head.weight``; an
    untied one needs it.  ``strict`` raises on missing or unused
    tensors (the rotary ``inv_freq`` buffers are always ignored);
    ``strict=False`` leaves a missing parameter as it is."""
    tensors = _read_all(path)
    attn = net.model.layers[0].attn
    h, kv, d = attn._h, attn._kv, attn._d

    def transform(kind, arr):
        if kind == "q":
            return _permute_qk(arr, h, d)
        if kind == "k":
            return _permute_qk(arr, kv, d)
        return arr

    used = _assign_params(net, _name_map(net), tensors, ctx, dtype,
                          strict, transform)
    # a tied net maps no parameter to lm_head.weight; a checkpoint that
    # ships one anyway loads only if it is the embedding
    if getattr(net, "_tied", False) and "lm_head.weight" in tensors \
            and "lm_head.weight" not in used:
        head = tensors["lm_head.weight"].to(torch.float32)
        emb = tensors["model.embed_tokens.weight"].to(torch.float32)
        if head.shape != emb.shape or not torch.allclose(head, emb):
            raise MXNetError(
                "checkpoint has an UNTIED lm_head.weight but the net "
                "was built with tie_embeddings=True — rebuild with "
                "tie_embeddings=False or the head would be silently "
                "replaced by the embedding")
        used.add("lm_head.weight")
    if strict:
        _check_extras(tensors, used, lambda t: "rotary_emb" in t)
    return net


def _param_tensor(param):
    data = param.data()
    return data.tensor if hasattr(data, "tensor") else data


def export_hf_llama(net, path, dtype=np.float32, metadata=None,
                    max_shard_bytes=None):
    """Write a ``LlamaForCausalLM``'s weights as one HF-layout
    safetensors file (q/k rows permuted back to rotate-half order), or,
    with ``max_shard_bytes``, as shards and an index in the directory
    ``path``.  ``dtype`` is the file's type (``np.float32``,
    ``"bfloat16"``, a torch dtype ...); each tensor is converted as it
    is written."""
    from ..base import torch_dtype
    dt = torch_dtype(dtype) if not isinstance(dtype, torch.dtype) else dtype
    attn = net.model.layers[0].attn
    h, kv, d = attn._h, attn._kv, attn._d
    nmap = _name_map(net)
    params = net.collect_params()
    meta = metadata or {"format": "pt", "producer": "mxnet_tpu"}

    def materialize(hf_name):
        name, kind = back[hf_name]
        t = _param_tensor(params[name]).detach()
        if kind == "q":
            t = _permute_qk(t, h, d, invert=True)
        elif kind == "k":
            t = _permute_qk(t, kv, d, invert=True)
        return t.to(dt).cpu()

    back = {hf: (name, kind) for name, (hf, kind) in nmap.items()}
    if max_shard_bytes is not None:
        specs = {hf: (tuple(params[name].shape), dt)
                 for hf, (name, _k) in back.items()}
        return write_safetensors_sharded(path, specs, max_shard_bytes,
                                         metadata=meta,
                                         materialize=materialize)
    write_safetensors(path, {hf: materialize(hf) for hf in back},
                      metadata=meta)


# -- BERT (HF bert-base layout) ---------------------------------------------

_BERT_LAYER_TABLE = {
    "multiheadattention0_query_weight": "attention.self.query.weight",
    "multiheadattention0_query_bias": "attention.self.query.bias",
    "multiheadattention0_key_weight": "attention.self.key.weight",
    "multiheadattention0_key_bias": "attention.self.key.bias",
    "multiheadattention0_value_weight": "attention.self.value.weight",
    "multiheadattention0_value_bias": "attention.self.value.bias",
    "multiheadattention0_out_weight": "attention.output.dense.weight",
    "multiheadattention0_out_bias": "attention.output.dense.bias",
    "positionwiseffn0_ffn1_weight": "intermediate.dense.weight",
    "positionwiseffn0_ffn1_bias": "intermediate.dense.bias",
    "positionwiseffn0_ffn2_weight": "output.dense.weight",
    "positionwiseffn0_ffn2_bias": "output.dense.bias",
    "layernorm0_gamma": "attention.output.LayerNorm.weight",
    "layernorm0_beta": "attention.output.LayerNorm.bias",
    "layernorm1_gamma": "output.LayerNorm.weight",
    "layernorm1_beta": "output.LayerNorm.bias",
}


def _bert_name_map(net):
    """our param name -> HF name for a BERTModel (post-LN encoder:
    layernorm0 is the post-attention norm, layernorm1 the post-FFN)."""
    out = {}
    for name in net.collect_params():
        m = re.search(r"enc_layer(\d+)_(\w+)$", name)
        if m:
            i, tail = int(m.group(1)), m.group(2)
            if tail not in _BERT_LAYER_TABLE:
                raise MXNetError(f"unmapped BERT param {name!r}")
            out[name] = f"encoder.layer.{i}." + _BERT_LAYER_TABLE[tail]
        elif name.endswith("position_embed"):
            out[name] = "embeddings.position_embeddings.weight"
        elif name.endswith("word_embed_weight"):
            out[name] = "embeddings.word_embeddings.weight"
        elif name.endswith("type_embed_weight"):
            out[name] = "embeddings.token_type_embeddings.weight"
        elif name.endswith("layernorm0_gamma"):
            out[name] = "embeddings.LayerNorm.weight"
        elif name.endswith("layernorm0_beta"):
            out[name] = "embeddings.LayerNorm.bias"
        elif name.endswith("pooler_weight"):
            out[name] = "pooler.dense.weight"
        elif name.endswith("pooler_bias"):
            out[name] = "pooler.dense.bias"
        else:
            raise MXNetError(f"unmapped BERT param {name!r}")
    return out


def load_hf_bert(net, path, ctx=None, dtype="float32", strict=True):
    """Load HF ``bert-base``-layout safetensors into a ``BERTModel``,
    with or without the ``bert.`` prefix of a task model; the task heads
    (``cls.*``) are ignored.  ``strict=False`` leaves a missing
    parameter as it is.  Shapes must be known (a deferred net runs one
    forward first)."""
    tensors = _read_all(path)
    if any(t.startswith("bert.") for t in tensors):
        tensors = {(t[5:] if t.startswith("bert.") else t): v
                   for t, v in tensors.items()}
    nmap = {k: (v, "plain") for k, v in _bert_name_map(net).items()}
    used = _assign_params(net, nmap, tensors, ctx, dtype, strict)
    if strict:
        _check_extras(tensors, used,
                      lambda t: t.startswith("cls.")
                      or "position_ids" in t)
    return net


def export_hf_bert(net, path, dtype=np.float32, metadata=None):
    """Write a ``BERTModel`` as HF bert-base-layout safetensors (the
    inverse of :func:`load_hf_bert`)."""
    from ..base import torch_dtype
    dt = torch_dtype(dtype) if not isinstance(dtype, torch.dtype) else dtype
    nmap = _bert_name_map(net)
    out = {nmap[name]: _param_tensor(p).detach().to(dt).cpu()
           for name, p in net.collect_params().items()}
    write_safetensors(path, out, metadata=metadata or
                      {"format": "pt", "producer": "mxnet_tpu"})
