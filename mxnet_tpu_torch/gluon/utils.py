"""Gluon utilities (``gluon.utils``), as the JAX package's
``gluon/utils.py``: ``split_data``, ``split_and_load``,
``clip_global_norm`` and ``check_sha1``.  ``download`` raises: the port
reads datasets from files that are already there."""
from __future__ import annotations

import hashlib
import warnings

import numpy as np
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis`` into ``num_slice`` slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch "
            f"size that's a multiple of {num_slice} or set even_split=False")
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(nd.slice_axis(data, axis=batch_axis, begin=begin,
                                    end=end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis``, one slice on each context of
    ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their global 2-norm is at most
    ``max_norm``; returns the norm before the clip.  Arrays on one context
    take one ``clip_by_global_norm`` op.  With ``check_isfinite`` the
    norm is read back to the host (a sync, as in the reference), returned
    as a float, and a warning is given when it is not finite; without
    it, the norm stays an NDArray on the card."""
    if not arrays:
        raise MXNetError("clip_global_norm: no arrays")
    ctx = arrays[0].context
    if all(a.context == ctx for a in arrays):
        outs = nd.clip_by_global_norm(*arrays, max_norm=float(max_norm))
        total_norm = outs[-1]
        with torch.no_grad():
            for arr, scaled in zip(arrays, outs[:-1]):
                arr._t.copy_(scaled._t)
    else:
        total_norm = nd.sqrt(nd.add_n(*[
            nd.sum(nd.square(a.astype("float32"))).as_in_context(ctx)
            for a in arrays]))
        scale = nd.minimum(max_norm / (total_norm + 1e-8), 1.0)
        for arr in arrays:
            arr *= scale.as_in_context(arr.context).astype(arr.dtype.name)
    if check_isfinite:
        val = float(total_norm.asscalar())
        if not np.isfinite(val):
            warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                      "results will be undefined."),
                          stacklevel=2)
        return val
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether ``filename``'s SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("download() needs network access, which the port does "
                     "not use: place the file at its path instead")
