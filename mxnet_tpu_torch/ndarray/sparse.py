"""Sparse NDArrays (``mx.nd.sparse``), as the JAX package's
``ndarray/sparse.py``, with the same storage decisions:

* **row_sparse** arrays are dense buffers that carry ``stype`` metadata
  (``attach_grad(stype="row_sparse")``, ``Embedding(sparse_grad=True)``):
  ``indices`` are the rows with any nonzero and ``data`` those rows, read
  from the buffer.  The optimizers' lazy update leaves the other rows
  alone (``ops/optimizer_ops.py`` ``_row_mask``), over the dense buffer.
* **csr** arrays built from ``(data, indices, indptr)``, and row_sparse
  arrays built from ``(data, indices)``, store only those parts until a
  generic op reads the array (``_t``), which makes the dense tensor once.
  :func:`dot` and :func:`retain` work on the stored parts; duplicate
  ``(row, col)`` entries of a csr array sum, in ``dot`` and in the dense
  tensor alike.

``torch.sparse`` is not used: its notion of a stored entry (an index is
present) is not the reference's touched row (a nonzero is present).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import current_context
from .ndarray import NDArray, array, invoke

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix",
           "row_sparse_array", "zeros", "dot", "retain"]

_dense_t = NDArray._t          # the base class's slot descriptor


def _csr_rows(iptr, nnz):
    """The row of each of the ``nnz`` stored values."""
    return torch.searchsorted(iptr, torch.arange(nnz, device=iptr.device),
                              right=True) - 1


class _SparseFacade(NDArray):
    """An NDArray that may hold only compressed parts (``_parts``, the
    shape last) until a generic op reads its tensor."""

    __slots__ = ("_parts",)
    _stype = "default"

    def __init__(self, data, ctx=None):
        self._parts = None
        if data is None:
            self._ctx = ctx
            self.grad_req = "null"
            self._grad = None
        else:
            super().__init__(data, ctx=ctx)

    def _densify(self):  # pragma: no cover - overridden
        raise NotImplementedError

    @property
    def _t(self):
        if self.is_compressed:
            _dense_t.__set__(self, self._densify())
        return _dense_t.__get__(self)

    @_t.setter
    def _t(self, value):
        _dense_t.__set__(self, value)

    @property
    def is_compressed(self):
        """True while no dense tensor has been made."""
        try:
            _dense_t.__get__(self)
            return False
        except AttributeError:
            return self._parts is not None

    @property
    def shape(self):
        return tuple(self._parts[-1]) if self.is_compressed \
            else NDArray.shape.fget(self)

    @property
    def dtype(self):
        return numpy_dtype(self._parts[0].dtype) if self.is_compressed \
            else NDArray.dtype.fget(self)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def stype(self):
        return self._stype

    def tostype(self, stype):
        """This array under storage type ``stype`` (a copy)."""
        return tostype(self, stype)


class CSRNDArray(_SparseFacade):
    """Compressed sparse rows: ``_parts`` = (values, column indices,
    indptr, shape) while compressed."""

    __slots__ = ()
    _stype = "csr"

    def _densify(self):
        vals, idx, iptr, shape = self._parts
        rows = _csr_rows(iptr, vals.shape[0])
        out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        # accumulate: duplicate (row, col) entries sum, as in dot
        return out.index_put_((rows, idx), vals, accumulate=True)

    @property
    def indices(self):
        if self.is_compressed:
            return NDArray(self._parts[1].long(), ctx=self._ctx)
        a = self.asnumpy()
        return array(np.nonzero(a)[1], ctx=self._ctx, dtype="int64")

    @property
    def indptr(self):
        if self.is_compressed:
            return NDArray(self._parts[2].long(), ctx=self._ctx)
        a = self.asnumpy()
        counts = (a != 0).sum(axis=1)
        return array(np.concatenate([[0], np.cumsum(counts)]),
                     ctx=self._ctx, dtype="int64")

    @property
    def data(self):
        if self.is_compressed:
            return NDArray(self._parts[0], ctx=self._ctx)
        a = self.asnumpy()
        return array(a[a != 0], ctx=self._ctx, dtype=a.dtype)


def _touched_rows(a):
    return np.nonzero(np.any(a != 0, axis=tuple(range(1, a.ndim))))[0]


class RowSparseNDArray(_SparseFacade):
    """Row-sparse: a dense buffer whose rows with a nonzero are the
    stored ones, or ``_parts`` = (row values, row indices, shape) while
    compressed."""

    __slots__ = ()
    _stype = "row_sparse"

    def _densify(self):
        vals, idx, shape = self._parts
        out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        out[idx] = vals
        return out

    @property
    def indices(self):
        if self.is_compressed:
            return NDArray(self._parts[1].long(), ctx=self._ctx)
        return array(_touched_rows(self.asnumpy()), ctx=self._ctx,
                     dtype="int64")

    @property
    def data(self):
        if self.is_compressed:
            return NDArray(self._parts[0], ctx=self._ctx)
        a = self.asnumpy()
        return array(a[_touched_rows(a)], ctx=self._ctx, dtype=a.dtype)


_CLASSES = {"csr": CSRNDArray, "row_sparse": RowSparseNDArray}


def tostype(arr, stype):
    """A copy of ``arr`` under storage type ``stype`` (``"default"``,
    ``"row_sparse"`` or ``"csr"``), over a dense tensor."""
    t = arr._t.detach().clone()
    if stype == "default":
        return NDArray(t, ctx=arr.context)
    if stype not in _CLASSES:
        raise MXNetError(f"unknown storage type {stype!r}")
    return _CLASSES[stype](t, ctx=arr.context)


def _compressed(cls, parts, ctx):
    out = cls(None, ctx=ctx)
    out._parts = parts
    return out


def csr_matrix(arg1, shape=None, ctx=None, dtype="float32"):
    """A csr array from a dense array-like, or (compressed) from
    ``(data, indices, indptr)`` with ``shape``."""
    if isinstance(arg1, (list, np.ndarray, NDArray)):
        base = array(arg1, ctx=ctx, dtype=dtype)
        return CSRNDArray(base._t, ctx=base.context)
    data, indices, indptr = arg1
    if shape is None:
        raise MXNetError("csr_matrix from (data, indices, indptr) "
                         "requires shape=")
    vals = np.asarray(data, dtype=dtype)
    idx = np.asarray(indices, dtype="int64")
    iptr = np.asarray(indptr, dtype="int64")
    if iptr.shape[0] != int(shape[0]) + 1:
        raise MXNetError(f"indptr length {iptr.shape[0]} != shape[0]+1 "
                         f"({int(shape[0]) + 1})")
    if iptr.size and (iptr[0] != 0 or iptr[-1] != vals.size
                      or (np.diff(iptr) < 0).any()):
        raise MXNetError(f"invalid indptr: must start at 0, end at nnz "
                         f"({vals.size}) and be non-decreasing")
    if idx.size and (idx.min() < 0 or idx.max() >= int(shape[1])):
        raise MXNetError(f"column indices out of range for shape "
                         f"{tuple(shape)}")
    if idx.shape[0] != vals.shape[0]:
        raise MXNetError("data and indices must have equal length")
    ctx = ctx or current_context()
    dev = ctx.device
    parts = (torch.from_numpy(vals).to(dev, torch_dtype(dtype)),
             torch.from_numpy(idx).to(dev), torch.from_numpy(iptr).to(dev),
             tuple(int(d) for d in shape))
    return _compressed(CSRNDArray, parts, ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype="float32"):
    """A row_sparse array from a dense array-like, or (compressed) from
    ``(data, indices)`` with ``shape``: sorted unique row indices."""
    if isinstance(arg1, (list, np.ndarray, NDArray)) and shape is None:
        base = array(arg1, ctx=ctx, dtype=dtype)
        return RowSparseNDArray(base._t, ctx=base.context)
    data, indices = arg1
    if shape is None:
        raise MXNetError("row_sparse_array from (data, indices) requires "
                         "shape=")
    vals = np.asarray(data, dtype=dtype)
    idx = np.asarray(indices, dtype="int64")
    if vals.shape[0] != idx.shape[0]:
        raise MXNetError("data and indices must have equal length")
    if vals.ndim != len(shape) or \
            vals.shape[1:] != tuple(int(d) for d in shape[1:]):
        raise MXNetError(f"data shape {vals.shape} incompatible with "
                         f"row-sparse shape {tuple(shape)} (need (k,) + "
                         "shape[1:])")
    if idx.size and (idx.min() < 0 or idx.max() >= int(shape[0])):
        raise MXNetError(f"row indices out of range for shape "
                         f"{tuple(shape)}")
    if idx.size > 1 and not (np.diff(idx) > 0).all():
        raise MXNetError("row indices must be strictly increasing "
                         "(sorted, unique): the row_sparse contract")
    ctx = ctx or current_context()
    dev = ctx.device
    parts = (torch.from_numpy(vals).to(dev, torch_dtype(dtype)),
             torch.from_numpy(idx).to(dev), tuple(int(d) for d in shape))
    return _compressed(RowSparseNDArray, parts, ctx)


def retain(data, indices):
    """Only the rows ``indices`` of ``data`` (``mx.nd.sparse.retain``):
    on a compressed row_sparse array a selection of its stored rows, else
    the dense tensor with the other rows zeroed."""
    keep = np.asarray(indices.asnumpy() if isinstance(indices, NDArray)
                      else indices, dtype="int64")
    n_rows = int(data.shape[0])
    if keep.size and (keep.min() < 0 or keep.max() >= n_rows):
        raise MXNetError(f"retain: indices out of range for {n_rows} rows")
    if isinstance(data, RowSparseNDArray) and data.is_compressed:
        vals, idx, shape = data._parts
        sel = np.nonzero(np.isin(idx.cpu().numpy(), keep))[0]
        sel = torch.from_numpy(sel).to(vals.device)
        return _compressed(RowSparseNDArray, (vals[sel], idx[sel], shape),
                           data.context)
    t = data._t.detach()
    mask = torch.zeros(n_rows, dtype=torch.bool, device=t.device)
    mask[torch.from_numpy(keep).to(t.device)] = True
    mask = mask.reshape((-1,) + (1,) * (t.dim() - 1))
    return RowSparseNDArray(torch.where(mask, t, torch.zeros_like(t)),
                            ctx=data.context)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``mx.nd.sparse.dot``.  A compressed csr ``lhs`` and a dense
    ``rhs`` outside ``autograd.record()``: a scatter-add over the stored
    values only, the lhs left compressed.  Anything else is the dense
    ``dot`` op (recorded, so gradients flow)."""
    from .. import autograd
    if isinstance(lhs, CSRNDArray) and lhs.is_compressed and \
            isinstance(rhs, NDArray) and \
            not isinstance(rhs, _SparseFacade) and \
            not autograd.is_recording():
        vals, idx, iptr, shape = lhs._parts
        r = rhs._t.detach()
        if transpose_b:
            r = r.t()
        squeeze = r.dim() == 1
        if squeeze:
            r = r[:, None]
        want = shape[0] if transpose_a else shape[1]
        if int(r.shape[0]) != want:
            raise MXNetError(
                f"sparse.dot: lhs {shape}{'^T' if transpose_a else ''} "
                f"incompatible with rhs {tuple(rhs.shape)}")
        rows = _csr_rows(iptr, vals.shape[0])
        src, dst = (rows, idx) if transpose_a else (idx, rows)
        out_rows = shape[1] if transpose_a else shape[0]
        res = torch.zeros((out_rows, r.shape[1]), dtype=vals.dtype,
                          device=vals.device)
        res.index_add_(0, dst, vals[:, None] * r[src])
        return NDArray(res[:, 0] if squeeze else res, ctx=lhs.context)
    from ..ops.registry import get_op
    return invoke(get_op("dot"), [lhs, rhs], transpose_a=transpose_a,
                  transpose_b=transpose_b)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """Zeros of storage type ``stype``."""
    from .ndarray import zeros as _dense_zeros
    base = _dense_zeros(shape, ctx=ctx, dtype=dtype)
    if stype == "default":
        return base
    return _CLASSES[stype](base._t, ctx=base.context)
