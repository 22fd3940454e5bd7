"""NDArray: the imperative array of ``mx.nd``, over one ``torch.Tensor``.

As the JAX package's ``ndarray/ndarray.py``, on PyTorch:

* An NDArray wraps one tensor on its context's device.  Work is
  asynchronous on the device's current CUDA stream; ``wait_to_read``,
  ``asnumpy``, ``asscalar`` and ``waitall`` are the sync points, and an
  error from an earlier launch surfaces there as ``MXNetError``.
* Basic indexing (``x[1:3]``, ``x[0]``), ``reshape`` and ``detach`` share
  the tensor's storage, so a write through one is seen by the other;
  every op returns a new array.  ``out=``, ``__setitem__``, ``copyto``
  and the in-place operators write into the existing tensor.
* Ops run under ``torch.no_grad()`` unless ``autograd.record()`` is on;
  then they run with PyTorch's autograd, and an in-place write raises
  ``MXNetError``, as the reference does.
* MXNet's type rules: Python lists and float64 arrays become float32,
  scalar operands keep the array's type, comparisons return 0/1 in the
  input's type.
"""
from __future__ import annotations

import builtins
from typing import Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError, dtype_name, numeric_types, numpy_dtype, \
    torch_dtype
from ..context import Context, cpu, current_context, gpu
from ..ops.registry import OpDef, get_op

__all__ = ["NDArray", "invoke", "array", "empty", "zeros", "ones", "full",
           "arange", "eye", "concatenate", "waitall", "moveaxis"]


def _ctx_of(device: torch.device) -> Context:
    return gpu(device.index or 0) if device.type == "cuda" else cpu()


def _sync_error(where, e):
    return MXNetError(f"async execution error surfaced at {where}(): {e}")


class NDArray:
    """Mutable device array over one ``torch.Tensor`` (``_t``)."""

    __slots__ = ("_t", "_ctx", "grad_req", "_grad", "__weakref__")

    # make NumPy defer to NDArray.__radd__ etc.
    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor, ctx: Optional[Context] = None):
        self._t = data
        self._ctx = ctx if ctx is not None else _ctx_of(data.device)
        self.grad_req = "null"
        self._grad = None

    # -- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._t.dtype)

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def size(self):
        return self._t.numel()

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return invoke(get_op("transpose"), [self])

    @property
    def grad(self):
        return self._grad

    @property
    def tensor(self) -> torch.Tensor:
        """The underlying ``torch.Tensor`` (shares storage)."""
        return self._t

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        body = str(self.asnumpy())
        return (f"\n{body}\n<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self._ctx}>")

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asscalar())

    # -- sync points ------------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A host copy; a sync point, where an error of an earlier
        asynchronous launch surfaces as ``MXNetError``."""
        try:
            t = self._t.detach()
            if t.dtype == torch.bfloat16:
                return t.float().cpu().numpy().astype(numpy_dtype(t.dtype))
            a = t.cpu().numpy()
        except MXNetError:
            raise
        except RuntimeError as e:
            raise _sync_error("asnumpy", e) from e
        return a.copy() if t.device.type == "cpu" else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Wait for the work queued on this array's stream."""
        if self._t.device.type != "cuda":
            return
        try:
            torch.cuda.current_stream(self._t.device).synchronize()
        except RuntimeError as e:
            raise _sync_error("wait_to_read", e) from e

    def wait_to_write(self):
        self.wait_to_read()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- dtype / device movement -----------------------------------------
    def astype(self, dtype, copy=True):
        if torch_dtype(dtype) == self._t.dtype and not copy:
            return self
        return invoke(get_op("cast"), [self], dtype=dtype_name(
            torch_dtype(dtype)))

    def copy(self) -> "NDArray":
        return self.copyto(self._ctx)

    def copyto(self, other) -> "NDArray":
        """Copy into the NDArray ``other`` (cast to its type, in place),
        or onto the Context ``other`` as a new array."""
        if isinstance(other, NDArray):
            if other is self:
                raise MXNetError("copyto: source and target are the same")
            with torch.no_grad():
                other._t.copy_(self._t)
            return other
        if not isinstance(other, Context):
            raise MXNetError(f"copyto: expected an NDArray or a Context, "
                             f"got {type(other).__name__}")
        return NDArray(self._t.detach().to(other.device, copy=True),
                       ctx=other)

    def as_in_context(self, context: Context) -> "NDArray":
        if context == self._ctx:
            return self
        return self.copyto(context)

    as_in_ctx = as_in_context

    def detach(self) -> "NDArray":
        """The same storage, cut from the autograd graph."""
        return NDArray(self._t.detach(), ctx=self._ctx)

    # -- shape sugar ------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """A view with the new shape (MXNet's magic codes allowed)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return invoke(get_op("reshape"), [self], keep_view=True,
                      shape=tuple(shape), **kwargs)

    def flatten(self):
        return invoke(get_op("flatten"), [self])

    def expand_dims(self, axis):
        return invoke(get_op("expand_dims"), [self], axis=axis)

    def squeeze(self, axis=None):
        return invoke(get_op("squeeze"), [self], axis=axis)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke(get_op("transpose"), [self], axes=axes)

    def swapaxes(self, dim1, dim2):
        return invoke(get_op("swapaxes"), [self], dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke(get_op("split"), [self], num_outputs=num_outputs,
                      axis=axis, squeeze_axis=squeeze_axis)

    def slice_axis(self, axis, begin, end):
        return invoke(get_op("slice_axis"), [self], axis=axis, begin=begin,
                      end=end)

    def take(self, indices, axis=0, mode="clip"):
        return invoke(get_op("take"), [self, _coerce(indices, self)],
                      axis=axis, mode=mode)

    def tile(self, reps):
        return invoke(get_op("tile"), [self], reps=tuple(reps))

    def broadcast_to(self, shape):
        return invoke(get_op("broadcast_to"), [self], shape=tuple(shape))

    def broadcast_like(self, other):
        return invoke(get_op("broadcast_like"), [self, other])

    # -- reductions and math sugar -----------------------------------------
    def sum(self, axis=None, keepdims=False):
        return invoke(get_op("sum"), [self], axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return invoke(get_op("mean"), [self], axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return invoke(get_op("max"), [self], axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return invoke(get_op("min"), [self], axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return invoke(get_op("prod"), [self], axis=axis, keepdims=keepdims)

    def argmax(self, axis=None):
        return invoke(get_op("argmax"), [self], axis=axis)

    def argmin(self, axis=None):
        return invoke(get_op("argmin"), [self], axis=axis)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke(get_op("norm"), [self], ord=ord, axis=axis,
                      keepdims=keepdims)

    def abs(self):
        return invoke(get_op("abs"), [self])

    def sqrt(self):
        return invoke(get_op("sqrt"), [self])

    def square(self):
        return invoke(get_op("square"), [self])

    def exp(self):
        return invoke(get_op("exp"), [self])

    def log(self):
        return invoke(get_op("log"), [self])

    def clip(self, a_min, a_max):
        return invoke(get_op("clip"), [self], a_min=a_min, a_max=a_max)

    def sigmoid(self):
        return invoke(get_op("sigmoid"), [self])

    def tanh(self):
        return invoke(get_op("tanh"), [self])

    def relu(self):
        return invoke(get_op("relu"), [self])

    def softmax(self, axis=-1):
        return invoke(get_op("softmax"), [self], axis=axis)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke(get_op("dot"), [self, other], transpose_a=transpose_a,
                      transpose_b=transpose_b)

    def zeros_like(self):
        return invoke(get_op("zeros_like"), [self])

    def ones_like(self):
        return invoke(get_op("ones_like"), [self])

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return invoke(get_op("one_hot"), [self], depth=depth,
                      on_value=on_value, off_value=off_value, dtype=dtype)

    # -- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a zero gradient buffer and make this array a leaf of
        the autograd graph: ``backward`` writes (``"write"``), adds
        (``"add"``) or skips (``"null"``) its gradient."""
        from ..autograd import _make_leaf
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null, got "
                             f"{grad_req!r}")
        if stype not in (None, "default"):
            raise MXNetError(f"gradient storage {stype!r} is not ported")
        self.grad_req = grad_req
        self._grad = NDArray(torch.zeros_like(self._t.detach()),
                             ctx=self._ctx)
        _make_leaf(self)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- indexing ---------------------------------------------------------
    @staticmethod
    def _is_basic(key):
        ks = key if isinstance(key, tuple) else (key,)
        return all(isinstance(k, (int, np.integer, builtins.slice))
                   or k is Ellipsis or k is None for k in ks)

    def _advanced_key(self, key):
        def conv(k):
            if isinstance(k, NDArray):
                return k._t.long()
            if isinstance(k, (list, np.ndarray)):
                return torch.as_tensor(np.asarray(k), device=self._t.device)
            return k
        return tuple(conv(k) for k in key) if isinstance(key, tuple) \
            else conv(key)

    def __getitem__(self, key):
        from .. import autograd
        if self._is_basic(key):
            enc = []
            for k in (key if isinstance(key, tuple) else (key,)):
                if isinstance(k, builtins.slice):
                    enc.append(("s", k.start, k.stop, k.step))
                elif k is Ellipsis:
                    enc.append(("e",))
                elif k is None:
                    enc.append(("n",))
                else:
                    enc.append(("i", int(k)))
            return invoke(get_op("_slice_basic"), [self], keep_view=True,
                          key=tuple(enc))
        if autograd.is_recording():
            raise MXNetError(
                "advanced indexing is not differentiable on the tape; "
                "use take/pick inside autograd.record()")
        with torch.no_grad():
            return NDArray(self._t[self._advanced_key(key)], ctx=self._ctx)

    def __setitem__(self, key, value):
        from .. import autograd
        if autograd.is_recording():
            raise MXNetError(
                "In-place assignment is not supported inside "
                "autograd.record() — parity with reference semantics.")
        if isinstance(value, NDArray):
            value = value._t
        elif not isinstance(value, numeric_types):
            value = torch.as_tensor(np.asarray(value), dtype=self._t.dtype,
                                    device=self._t.device)
        key = key if self._is_basic(key) else self._advanced_key(key)
        with torch.no_grad():
            self._t[key] = value

    # -- arithmetic operators --------------------------------------------
    def _binary(self, other, opname, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(get_op(opname), [a, b])
        if isinstance(other, numeric_types):
            return invoke(get_op(scalar_op), [self], scalar=other)
        if isinstance(other, np.ndarray):
            o = array(other, ctx=self._ctx, dtype=other.dtype)
            a, b = (o, self) if reverse else (self, o)
            return invoke(get_op(opname), [a, b])
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        if isinstance(o, numeric_types):
            return invoke(get_op("_rminus_scalar"), [self], scalar=o)
        return self._binary(o, "broadcast_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        if isinstance(o, numeric_types):
            return invoke(get_op("_rdiv_scalar"), [self], scalar=o)
        return self._binary(o, "broadcast_div", "_div_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        if isinstance(o, numeric_types):
            return invoke(get_op("_rmod_scalar"), [self], scalar=o)
        return self._binary(o, "broadcast_mod", "_mod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        if isinstance(o, numeric_types):
            return invoke(get_op("_rpower_scalar"), [self], scalar=o)
        return NotImplemented

    def __neg__(self):
        return invoke(get_op("negative"), [self])

    def __abs__(self):
        return invoke(get_op("abs"), [self])

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, other, opname, scalar_op):
        from .. import autograd
        if autograd.is_recording():
            raise MXNetError("In-place operations are not supported when "
                             "recording with autograd.")
        res = self._binary(other, opname, scalar_op)
        if res is NotImplemented:
            return NotImplemented
        with torch.no_grad():
            self._t.copy_(res._t)
        return self

    def __iadd__(self, o):
        return self._inplace(o, "broadcast_add", "_plus_scalar")

    def __isub__(self, o):
        return self._inplace(o, "broadcast_sub", "_minus_scalar")

    def __imul__(self, o):
        return self._inplace(o, "broadcast_mul", "_mul_scalar")

    def __itruediv__(self, o):
        return self._inplace(o, "broadcast_div", "_div_scalar")


# ---------------------------------------------------------------------------
# invoke: run one registered op on NDArrays
# ---------------------------------------------------------------------------


def _coerce(x, like: NDArray) -> NDArray:
    if isinstance(x, NDArray):
        return x
    return array(np.asarray(x), ctx=like._ctx)


def _shares_storage(t: torch.Tensor, inputs) -> bool:
    ptr = t.untyped_storage().data_ptr()
    return any(ptr == i.untyped_storage().data_ptr() for i in inputs)


# resolved once (a per-call import costs microseconds on the dispatch
# path); deferred because autograd imports this module
_autograd = None


def invoke(op: OpDef, inputs: Sequence[NDArray], out=None,
           ctx: Optional[Context] = None, keep_view=False, **kwargs):
    """Run ``op`` on ``inputs``; return NDArray(s), or write ``out``.

    The op is queued on the device's current stream and returns at once.
    Outside ``autograd.record()`` it runs under ``torch.no_grad()``;
    inside, PyTorch's autograd records it.  An output that shares storage
    with an input is copied unless ``keep_view`` (basic indexing and
    ``NDArray.reshape``).
    """
    global _autograd
    autograd = _autograd
    if autograd is None:
        from .. import autograd as _ag
        autograd = _autograd = _ag

    tensors = [i._t for i in inputs]
    if inputs:
        ctx = inputs[0]._ctx
    else:
        ctx = ctx or current_context()
    if op.wrap_ctx and "device" in op.attr_names:
        kwargs["device"] = ctx.device

    # scalars bind POSITIONALLY after the tensor inputs, so once any is
    # given every one is materialized (an omitted earlier scalar would
    # shift later values into the wrong parameter)
    scalars = []
    if op.scalar_attrs and any(s in kwargs for s in op.scalar_attrs):
        for sname in op.scalar_attrs:
            if sname in kwargs:
                v = kwargs.pop(sname)
            elif sname in op.scalar_defaults:
                v = op.scalar_defaults[sname]
            else:
                raise MXNetError(
                    f"{op.name}: scalar attr {sname!r} is required "
                    f"when any of {op.scalar_attrs} is given")
            scalars.append(v._t if isinstance(v, NDArray) else v)

    recording = autograd.is_recording()
    if recording and out is not None:
        raise MXNetError("`out` is not supported when recording with "
                         "autograd.")
    try:
        if recording:
            autograd._mark_inputs(tensors)
            with torch.enable_grad():
                res = op.fcompute(*tensors, *scalars, **kwargs)
        else:
            with torch.no_grad():
                res = op.fcompute(*tensors, *scalars, **kwargs)
    except MXNetError:
        raise
    except RuntimeError as e:
        raise MXNetError(f"{op.name}: {e}") from e

    multi = isinstance(res, (tuple, list))
    outs = list(res) if multi else [res]
    if not keep_view and tensors:
        outs = [o.clone() if _shares_storage(o, tensors) else o
                for o in outs]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        with torch.no_grad():
            for o, d in zip(targets, outs):
                o._t.copy_(d)
        return out
    wrapped = [NDArray(o, ctx=ctx) for o in outs]
    if multi and op.num_outputs != 1:
        return wrapped
    return wrapped[0]


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray from array-like ``source`` (parity: ``mx.nd.array``).
    Python lists and scalars become float32, and so do float64 arrays,
    unless ``dtype`` says otherwise."""
    ctx = ctx or current_context()
    dev = ctx.device
    if isinstance(source, NDArray):
        t = source._t.detach()
        if dtype is None and t.dtype == torch.float64:
            dtype = "float32"
        dt = torch_dtype(dtype) if dtype is not None else t.dtype
        return NDArray(t.to(device=dev, dtype=dt, copy=True), ctx=ctx)
    was_array = isinstance(source, np.ndarray)
    src = np.asarray(source)
    if dtype is None:
        dtype = src.dtype if was_array and src.dtype != np.float64 \
            else np.dtype("float32")
    dt = torch_dtype(dtype)
    if dt == torch.bfloat16:
        t = torch.from_numpy(np.array(src, dtype="float32")).to(dt)
    else:
        t = torch.from_numpy(np.array(src, dtype=dtype_name(dt)))
    return NDArray(t.to(dev), ctx=ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return invoke(get_op("_zeros"), [], ctx=ctx, shape=_shape(shape),
                  dtype=dtype_name(torch_dtype(dtype)))


def ones(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return invoke(get_op("_ones"), [], ctx=ctx, shape=_shape(shape),
                  dtype=dtype_name(torch_dtype(dtype)))


def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return invoke(get_op("_full"), [], ctx=ctx, shape=_shape(shape),
                  value=float(val), dtype=dtype_name(torch_dtype(dtype)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    return invoke(get_op("_arange"), [], ctx=ctx, start=start, stop=stop,
                  step=step, repeat=repeat,
                  dtype=dtype_name(torch_dtype(dtype)))


def eye(N, M=0, k=0, ctx=None, dtype="float32") -> NDArray:
    return invoke(get_op("_eye"), [], ctx=ctx, N=N, M=M, k=k,
                  dtype=dtype_name(torch_dtype(dtype)))


def moveaxis(data, source, destination):
    axes = list(range(data.ndim))
    axes.remove(source % data.ndim)
    axes.insert(destination % data.ndim, source % data.ndim)
    return data.transpose(tuple(axes))


def concatenate(arrays, axis=0):
    return invoke(get_op("concat"), list(arrays), dim=axis)


def waitall():
    """Wait for all queued work on every card; an error of an earlier
    asynchronous launch surfaces here as ``MXNetError``."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    try:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    except RuntimeError as e:
        raise _sync_error("waitall", e) from e
