"""Sequential containers and Dense, Embedding, LayerNorm, InstanceNorm,
GroupNorm, Dropout, BatchNorm, Flatten, Identity, Lambda, HybridLambda,
Concatenate and HybridConcatenate, as the JAX package's
``gluon/nn/basic_layers.py``.

Parameters keep the reference's names and layouts (Dense weight
(units, in_units), Embedding weight (input_dim, output_dim), LayerNorm
and InstanceNorm gamma/beta, GroupNorm gamma/beta one a group,
BatchNorm gamma/beta/running_mean/running_var) so a by-name copy moves
values over unchanged.  ``in_units=0`` (Dense) and ``in_channels=0``
(BatchNorm, InstanceNorm) defer the size to the first call.
"""
from __future__ import annotations

import math

import torch

from ...base import torch_dtype
from ...ndarray.ndarray import _ctx_of
from ...initializer import param
from ...ops import nn as ops
from ..block import Block, HybridBlock, _unwrap, _wrap

__all__ = ["Sequential", "HybridSequential", "Dense", "Embedding",
           "LayerNorm", "InstanceNorm", "GroupNorm", "Dropout", "BatchNorm",
           "Flatten", "Identity", "Lambda", "HybridLambda", "Concatenate",
           "HybridConcatenate"]


class Sequential(Block):
    """Stack of Blocks run one after the other."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)
        return self

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            return net.add(*layers[key])
        return layers[key]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks run one after the other."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    add = Sequential.add
    forward = Sequential.forward
    __len__ = Sequential.__len__
    __getitem__ = Sequential.__getitem__
    __iter__ = Sequential.__iter__


class Dense(HybridBlock):
    """``act(x @ weight.T + bias)``; ``flatten`` folds every axis after
    the first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._flatten = flatten
        self._act = activation
        self.weight = param(units, in_units, init=weight_initializer,
                            dtype=torch_dtype(dtype))
        self.bias = param(units, init=bias_initializer,
                          dtype=torch_dtype(dtype)) if use_bias else None

    def infer_shape(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self.weight.shape[0], in_units)

    def forward(self, x):
        out = ops.fully_connected(x, self._tensor("weight"),
                                  self._tensor("bias"), flatten=self._flatten)
        if self._act is not None:
            out = ops.activation(out, self._act)
        return out


class Embedding(HybridBlock):
    """Index -> row lookup; ids may be float32, as in the reference.
    ``sparse_grad=True`` types the weight's gradient ``row_sparse``, so
    the optimizers update only the rows a batch touched (the lazy
    update); the gradient itself is the dense buffer."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.weight = param(input_dim, output_dim, init=weight_initializer,
                            dtype=torch_dtype(dtype))
        if sparse_grad:
            self._gluon_param("weight").grad_stype = "row_sparse"

    def forward(self, x):
        return ops.embedding(x, self._tensor("weight"))


class LayerNorm(HybridBlock):
    """Layer normalisation over ``axis`` (the last by default), then
    ``* gamma + beta``; ``scale=False`` and ``center=False`` keep gamma
    and beta at their initial values with ``grad_req="null"``, and
    ``in_channels=0`` (the default) defers the size to the first call,
    as in the reference."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = epsilon
        self.gamma = param(in_channels, init=gamma_initializer,
                           requires_grad=scale)
        self.beta = param(in_channels, init=beta_initializer,
                          requires_grad=center)

    def infer_shape(self, x):
        for attr in ("gamma", "beta"):
            self._gluon_param(attr).shape = (x.shape[self._axis],)

    def forward(self, x):
        gamma, beta = self._tensor("gamma"), self._tensor("beta")
        ax = self._axis % x.dim()
        if ax == x.dim() - 1:
            return ops.layer_norm(x, gamma, beta, eps=self._eps)
        return ops.layer_norm(x.movedim(ax, -1), gamma, beta,
                              eps=self._eps).movedim(-1, ax)


class Dropout(HybridBlock):
    """Dropout at ``rate``, active only in training mode (with NDArrays,
    ``autograd.is_training()``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        return ops.dropout(x, p=self._rate, training=self._training_mode(),
                           axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalisation over axis ``axis`` with the reference's moving
    statistics: in training mode the batch's mean and biased variance
    normalise, and ``running = momentum * running + (1 - momentum) *
    batch`` after (in place, outside the tape); in predict mode, or with
    ``use_global_stats``, the running statistics normalise.
    ``scale=False`` fixes gamma at 1 and ``center=False`` beta at 0 (no
    gradient for either).  The running statistics stay float32, with
    ``grad_req="null"``.  ``in_channels=0`` defers the size.  Inside a
    dp>1 ``DataParallelTrainer`` step the statistics are the global
    batch's (``parallel.mesh.sync_batch_stats``), as the JAX package's
    one program over the mesh computes them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._kwargs = {"eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats, "axis": axis}
        self.gamma = param(in_channels, init=gamma_initializer,
                           requires_grad=scale)
        self.beta = param(in_channels, init=beta_initializer,
                          requires_grad=center)
        self.running_mean = param(in_channels, init=running_mean_initializer,
                                  requires_grad=False)
        self.running_var = param(in_channels,
                                 init=running_variance_initializer,
                                 requires_grad=False)

    def infer_shape(self, x):
        for attr in ("gamma", "beta", "running_mean", "running_var"):
            self._gluon_param(attr).shape = (x.shape[self._axis],)

    def cast(self, dtype):
        """float16 and bfloat16 leave BatchNorm in float32, its
        statistics among them (the reference's ``BatchNorm.cast``)."""
        if str(dtype).replace("torch.", "") in ("float16", "bfloat16"):
            dtype = "float32"
        super().cast(dtype)

    #: reduce the statistics over the process group whenever it has
    #: more than one rank (``gluon.contrib.nn.SyncBatchNorm``); a plain
    #: BatchNorm does so inside a dp>1 trainer's step only
    _sync = False

    def forward(self, x):
        from ...parallel.mesh import batch_stats_group
        training = self._training_mode() and \
            not self._kwargs["use_global_stats"]
        out, mean, var = ops.batch_norm(
            x, self._tensor("gamma"), self._tensor("beta"),
            self._tensor("running_mean"), self._tensor("running_var"),
            training=training, group=batch_stats_group(self._sync)
            if training else None, **self._kwargs)
        if training:
            ops.update_moving_stats(self._tensor("running_mean"),
                                    self._tensor("running_var"),
                                    mean, var, self._kwargs["momentum"])
        return out


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class InstanceNorm(HybridBlock):
    """Instance normalisation: each sample's channels normalised over
    their spatial axes, then ``* gamma + beta`` a channel.  ``scale=False``
    (the default) keeps gamma at its initial 1 with ``grad_req="null"``;
    ``in_channels=0`` defers the size."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = epsilon
        self.gamma = param(in_channels, init=gamma_initializer,
                           requires_grad=scale)
        self.beta = param(in_channels, init=beta_initializer,
                          requires_grad=center)

    def infer_shape(self, x):
        for attr in ("gamma", "beta"):
            self._gluon_param(attr).shape = (x.shape[self._axis],)

    def forward(self, x):
        return ops.instance_norm(x, self._tensor("gamma"),
                                 self._tensor("beta"), eps=self._eps)


class GroupNorm(HybridBlock):
    """Group normalisation over ``num_groups`` groups of channels; gamma
    and beta are one a group, (num_groups,), the reference's layout."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_groups = num_groups
        self._eps = epsilon
        self.gamma = param(num_groups, init=gamma_initializer,
                           requires_grad=scale)
        self.beta = param(num_groups, init=beta_initializer,
                          requires_grad=center)

    def forward(self, x):
        return ops.group_norm(x, self._tensor("gamma"), self._tensor("beta"),
                              num_groups=self._num_groups, eps=self._eps)


class Identity(HybridBlock):
    def forward(self, x):
        return x


def _nd_function(function):
    """``function``, or the ``mx.nd`` function of that name."""
    if not isinstance(function, str):
        return function
    from ... import ndarray as nd
    assert hasattr(nd, function), \
        f"Function name {function!r} is not found in ndarray."
    return getattr(nd, function)


class Lambda(Block):
    """A function of NDArrays as a Block: ``function``, or the name of an
    ``mx.nd`` function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = _nd_function(function)

    def forward(self, *args):
        t = next(a for a in args if torch.is_tensor(a))
        return _unwrap(self._func(*_wrap(args, _ctx_of(t.device))))


class HybridLambda(HybridBlock):
    """A function ``(F, *inputs)`` (``F`` is ``mx.nd``), or the name of
    an ``mx.nd`` function, as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            fn = _nd_function(function)
            self._func = lambda F, *args: fn(*args)
        else:
            self._func = function

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)


class HybridConcatenate(HybridBlock):
    """Runs every child on the same input and concatenates their outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    add = Sequential.add

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self.axis)


class Concatenate(Block):
    """Runs every child on the same input and concatenates their outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    add = Sequential.add
    forward = HybridConcatenate.forward
