"""Gluon ``Trainer``: applies an optimizer over a set of Parameters, as
the JAX package's ``gluon/trainer.py`` on one context.

The optimizer is ``"sgd"``, ``"adam"`` or an ``mx.optimizer.Optimizer``.
``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``1 / batch_size`` (times the optimizer's own) and updates every
parameter whose ``grad_req`` is not ``"null"`` from its gradient buffer,
in place, all of them in one multi-tensor update
(``Updater.call_fused``, the reference's ``_fused_update_all``).  With
one context there is nothing to reduce, so ``kvstore`` may be None,
``"device"`` or ``"local"``; several contexts and a real kvstore are not
ported (ROADMAP queue 1 item 8).  ``compile_step(net,
loss_fn)`` makes the whole training step one captured graph
(``gluon/compiled_step.py``).
"""
from __future__ import annotations

from typing import List

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies ``optimizer`` over ``params`` each ``step()``."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)) or not all(
                isinstance(p, Parameter) for p in params):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters")
        if kvstore not in (None, "device", "local") or compression_params \
                or update_on_kvstore:
            raise MXNetError("a kvstore, gradient compression and updates "
                             "on the kvstore are not ported: Trainer runs "
                             "on one context (kvstore=None)")
        self._params: List[Parameter] = list(params)
        contexts = {p.list_ctx()[0] for p in self._params}
        if len(contexts) > 1:
            raise MXNetError(f"the parameters live on {sorted(map(str, contexts))}: "
                             "Trainer takes one context")
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def compile_step(self, net, loss_fn):
        """A :class:`~.compiled_step.CompiledStep`: ``loss_fn(net(*data),
        label)``, its backward and this trainer's update as one captured
        graph a step on the card (escape hatch ``MXTPU_COMPILED_STEP=0``;
        see ``gluon/compiled_step.py``)."""
        from .compiled_step import CompiledStep
        return CompiledStep(net, loss_fn, self)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update, with gradients scaled by ``1 / batch_size``."""
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one context."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        indices = [i for i, p in enumerate(self._params)
                   if p.grad_req != "null"]
        self._updater.call_fused(indices,
                                 [self._params[i].grad() for i in indices],
                                 [self._params[i].data() for i in indices])
