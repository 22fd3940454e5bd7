"""Gluon ``Trainer``: applies an optimizer over a set of Parameters, as
the JAX package's ``gluon/trainer.py``.

The optimizer is a name or an ``mx.optimizer.Optimizer``.
``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``1 / batch_size`` (times the optimizer's own), reduces the gradients
over the kvstore (``allreduce_grads``) and updates every parameter whose
``grad_req`` is not ``"null"`` (``update``).  Pass the global batch:
gradients are summed over contexts and ranks.

* **One context, a local kvstore** (the default ``"device"``, or None):
  there is nothing to reduce, and the update is one multi-tensor pass
  (``Updater.call_fused``, the reference's ``_fused_update_all``).
* **Several contexts** (``initialize(ctx=[...])``, ``split_and_load``):
  each parameter's per-context gradients are pushed to the kvstore and
  their sum pulled back into every context's gradient, then every
  context's copy takes the same update with its own states (one updater
  a context; the update counts advance once a step, as the reference's
  ``_set_current_context``).
* **A ``dist_*`` kvstore** (one process a card under
  ``python -m mxnet_tpu_torch.launch``): the push sums over the ranks
  too; rank 0's weights are broadcast at the first step, and by default
  (``update_on_kvstore``) the store runs the optimizer and every rank
  pulls the new weights.
* ``compression_params`` (``{"type": "2bit", "threshold": t}`` or
  ``{"type": "int8"}``) compresses each push with error feedback
  (``kvstore/compression.py``).

``compile_step(net, loss_fn)`` makes the whole training step one
captured graph (``gluon/compiled_step.py``) on one context with a local
kvstore.  A parameter with a row-sparse gradient
(``Embedding(sparse_grad=True)``) takes the optimizer's lazy update on
its own.  ``save_states``/``load_states`` pickle the optimizer's states
and the optimizer, update counts included.  ``clip_global_norm`` scales
the gradients before each update, eager or compiled, so that the global
2-norm of the rescaled gradients is at most that value
(``Optimizer.clip_global_grads``); it cannot combine with updates on the
kvstore, which see one gradient at a time.
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
                 update_on_kvstore=None, clip_global_norm=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)) or not all(
                isinstance(p, Parameter) for p in params):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters")
        self._params: List[Parameter] = list(params)
        self._contexts = self._check_contexts()
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
        if clip_global_norm is not None:
            if not float(clip_global_norm) > 0:
                raise ValueError(f"clip_global_norm must be positive, got "
                                 f"{clip_global_norm}")
            self._optimizer.clip_global_norm = float(clip_global_norm)
        self._scale = self._optimizer.rescale_grad
        # one updater a context: each copy applies the same reduced
        # gradient with its own states
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]
        self._compression_params = compression_params
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = False

    @property
    def _updater(self):
        return self._updaters[0]

    def _check_contexts(self):
        """The contexts every parameter lives on (the same list for all,
        as the reference requires)."""
        contexts = None
        for p in self._params:
            ctx = p.list_ctx()
            if contexts is not None and contexts != ctx:
                raise ValueError(
                    "All Parameters must be initialized on the same set of "
                    f"contexts, but Parameter {p.name!r} is initialized on "
                    f"{ctx} while previous Parameters are initialized on "
                    f"{contexts}.")
            contexts = ctx
        return contexts or [None]

    def _init_kvstore(self):
        """Make the kvstore (a name or a KVStore), give it the
        compression and, with ``update_on_kvstore``, the optimizer, and
        store every trainable parameter (a distributed store broadcasts
        rank 0's, which every context then pulls)."""
        from .. import kvstore as kvs
        kv = self._kvstore_params["kvstore"]
        if isinstance(kv, str):
            kv = kvs.create(kv)
        elif kv is not None and not isinstance(kv, kvs.KVStore):
            raise MXNetError(f"kvstore must be None, a name or a KVStore, "
                             f"got {type(kv).__name__}")
        self._kvstore = kv
        self._kv_initialized = True
        if kv is None:
            if self._compression_params:
                raise MXNetError("gradient compression needs a kvstore")
            return
        uok = self._kvstore_params["update_on_kvstore"]
        self._update_on_kvstore = bool(uok) if uok is not None \
            else kv.is_distributed
        if self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        if self._update_on_kvstore:
            if self._optimizer.clip_global_norm is not None:
                raise ValueError(
                    "clip_global_norm requires update_on_kvstore=False: "
                    "updates on the kvstore see one gradient at a time and "
                    "cannot compute a global norm.")
            kv.set_optimizer(self._optimizer)
        if self._allreduce_is_identity():
            return            # nothing will be pushed: no copies stored
        for i, p in enumerate(self._params):
            if p.grad_req != "null":
                kv.init(str(i), p.data(self._contexts[0]))
                if kv.is_distributed:
                    kv.pull(str(i), out=p.list_data())

    def _allreduce_is_identity(self):
        """One context, a local store, no compression, no update on the
        store: pushing and pulling would copy each gradient back to
        itself."""
        kv = self._kvstore
        return kv is None or (not kv.is_distributed
                              and not self._update_on_kvstore
                              and not self._compression_params
                              and len(self._contexts) == 1)

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
        see ``gluon/compiled_step.py``).  One context and a local
        kvstore only."""
        from .compiled_step import CompiledStep
        kv = self._kvstore_params["kvstore"]
        if len(self._contexts) > 1 or self._compression_params or (
                kv is not None and getattr(kv, "is_distributed",
                                           str(kv).startswith("dist"))):
            raise MXNetError(
                "compile_step runs on one context with a local kvstore; "
                "several contexts, a distributed kvstore or compression "
                "take the eager step (or parallel.DataParallelTrainer)")
        return CompiledStep(net, loss_fn, self)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients over the kvstore, then update with them
        scaled by ``1 / batch_size`` (the global batch)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._allreduce_is_identity():
            self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum every parameter's gradients over its contexts (and the
        ranks), into each context's gradient (without
        ``update_on_kvstore``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() when parameters are "
                             "updated on the kvstore is not supported: "
                             "use step(), or update_on_kvstore=False")
        if not self._allreduce_is_identity():
            self._allreduce_grads()

    def _allreduce_grads(self):
        for i, p in enumerate(self._params):
            if p.grad_req != "null":
                self._kvstore.push(str(i), p.list_grad(), priority=-i)
                if not self._update_on_kvstore:
                    self._kvstore.pull(str(i), p.list_grad(), priority=-i,
                                       ignore_sparse=False)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone, with gradients scaled by ``1 /
        batch_size`` (after ``allreduce_grads``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() when parameters are updated on the "
                             "kvstore is not supported: use step()")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        indices = [i for i, p in enumerate(self._params)
                   if p.grad_req != "null"]
        if self._update_on_kvstore:
            for i in indices:
                self._kvstore.pull(str(i), self._params[i].list_data(),
                                   priority=-i)
            return
        for dev_id, (ctx, upd) in enumerate(zip(self._contexts,
                                                self._updaters)):
            # each context's copy counts its own updates, so Adam's t
            # advances once a step
            self._optimizer._set_current_context(dev_id)
            upd.call_fused(indices,
                           [self._params[i].grad(ctx) for i in indices],
                           [self._params[i].data(ctx) for i in indices])
        self._optimizer._set_current_context(0)

    def save_states(self, fname):
        """The optimizer's states (the first context's, or the kvstore's
        with ``update_on_kvstore``) and the optimizer, to ``fname``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Take ``save_states``' file: the states go on the parameters'
        context, and the loaded optimizer (its counts, its learning rate
        or scheduler) takes this trainer's parameters."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            states = f.read()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
            self._optimizer.param_dict = dict(enumerate(self._params))
            return
        for ctx, upd in zip(self._contexts, self._updaters):
            upd.set_states(states, lambda i, c=ctx: c if c is not None
                           else self._params[i].list_ctx()[0])
        old, self._optimizer = self._optimizer, self._updater.optimizer
        for upd in self._updaters:
            upd.optimizer = self._optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        if type(self._optimizer) is type(old):
            # a captured step reads the old optimizer's scalar tensors
            self._optimizer._scalars = old._scalars
