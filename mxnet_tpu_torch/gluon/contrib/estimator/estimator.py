"""``gluon.contrib.estimator.Estimator``, as the JAX package's
``gluon/contrib/estimator/estimator.py``: one object owns the net, the
loss, the metrics and the trainer and runs the epochs and batches,
calling the event handlers.  ``fit`` makes the default handlers when
none is passed (validation first, so a handler reading a validation
metric sees this epoch's value); training metrics are named
``training <name>``, validation ones ``validation <name>``.  The step is
the gluon loop: ``record`` -> net -> loss -> ``backward`` ->
``trainer.step``, which a hybridized net runs as CachedOp replays.
"""
from __future__ import annotations

import copy
import logging

from .... import autograd
from ....context import Context, current_context
from ....metric import Accuracy, EvalMetric, Loss
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler,
                            StoppingHandler, TrainBegin, TrainEnd,
                            ValidationHandler)

__all__ = ["Estimator"]


def _placed(param):
    """Whether ``initialize`` has placed ``param`` (a deferred one waits
    for its first call, placed all the same)."""
    t = param._tensor
    if param._deferred:
        return getattr(t, "mx_deferred", None) is not None
    return not t.is_meta


class Estimator:
    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = self._check_metrics(metrics)
        self.context = self._check_context(context)
        self._initialize(initializer)
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})
        if not self.train_metrics:
            self.train_metrics = [Accuracy()]
        self.train_loss_metric = Loss(
            f"training {getattr(loss, 'name', 'loss')}")
        # clone by deepcopy so constructor config (top_k, axis, ...)
        # survives — reconstructing via __class__() dropped it
        self.val_metrics = []
        for m in self.train_metrics:
            vm = copy.deepcopy(m)
            vm.name = f"validation {m.name}"
            vm.reset()
            self.val_metrics.append(vm)
        self.val_loss_metric = Loss(
            f"validation {getattr(loss, 'name', 'loss')}")
        for m in self.train_metrics:
            if not m.name.startswith("training"):
                m.name = f"training {m.name}"
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        self.stop_training = False

    @staticmethod
    def _check_metrics(metrics):
        if metrics is None:
            return []
        metrics = metrics if isinstance(metrics, (list, tuple)) \
            else [metrics]
        for m in metrics:
            if not isinstance(m, EvalMetric):
                raise ValueError(
                    "metrics must be EvalMetric instances, got "
                    f"{type(m)}")
        return list(metrics)

    @staticmethod
    def _check_context(context):
        if context is None:
            return [current_context()]
        if isinstance(context, Context):
            return [context]
        return list(context)

    def _initialize(self, initializer):
        params = self.net.collect_params()
        uninit = [p for p in params.values() if not _placed(p)]
        if uninit:
            from .... import init as _init
            self.net.initialize(initializer or _init.Xavier(),
                                ctx=self.context[0])
        elif initializer is not None:
            # reference contract: an explicit initializer on an
            # already-initialized net is NOT applied — warn, don't
            # silently drop the request
            logging.getLogger("mxnet_tpu_torch.estimator").warning(
                "Estimator: network already initialized; the passed "
                "initializer is ignored (call net.initialize("
                "force_reinit=True) first to re-initialize)")

    # -- evaluation --------------------------------------------------

    def evaluate(self, val_data, batch_axis=0):
        for m in [*self.val_metrics, self.val_loss_metric]:
            m.reset()
        for batch in val_data:
            data, label = self._unpack(batch)
            pred = self.net(data)
            loss = self.loss(pred, label)
            self.val_loss_metric.update(0, loss)
            for m in self.val_metrics:
                m.update(label, pred)
        return [m.get() for m in
                [*self.val_metrics, self.val_loss_metric]]

    def _unpack(self, batch):
        if hasattr(batch, "data"):          # DataBatch
            return batch.data[0], batch.label[0]
        data, label = batch[0], batch[1]
        ctx = self.context[0]
        if hasattr(data, "as_in_context"):
            data = data.as_in_context(ctx)
        if hasattr(label, "as_in_context"):
            label = label.as_in_context(ctx)
        return data, label

    # -- training ----------------------------------------------------

    def fit(self, train_data, val_data=None, epochs=None,
            event_handlers=None, batches=None, batch_axis=0):
        if epochs is None and batches is None:
            epochs = 1
        handlers = self._prepare_handlers(val_data, epochs, batches,
                                          event_handlers)
        categorized = {phase: [h for h in handlers
                               if isinstance(h, base)]
                       for phase, base in (
                           ("train_begin", TrainBegin),
                           ("epoch_begin", EpochBegin),
                           ("batch_begin", BatchBegin),
                           ("batch_end", BatchEnd),
                           ("epoch_end", EpochEnd),
                           ("train_end", TrainEnd))}

        for h in categorized["train_begin"]:
            h.train_begin(self)
        self.stop_training = False
        while not self.stop_training:
            for h in categorized["epoch_begin"]:
                h.epoch_begin(self)
            self.train_loss_metric.reset()
            for batch in train_data:
                for h in categorized["batch_begin"]:
                    h.batch_begin(self, batch=batch)
                data, label = self._unpack(batch)
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                bs = data.shape[batch_axis]
                self.trainer.step(bs)
                self.train_loss_metric.update(0, loss)
                for h in categorized["batch_end"]:
                    h.batch_end(self, batch=batch, pred=pred,
                                label=label, loss=loss)
                if self._should_stop(handlers):
                    break
            for h in categorized["epoch_end"]:
                h.epoch_end(self)
            if self._should_stop(handlers):
                break
        for h in categorized["train_end"]:
            h.train_end(self)

    def _should_stop(self, handlers):
        if any(getattr(h, "stop_training", False) for h in handlers):
            self.stop_training = True
        return self.stop_training

    def _prepare_handlers(self, val_data, epochs, batches,
                          event_handlers):
        handlers = list(event_handlers or [])
        has = lambda cls: any(isinstance(h, cls) for h in handlers)
        if val_data is not None and not has(ValidationHandler):
            # FIRST in the list: epoch_end hooks run in handler order,
            # and checkpoint/early-stop handlers monitoring a
            # validation metric must see THIS epoch's value, not the
            # previous one (the reference gives validation top
            # priority for the same reason)
            handlers.insert(0, ValidationHandler(val_data,
                                                 self.evaluate))
        if not has(StoppingHandler):
            handlers.append(StoppingHandler(max_epoch=epochs,
                                            max_batch=batches))
        if not has(MetricHandler):
            handlers.append(MetricHandler(self.train_metrics))
        if not has(LoggingHandler):
            handlers.append(LoggingHandler(
                metrics=[*self.train_metrics, self.train_loss_metric]))
        return handlers
