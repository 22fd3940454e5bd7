"""Estimator event handlers, a copy of the JAX package's
``gluon/contrib/estimator/event_handler.py``.

A handler subscribes to the fit loop's events by mixing in any of the
six marker bases; the Estimator calls every subscribed hook in handler
order.  The built-ins: stopping on an epoch or batch quota, metric
bookkeeping, validation, logging, checkpointing and early stopping.
"""
from __future__ import annotations

import logging
import os
import time

__all__ = [
    "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
    "BatchEnd", "StoppingHandler", "MetricHandler",
    "ValidationHandler", "LoggingHandler", "CheckpointHandler",
    "EarlyStoppingHandler",
]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after ``max_epoch`` epochs or ``max_batch`` total batches
    (whichever comes first), like the reference's quota handler."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Resets training metrics at epoch start and feeds them each
    batch (reference behavior: metrics passed to Estimator update
    automatically)."""

    def __init__(self, metrics):
        self.metrics = metrics

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        from ....metric import Loss as _LossMetric
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for m in self.metrics:
            if isinstance(m, _LossMetric) and loss is not None:
                m.update(0, loss)
            elif pred is not None and label is not None:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Runs ``eval_fn`` every ``epoch_period`` epochs (or
    ``batch_period`` batches) and stores results on the estimator."""

    def __init__(self, val_data, eval_fn, epoch_period=1,
                 batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                     BatchEnd):
    """Per-epoch (and optionally per-N-batch) metric logging with
    throughput, like the reference's LoggingHandler + Speedometer."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        secs = time.time() - self.train_start
        self.logger.info("Training finished in %.1fs (%d epochs)",
                         secs, self.current_epoch)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0
        self.processed_samples = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        batch = kwargs.get("batch")
        if batch is not None:
            try:
                self.processed_samples += batch[0].shape[0]
            except Exception:
                pass
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            msgs = [f"{n}={v:.4f}" if isinstance(v, float)
                    else f"{n}={v}"
                    for n, v in (m.get() for m in self.metrics)]
            self.logger.info("[epoch %d batch %d] %s",
                             self.current_epoch, self.batch_index,
                             " ".join(msgs))

    def epoch_end(self, estimator, *args, **kwargs):
        secs = time.time() - self.epoch_start
        sps = self.processed_samples / secs if secs > 0 else 0.0
        msgs = [f"{n}={v:.4f}" if isinstance(v, float) else f"{n}={v}"
                for n, v in (m.get() for m in self.metrics)]
        self.logger.info("[epoch %d] time %.1fs %.0f samples/s %s",
                         self.current_epoch, secs, sps, " ".join(msgs))
        self.current_epoch += 1


class CheckpointHandler(TrainBegin, EpochEnd):
    """Saves ``{prefix}-epochN.params`` each epoch; with
    ``monitor``+``save_best`` also keeps ``{prefix}-best.params``
    (reference CheckpointHandler contract)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", save_best=False, epoch_period=1):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.mode = mode
        self.current_epoch = 0
        self.best = float("inf") if mode == "min" else -float("inf")

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        self.current_epoch = 0
        # a second fit() is a fresh run: a stale best from the previous
        # run must not suppress this run's best checkpoint
        self.best = float("inf") if self.mode == "min" \
            else -float("inf")

    def _improved(self, value):
        return value < self.best if self.mode == "min" \
            else value > self.best

    def epoch_end(self, estimator, *args, **kwargs):
        if self.current_epoch % self.epoch_period == 0:
            path = os.path.join(
                self.model_dir,
                f"{self.model_prefix}-epoch{self.current_epoch}"
                ".params")
            estimator.net.save_parameters(path)
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            if isinstance(value, (int, float)) and \
                    self._improved(value):
                self.best = value
                estimator.net.save_parameters(os.path.join(
                    self.model_dir,
                    f"{self.model_prefix}-best.params"))
        self.current_epoch += 1


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stops training when ``monitor`` hasn't improved by
    ``min_delta`` for ``patience`` epochs (reference contract)."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0,
                 baseline=None):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.baseline = baseline
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stop_training = False
        if self.baseline is not None:
            self.best = self.baseline
        else:
            self.best = float("inf") if self.mode == "min" \
                else -float("inf")

    def _improved(self, value):
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def epoch_end(self, estimator, *args, **kwargs):
        _, value = self.monitor.get()
        if not isinstance(value, (int, float)):
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
