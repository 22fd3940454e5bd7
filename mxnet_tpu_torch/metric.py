"""Evaluation metrics (``mx.metric``), a copy of the JAX package's
``metric.py``: the ``EvalMetric`` base (update/get/reset), Accuracy,
TopKAccuracy, F1, MCC, Perplexity, MAE/MSE/RMSE, CrossEntropy,
NegativeLogLikelihood, PearsonCorrelation, Loss, CustomMetric with
``np``, CompositeEvalMetric, and ``create``/``register``.  They compute
on the host in numpy, as in the reference: an update reads its arrays
back from the card (``asnumpy``).
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "CustomMetric", "np", "create", "check_label_shapes"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(name, klass):
    _REGISTRY[name] = klass


def create(metric, *args, **kwargs):
    """Create metric from name / callable / list (parity: metric.create)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, CompositeEvalMetric):
        return metric
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        name = metric.lower()
        if name not in _REGISTRY:
            raise MXNetError(f"Metric {metric!r} is not registered; "
                             f"choices: {sorted(_REGISTRY)}")
        return _REGISTRY[name](*args, **kwargs)
    raise MXNetError(f"cannot create metric from {metric!r}")


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            f"Shape of labels {label_shape} does not match shape of "
            f"predictions {pred_shape}")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


def _np(x):
    from .ndarray.ndarray import NDArray
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


class EvalMetric:
    """Base metric."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names
                     if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0
        self.nonfinite_updates = 0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _inc(self, metric, num):
        # NaN-robustness: one nonfinite batch (a NaN loss from a bad
        # sample, an overflowed fp16 sum) must not permanently corrupt
        # a running metric — sum_metric += nan is forever.  The batch
        # is dropped from the accumulation and COUNTED instead
        # (``nonfinite_updates``), so the health plane / logs can see
        # how many updates were rejected.
        if not (math.isfinite(metric) and math.isfinite(num)):
            self.nonfinite_updates = \
                getattr(self, "nonfinite_updates", 0) + 1
            return
        self.sum_metric += metric
        self.num_inst += num
        self.global_sum_metric += metric
        self.global_num_inst += num


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in metrics] if metrics else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def reset_local(self):
        for metric in getattr(self, "metrics", []):
            metric.reset_local()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name) if not isinstance(name, list) else \
                names.extend(name)
            values.append(value) if not isinstance(value, list) else \
                values.extend(value)
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            if pred.ndim > label.ndim:
                pred = numpy.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").flat
            label = label.astype("int32").flat
            num_correct = int((numpy.asarray(pred) ==
                               numpy.asarray(label)).sum())
            self._inc(num_correct, len(numpy.asarray(label)))


_alias("acc", Accuracy)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more " \
            "than 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            assert pred.ndim == 2, "Predictions should be no more than 2 dims"
            pred = numpy.argsort(pred.astype("float32"), axis=1)
            label = label.astype("int32")
            num_samples = pred.shape[0]
            num_classes = pred.shape[1]
            top_k = min(num_classes, self.top_k)
            correct = 0
            for j in range(top_k):
                correct += int(
                    (pred[:, num_classes - 1 - j].flat ==
                     label.flat).sum())
            self._inc(correct, num_samples)


_alias("top_k_acc", TopKAccuracy)


class _BinaryClassificationMetrics:
    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.true_positives = 0
        self.false_positives = 0
        self.true_negatives = 0
        self.false_negatives = 0

    def update_binary_stats(self, label, pred):
        pred = _np(pred)
        label = _np(label).astype("int32")
        if pred.ndim > 1:
            pred_label = numpy.argmax(pred, axis=1)
        else:
            pred_label = (pred > 0.5).astype("int32")
        check_label_shapes(label.flat, pred_label.flat)
        if len(numpy.unique(label)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % self.__class__.__name__)
        self.true_positives += int(((pred_label.flat == 1) &
                                    (label.flat == 1)).sum())
        self.false_positives += int(((pred_label.flat == 1) &
                                     (label.flat == 0)).sum())
        self.true_negatives += int(((pred_label.flat == 0) &
                                    (label.flat == 0)).sum())
        self.false_negatives += int(((pred_label.flat == 0) &
                                     (label.flat == 1)).sum())

    @property
    def precision(self):
        denom = self.true_positives + self.false_positives
        return self.true_positives / denom if denom > 0 else 0.0

    @property
    def recall(self):
        denom = self.true_positives + self.false_negatives
        return self.true_positives / denom if denom > 0 else 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (self.precision +
                                                       self.recall)
        return 0.0

    @property
    def matthewscc(self):
        terms = [(self.true_positives + self.false_positives),
                 (self.true_positives + self.false_negatives),
                 (self.true_negatives + self.false_positives),
                 (self.true_negatives + self.false_negatives)]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((self.true_positives * self.true_negatives
                 - self.false_positives * self.false_negatives)
                / math.sqrt(denom))

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives +
                self.true_negatives + self.true_positives)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.global_sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.global_num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * \
                self.metrics.total_examples
            self.global_sum_metric = self.sum_metric
            self.num_inst = self.metrics.total_examples
            self.global_num_inst = self.num_inst

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        self.global_sum_metric = 0.0
        self.global_num_inst = 0
        self.nonfinite_updates = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()

    def reset_local(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        if self._average == "macro":
            self.sum_metric += self._metrics.matthewscc
            self.global_sum_metric += self._metrics.matthewscc
            self.num_inst += 1
            self.global_num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = self._metrics.matthewscc * \
                self._metrics.total_examples
            self.global_sum_metric = self.sum_metric
            self.num_inst = self._metrics.total_examples
            self.global_num_inst = self.num_inst

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        self.global_sum_metric = 0.0
        self.global_num_inst = 0
        self.nonfinite_updates = 0
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()

    def reset_local(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            assert label.size == pred.size / pred.shape[-1], \
                f"shape mismatch: {label.shape} vs. {pred.shape}"
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[
                numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= float(numpy.log(numpy.maximum(1e-10, probs)).sum())
            num += label.size
        self._inc(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._inc(float(numpy.abs(label - pred).mean()), 1)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._inc(float(((label - pred) ** 2.0).mean()), 1)


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._inc(float(numpy.sqrt(((label - pred) ** 2.0).mean())), 1)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self._inc(float((-numpy.log(prob + self.eps)).sum()),
                      label.shape[0])


_alias("ce", CrossEntropy)


@register
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            label = label.ravel()
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples
            prob = pred[numpy.arange(num_examples), numpy.int64(label)]
            self._inc(float((-numpy.log(prob + self.eps)).sum()), num_examples)


_alias("nll_loss", NegativeLogLikelihood)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            check_label_shapes(label, pred, False, True)
            self._inc(float(numpy.corrcoef(pred.ravel(),
                                        label.ravel())[0, 1]), 1)


@register
class Loss(EvalMetric):
    """Dummy metric for mean of pre-computed per-sample losses."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, (list, tuple)):
            for pred in preds:
                loss = float(_np(pred).sum())
                self._inc(loss, _np(pred).size)
        else:
            self._inc(float(_np(preds).sum()), _np(preds).size)


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__(f"custom({name})" if "(" not in name else name,
                         output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self._inc(sum_metric, num_inst)
            else:
                self._inc(reval, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a NumPy eval function into a metric (parity: metric.np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = name if name else getattr(numpy_feval, "__name__",
                                               "custom")
    return CustomMetric(feval, feval.__name__, allow_extra_outputs)
