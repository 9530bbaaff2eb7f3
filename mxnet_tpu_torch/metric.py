"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference: python/mxnet/metric.py):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``CrossEntropy`` and ``create``.  ``Accuracy`` on NDArrays accumulates
on the device (argmax, compare, sum into a 0-dim tensor), so a training
step copies nothing to the host; ``get()`` is where the value is read.
The others accumulate on the host, as in the JAX package.
"""
from __future__ import annotations

import numpy
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "CrossEntropy", "create", "register"]

_METRIC_REGISTRY = {}


def register(klass, *names):
    for n in names or (klass.__name__.lower(),):
        _METRIC_REGISTRY[n.lower()] = klass
    return klass


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


class EvalMetric:
    """Base metric (reference: metric.py:68)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

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

    def update(self, labels, preds):  # pragma: no cover - abstract
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        # sum_metric may be a device scalar (Accuracy): reading it is the
        # synchronisation point
        return (self.name, float(self.sum_metric) / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics at once (reference: metric.py:233)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [m if isinstance(m, EvalMetric) else create(m)
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {name: label for name, label in labels.items()
                      if name in self.label_names}
        if self.output_names is not None:
            preds = {name: pred for name, pred in preds.items()
                     if name in self.output_names}
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)


@register
class Accuracy(EvalMetric):
    """Classification accuracy (reference: metric.py:363)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            if isinstance(pred_label, NDArray) and isinstance(label, NDArray):
                p, lab = pred_label._data, label._data
                if p.dim() > 1 and p.shape[self.axis] > 1 \
                        and p.dim() != lab.dim():
                    if p.numel() // p.shape[self.axis] != lab.numel():
                        raise ValueError(
                            "Shape of labels %s does not match shape of "
                            "predictions %s" % (tuple(lab.shape),
                                                tuple(p.shape)))
                    p = torch.argmax(p, dim=self.axis)
                p = p.to(torch.int32).reshape(-1)
                lab = lab.to(device=p.device, dtype=torch.int32).reshape(-1)
                check_label_shapes(lab, p, shape=True)
                self.sum_metric = (p == lab).sum() + self.sum_metric
                self.num_inst += int(lab.numel())
                continue
            p = _as_np(pred_label)
            if p.ndim > 1 and p.shape[self.axis] > 1 \
                    and p.ndim != _as_np(label).ndim:
                p = numpy.argmax(p, axis=self.axis)
            lab = _as_np(label).astype("int32").ravel()
            p = p.astype("int32").ravel()
            check_label_shapes(lab, p, shape=True)
            self.sum_metric += (p == lab).sum()
            self.num_inst += len(p)


@register
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference: metric.py:446)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more "
                             "than 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            p = numpy.argsort(_as_np(pred_label).astype("float32"), axis=1)
            lab = _as_np(label).astype("int32")
            num_samples = p.shape[0]
            if p.ndim == 1:
                self.sum_metric += (p.ravel() == lab.ravel()).sum()
            elif p.ndim == 2:
                num_classes = p.shape[1]
                for j in range(min(num_classes, self.top_k)):
                    self.sum_metric += (p[:, num_classes - 1 - j].ravel()
                                        == lab.ravel()).sum()
            self.num_inst += num_samples


@register
class CrossEntropy(EvalMetric):
    """Cross entropy against integer labels (reference: metric.py:985)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab = _as_np(label).ravel()
            p = _as_np(pred)
            if lab.shape[0] != p.shape[0]:
                raise ValueError("%d labels for %d predictions"
                                 % (lab.shape[0], p.shape[0]))
            prob = p[numpy.arange(lab.shape[0]), numpy.int64(lab)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += lab.shape[0]


register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(Accuracy, "acc", "accuracy")
register(CrossEntropy, "ce", "cross-entropy")


def create(metric, *args, **kwargs):
    """A metric from a name, an EvalMetric or a list of them (reference:
    metric.py:32)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str) and metric.lower() in _METRIC_REGISTRY:
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise MXNetError("Metric must be an EvalMetric, a list or a known "
                     "name; got %r" % (metric,))
