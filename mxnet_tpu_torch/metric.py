"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (reference: python/mxnet/metric.py):
``EvalMetric``, ``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss`` (and its
legacy names ``Torch`` and ``Caffe``), ``CustomMetric``, ``np`` and
``create``, registered under the JAX package's names and aliases.
``Accuracy`` on NDArrays accumulates on the device (argmax, compare, sum
into a 0-dim tensor), so a training step copies nothing to the host;
``get()`` is where the value is read.  The others accumulate on the host
in numpy, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

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

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
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

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [m.get_config() for m in self.metrics]})
        return config


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


@register
class F1(EvalMetric):
    """Binary F1 score (reference: metric.py:533): ``average="macro"``
    averages each batch's score, ``"micro"`` scores the counts of all
    batches."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.metrics.reset_stats()
            return
        self.sum_metric = self.metrics.fscore * self.metrics.total_examples
        self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


class _BinaryClassificationMetrics:
    """True/false positive and negative counts for F1 (reference:
    metric.py:482)."""

    def __init__(self):
        self.reset_stats()

    def update_binary_stats(self, label, pred):
        pred_np = _as_np(pred)
        label_np = _as_np(label).astype("int32")
        pred_label = numpy.argmax(pred_np, axis=1) if pred_np.ndim > 1 \
            else (pred_np > 0.5).astype("int32")
        check_label_shapes(label_np.ravel(), pred_label.ravel(), shape=True)
        if len(numpy.unique(label_np)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % self.__class__.__name__)
        pred_true = (pred_label.ravel() == 1)
        pred_false = ~pred_true
        label_true = (label_np.ravel() == 1)
        label_false = ~label_true
        self.true_positives += (pred_true & label_true).sum()
        self.false_positives += (pred_true & label_false).sum()
        self.false_negatives += (pred_false & label_true).sum()
        self.true_negatives += (pred_false & label_false).sum()

    @property
    def precision(self):
        tp = self.true_positives
        return tp / (tp + self.false_positives) \
            if tp + self.false_positives > 0 else 0.0

    @property
    def recall(self):
        tp = self.true_positives
        return tp / (tp + self.false_negatives) \
            if tp + self.false_negatives > 0 else 0.0

    @property
    def fscore(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r > 0 else 0.0

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives
                + self.true_negatives + self.true_positives)

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels, labels
    equal to ``ignore_label`` left out (reference: metric.py:761)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("%d labels for %d predictions"
                             % (len(labels), len(preds)))
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            lab = _as_np(label).astype("int32").ravel()
            p = _as_np(pred)
            p = p.reshape(-1, p.shape[-1] if self.axis == -1
                          else p.shape[self.axis])
            if lab.size != p.shape[0]:
                raise ValueError("shape mismatch: %s vs. %s"
                                 % (lab.shape, p.shape))
            probs = p[numpy.arange(lab.size), lab]
            if self.ignore_label is not None:
                ignore = (lab == self.ignore_label).astype(p.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += lab.size
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _as_columns(label, pred):
    """Labels and predictions as numpy, a 1-D one as a column."""
    lab, p = _as_np(label), _as_np(pred)
    if lab.ndim == 1:
        lab = lab.reshape(lab.shape[0], 1)
    if p.ndim == 1:
        p = p.reshape(p.shape[0], 1)
    return lab, p


@register
class MAE(EvalMetric):
    """Mean absolute error, averaged over batches (reference:
    metric.py:828)."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _as_columns(label, pred)
            self.sum_metric += numpy.abs(lab - p).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    """Mean squared error, averaged over batches (reference:
    metric.py:880)."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _as_columns(label, pred)
            self.sum_metric += ((lab - p) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    """Root mean squared error, averaged over batches (reference:
    metric.py:932)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _as_columns(label, pred)
            self.sum_metric += numpy.sqrt(((lab - p) ** 2.0).mean())
            self.num_inst += 1


@register
class NegativeLogLikelihood(EvalMetric):
    """Negative log-likelihood of the labels' probabilities (reference:
    metric.py:1043)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab = _as_np(label).ravel()
            p = _as_np(pred)
            num_examples = p.shape[0]
            if lab.shape[0] != num_examples:
                raise ValueError("%d labels for %d predictions"
                                 % (lab.shape[0], num_examples))
            prob = p[numpy.arange(num_examples, dtype=numpy.int64),
                     numpy.int64(lab)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@register
class PearsonCorrelation(EvalMetric):
    """Pearson correlation of predictions and labels, averaged over
    batches (reference: metric.py:1103)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, True)
            lab, p = _as_np(label).ravel(), _as_np(pred).ravel()
            self.sum_metric += numpy.corrcoef(p, lab)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """The mean of precomputed losses, the outputs themselves
    (reference: metric.py:1156)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        for pred in preds:
            p = _as_np(pred)
            self.sum_metric += p.sum()
            self.num_inst += p.size


@register
class Torch(Loss):
    """Legacy name of ``Loss`` (reference: metric.py:1189)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """Legacy name of ``Loss`` (reference: metric.py:1198)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, which returns
    a value or ``(sum, count)`` (reference: metric.py:1207)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` from a numpy function of ``(label, pred)``
    (reference: metric.py:1266)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
register(PearsonCorrelation, "pearsonr", "pearsoncorrelation")
register(Accuracy, "acc", "accuracy")
register(CrossEntropy, "ce", "cross-entropy")
register(NegativeLogLikelihood, "nll_loss")


def create(metric, *args, **kwargs):
    """A metric from a function (a ``CustomMetric``), a name, an
    EvalMetric or a list of them (reference: metric.py:32)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str) and metric.lower() in _METRIC_REGISTRY:
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise MXNetError("Metric must be either callable or str; got %r"
                     % (metric,))
