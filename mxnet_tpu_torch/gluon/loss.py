"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference:
python/mxnet/gluon/loss.py:66-666): the base ``Loss`` with its weighting
and per-sample mean, L2, L1, sigmoid binary cross-entropy, softmax
cross-entropy, KL divergence, Huber, hinge, squared hinge, logistic and
triplet losses.  Each is written against ``F`` (the ``nd`` namespace),
so it records under ``autograd.record()``.  ``CTCLoss`` comes with the
CTC op.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """``loss`` times ``sample_weight`` (broadcast) and the scalar
    ``weight`` (reference: loss.py:31)."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise ValueError("weight must be a number, got %r" % (weight,))
        loss = loss * weight
    return loss


def _mean_all_but_batch(loss, batch_axis):
    """The mean over every axis but ``batch_axis``: one loss per
    sample."""
    axes = tuple(i for i in range(len(loss.shape)) if i != batch_axis)
    if not axes:
        return loss
    return loss.mean(axis=axes if len(axes) > 1 else axes[0])


class Loss(HybridBlock):
    """Base loss (reference: loss.py:66): a scalar ``weight`` and the
    batch axis the per-sample mean keeps."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{name}(batch_axis={_batch_axis}, w={_weight})".format(
            name=self.__class__.__name__, **self.__dict__)

    def _shape_hook(self, inputs):
        pass

    def hybrid_forward(self, F, x, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` (reference: loss.py:114)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (pred - label).square()
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class L1Loss(Loss):
    """``|pred - label|`` (reference: loss.py:155)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (pred - label).abs()
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


def _softplus_minus(F, pred, label):
    """``log(1 + exp(pred)) - pred * label`` in the form that does not
    overflow: ``max(pred, 0) - pred * label + log(1 + exp(-|pred|))``."""
    return F.relu(pred) - pred * label + (1.0 + (-pred.abs()).exp()).log()


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (reference: loss.py:195),
    or of ``pred`` itself with ``from_sigmoid``."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            loss = _softplus_minus(F, pred, label)
        else:
            eps = 1e-12
            loss = -((pred + eps).log() * label
                     + (1.0 - pred + eps).log() * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy with integer (``sparse_label``) or dense
    labels (reference: loss.py:252): ``log_softmax`` over ``axis``
    unless ``from_logits``, then ``-pick(label)`` or ``-sum(pred *
    label)``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -pred.pick(label, axis=self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` a log-probability unless
    ``from_logits`` is False (reference: loss.py:317)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * ((label + 1e-12).log() - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class HuberLoss(Loss):
    """Smoothed L1: quadratic within ``rho``, linear past it (reference:
    loss.py:452)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = (pred - label).abs()
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * loss.square())
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` (reference: loss.py:500)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label) ** 2`` (reference: loss.py:547)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.relu(self._margin - pred * label).square()
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for labels of -1 and 1
    (``signed``) or 0 and 1 (``binary``) (reference: loss.py:594)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             "recieved %s." % label_format)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = _softplus_minus(F, pred, label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class TripletLoss(Loss):
    """``max(0, |pred - positive|^2 - |pred - negative|^2 + margin)``,
    the squares summed over every axis but the first (reference:
    loss.py:646)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        sq_pos = (pred - positive).square()
        sq_neg = (pred - negative).square()
        axes = tuple(range(1, len(pred.shape)))
        loss = (sq_pos - sq_neg).sum(
            axis=axes if len(axes) > 1 else axes[0]) + self._margin
        loss = F.relu(loss)
        return _apply_weighting(F, loss, self._weight, sample_weight)
