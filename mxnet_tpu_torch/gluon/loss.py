"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference:
python/mxnet/gluon/loss.py Loss:66, L2Loss:114, L1Loss:155,
SoftmaxCrossEntropyLoss:252).  This package carries the base ``Loss``
with its weighting and per-sample mean, and the losses a language model
and simple regression heads train with; each is written against ``F``
(the ``nd`` namespace), so it records under ``autograd.record()``.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


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
