"""Deprecated learning-rate scheduler shims.

Counterpart of ``mxnet_tpu/misc.py`` (reference: python/mxnet/misc.py):
the pre-1.0 ``FactorScheduler`` API kept for old scripts, as thin
adapters over :mod:`lr_scheduler`.
"""
import warnings

from . import lr_scheduler as _lrs

__all__ = ["LearningRateScheduler", "FactorScheduler", "multi_factor_scheduler"]


class LearningRateScheduler:
    """Deprecated base (reference: misc.py:24); use
    ``mx.lr_scheduler.LRScheduler``."""

    def __call__(self, iteration):  # pragma: no cover - abstract
        raise NotImplementedError


class FactorScheduler(LearningRateScheduler):
    """Deprecated (reference: misc.py:41); use
    ``mx.lr_scheduler.FactorScheduler``."""

    def __init__(self, step, factor=0.1):
        warnings.warn("mxnet.misc.FactorScheduler is deprecated; use "
                      "mx.lr_scheduler.FactorScheduler", DeprecationWarning)
        self._impl = _lrs.FactorScheduler(step=step, factor=factor)

    def __call__(self, iteration):
        return self._impl(iteration)


def multi_factor_scheduler(begin_epoch, epoch_size, step=(), factor=0.1):
    """Build a MultiFactorScheduler offset by ``begin_epoch`` (the
    resume-from-checkpoint helper old example scripts used)."""
    steps = [epoch_size * (s - begin_epoch)
             for s in step if s - begin_epoch > 0]
    if not steps:
        return None
    return _lrs.MultiFactorScheduler(step=steps, factor=factor)
