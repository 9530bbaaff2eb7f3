"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (reference:
python/mxnet/lr_scheduler.py): ``FactorScheduler``,
``MultiFactorScheduler`` and ``PolyScheduler``.  Each computes
lr(num_update) in closed form from the original base lr, so it may be
called with update counts out of order.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler:
    """Base scheduler: maps num_update -> lr."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):  # pragma: no cover - abstract
        raise NotImplementedError(
            "LRScheduler subclasses implement __call__(num_update)")


class FactorScheduler(LRScheduler):
    """lr = base * factor^(decays so far), one decay per ``step`` updates,
    floored at ``stop_factor_lr`` (reference: lr_scheduler.py:53)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step wants a positive update interval, got %r"
                             % (step,))
        if factor > 1.0:
            raise ValueError("a factor above 1 would raise the lr over "
                             "time; pass factor <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._logged_decays = 0

    def __call__(self, num_update):
        decays = max(0, (int(num_update) - 1) // self.step)
        lr = self.base_lr * (self.factor ** decays)
        floored = lr < self.stop_factor_lr
        if floored:
            lr = self.stop_factor_lr
        if decays > self._logged_decays:
            self._logged_decays = decays
            if floored:
                logging.info("update %d: lr floored at %0.5e (stop_factor_lr)",
                             num_update, lr)
            else:
                logging.info("update %d: lr decayed to %0.5e", num_update, lr)
        return lr


class MultiFactorScheduler(LRScheduler):
    """lr decays by ``factor`` as num_update passes each boundary in
    ``step`` (reference: lr_scheduler.py:95)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step wants a non-empty list of boundaries")
        if any(b < 1 for b in step):
            raise ValueError("every boundary wants a positive update count")
        if any(b >= a for b, a in zip(step, step[1:])):
            raise ValueError("boundaries must strictly increase, got %r"
                             % (step,))
        if factor > 1.0:
            raise ValueError("a factor above 1 would raise the lr over "
                             "time; pass factor <= 1")
        self.step = step
        self.factor = factor
        self._logged_decays = 0

    def __call__(self, num_update):
        decays = sum(1 for b in self.step if num_update > b)
        lr = self.base_lr * (self.factor ** decays)
        if decays > self._logged_decays:
            self._logged_decays = decays
            logging.info("update %d: lr decayed to %0.5e", num_update, lr)
        return lr


class PolyScheduler(LRScheduler):
    """lr = base * (1 - n / max_update) ^ pwr, 0 from ``max_update`` on
    (reference: lr_scheduler.py:139).  The base is the one given here:
    an optimizer's ``learning_rate`` does not move it, as in the JAX
    package."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update wants a positive int, got %r"
                             % (max_update,))
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        frac = min(float(num_update) / self.max_update, 1.0)
        self.base_lr = self.base_lr_orig * (1.0 - frac) ** self.power
        return self.base_lr
