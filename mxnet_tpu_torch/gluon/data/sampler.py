"""Gluon samplers (reference: python/mxnet/gluon/data/sampler.py;
counterpart of ``mxnet_tpu/gluon/data/sampler.py``).  RandomSampler
shuffles with numpy's global generator, as the JAX package's does, so
``np.random.seed`` fixes the order in both."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_LAST_BATCH = ("keep", "discard", "rollover")


class Sampler:
    """Base sampler (reference: sampler.py:27)."""

    def __iter__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError


class SequentialSampler(Sampler):
    """0 to ``length - 1`` in order (reference: sampler.py:41)."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """0 to ``length - 1`` shuffled anew each pass (reference:
    sampler.py:59)."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        np.random.shuffle(indices)
        return iter(indices)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """A sampler's indices in lists of ``batch_size`` (reference:
    sampler.py:78).  The last, short batch is kept, discarded, or rolled
    over to the front of the next pass, by ``last_batch``."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in _LAST_BATCH:
            raise ValueError("last_batch must be one of 'keep', 'discard', "
                             "or 'rollover', but got %s" % last_batch)
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._sampler = sampler
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._prev) + len(self._sampler)) // self._batch_size
