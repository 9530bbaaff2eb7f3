"""Gluon DataLoader (reference: python/mxnet/gluon/data/dataloader.py;
counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches come from a BatchSampler and ``batchify_fn`` (by default samples
stacked into NDArrays, float64 host data as float32).  With
``num_workers`` threads build the batches, in the sampler's order; the
JAX package submits every batch of the epoch at once, so this loader
keeps at most ``2 * num_workers`` in flight instead, which yields the same
batches in the same order with memory bounded by the window.

Batches are made on the context current where ``iter()`` is called: the
worker threads build them there too (a thread's own default context is
``gpu(0)``).  Iterate inside ``with mx.cpu():`` to build host batches,
as a training loop does before it copies each batch to the card.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ... import ndarray
from ...context import Context, current_context
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Samples stacked into a batch (reference: dataloader.py:87): NDArrays
    by ``nd.stack``, tuples element by element, anything else through a
    host array (float64 as float32)."""
    if isinstance(data[0], NDArray):
        return ndarray.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return ndarray.array(data, dtype=data.dtype if data.dtype != np.float64
                         else np.float32)


class DataLoader:
    """Batches of a Dataset (reference: dataloader.py:146)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _batch(self, ctx, indices):
        with Context(ctx):      # a with-block object of this thread's own
            return self._batchify_fn([self._dataset[int(i)]
                                      for i in indices])

    def __iter__(self):
        return self._iter(current_context())

    def _iter(self, ctx):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._batch(ctx, indices)
            return
        window = collections.deque()
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            for indices in self._batch_sampler:
                window.append(pool.submit(self._batch, ctx, indices))
                if len(window) == 2 * self._num_workers:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()

    def __len__(self):
        return len(self._batch_sampler)
