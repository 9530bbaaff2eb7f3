"""Gluon datasets (reference: python/mxnet/gluon/data/dataset.py;
counterpart of ``mxnet_tpu/gluon/data/dataset.py``): Dataset with
``transform``/``transform_first``, SimpleDataset, ArrayDataset and
RecordFileDataset over the package's ``recordio``.

RecordFileDataset reads under a lock: a record is a seek and a read on
one file handle, and the DataLoader's worker threads share the dataset.
"""
from __future__ import annotations

import os
import threading

from ... import ndarray
from ... import recordio

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset (reference: dataset.py:30)."""

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """``fn`` applied to each sample (each element of a tuple sample
        passed as an argument), as read, or all at once unless ``lazy``
        (reference: dataset.py:38)."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` applied to the first element of each sample only
        (reference: dataset.py:64)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Any list-like (reference: dataset.py:89)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    """A dataset transformed as it is read (reference: dataset.py:103)."""

    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        return self._fn(*item) if isinstance(item, tuple) else self._fn(item)


class _TransformFirstClosure:
    """``fn`` on the first of the arguments (reference: dataset.py:118)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Arrays of one length zipped: sample ``i`` is the tuple of their
    ``i``-th elements, or the element of the one array (reference:
    dataset.py:127).  A 1-D NDArray is held as a host array."""

    def __init__(self, *args):
        if not args:
            raise ValueError("Needs at least 1 arrays")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    "All arrays must have the same length; array[0] has "
                    "length %d while array[%d] has %d."
                    % (self._length, i + 1, len(data)))
            if isinstance(data, ndarray.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of an indexed RecordIO file, as bytes (reference:
    dataset.py:161); the index is ``<filename less its extension>.idx``."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
