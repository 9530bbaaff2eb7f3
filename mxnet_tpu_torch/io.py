"""Data iterators and helpers.

Counterpart of ``mxnet_tpu/io.py`` (reference: python/mxnet/io.py): the
``DataDesc``/``DataBatch`` protocol, the ``DataIter`` base and the
in-memory ``NDArrayIter`` (pad, discard or roll over the last batch,
optional shuffle), plus ``pad_batch``, which the serving micro-batcher
uses.  ``NDArrayIter`` keeps its data on the host and hands out batches
as CPU NDArrays; the executor copies a batch to its device when it is
fed, so the iterator never decides where the model runs.  A batch whose
arrays already lie on the model's device is fed without a copy.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "pad_batch"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data description with dtype and layout (reference: io.py:67)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (
            self.name, self.shape, self.dtype, self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One mini-batch (reference: io.py:128)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("Data must be list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError("Label must be list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        label_shapes = [l.shape for l in self.label] if self.label else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Base iterator (reference: io.py:182)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):  # pragma: no cover - abstract
        pass

    def getdata(self):  # pragma: no cover - abstract
        pass

    def getlabel(self):  # pragma: no cover - abstract
        pass

    def getindex(self):
        return None

    def getpad(self):  # pragma: no cover - abstract
        pass


def _init_data(data, allow_empty, default_name):
    """Normalise the input to a sorted list of (name, host numpy array)
    (reference: io.py:499)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data must be given")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data must not be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return sorted((k, v.asnumpy() if isinstance(v, NDArray)
                   else np.asarray(v)) for k, v in data.items())


class NDArrayIter(DataIter):
    """In-memory iterator with shuffle and pad (reference: io.py:546).
    The shuffle draws from the CPU generator of ``random``."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.shuffle = shuffle
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            self._shuffle()
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    def _shuffle(self):
        from . import random as _random
        perm = torch.randperm(len(self.idx),
                              generator=_random.generator("cpu")).numpy()
        self.idx = self.idx[perm]

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def reset(self):
        if self.shuffle:
            self._shuffle()
        if (self.last_batch_handle == "roll_over"
                and self.cursor > self.num_data):
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise ValueError("DataIter needs reset.")
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [array(a[sel], ctx=cpu()) for _, a in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0


def pad_batch(parts, target_rows, axis=0):
    """Concatenate request arrays along the batch axis and pad up to a
    shape bucket by repeating the final row (a real sample keeps padded
    rows on the numerically exercised path; their outputs are sliced
    off).  Returns ``(batch, rows)``: the padded array and the valid row
    count before padding."""
    parts = [np.asarray(p) for p in parts]
    mat = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)
    rows = mat.shape[axis]
    target_rows = int(target_rows)
    if rows > target_rows:
        raise ValueError("pad_batch: %d rows exceed target %d"
                         % (rows, target_rows))
    if rows < target_rows:
        fill = np.repeat(np.take(mat, [-1], axis=axis),
                         target_rows - rows, axis=axis)
        mat = np.concatenate([mat, fill], axis=axis)
    return mat, rows
