"""Data iterators and helpers.

Counterpart of ``mxnet_tpu/io.py`` (reference: python/mxnet/io.py and the
C++ iterators of src/io/): the ``DataDesc``/``DataBatch`` protocol, the
``DataIter`` base, the in-memory ``NDArrayIter`` (pad, discard or roll
over the last batch, optional shuffle), ``ResizeIter``,
``PrefetchingIter`` (a thread a source, one batch ahead), ``MNISTIter``
(idx files, gz or not), ``CSVIter``, ``LibSVMIter`` (CSR batches
parsed straight from a libsvm file), the streaming ``ImageRecordIter``
and ``ImageDetRecordIter`` over a ``.rec`` file, the ``MXDataIter``
shell, and ``pad_batch``, which the serving micro-batcher uses.

``NDArrayIter`` keeps its data on the host and hands out batches as CPU
NDArrays; the executor copies a batch to its device when it is fed, so
the iterator never decides where the model runs.  A batch whose arrays
already lie on the model's device is fed without a copy.

``ImageRecordIter`` decodes with PIL on a pool of host threads (PIL
releases the GIL while it decompresses), normalises a whole batch in one
numpy pass and builds the batch's NDArrays on its producer thread, on
the context that was current where the iterator was made (the default
context is thread-local, so the producer takes it with it): the card
outside a ``with`` block, the host inside ``with mx.cpu():``.  The copy
to the card is a blocking one from pageable memory on the producer
thread, so it has landed before the consumer sees the batch.  A decode
or IO error on the producer is rethrown at ``next()`` and recorded with
``engine.record_exception`` for the next sync point, as is a fault
injected at the ``io.prefetch`` site.  The JAX package's native libjpeg
path is not part of the port.

Telemetry as in the JAX package: ``DataIter.__next__`` (what ``fit``
and a for-loop call) times each fetch into
``mxnet_io_batch_fetch_seconds`` and counts it in
``mxnet_io_batches_total`` while telemetry is on; the prefetching
iterators set ``mxnet_io_prefetch_depth{pipeline=...}`` and their
producer threads record ``io.prefetch`` spans while tracing is on.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from . import telemetry
from .base import MXNetError
from .context import Context, cpu, current_context
from .fault import hooks as _fault
from .ndarray import NDArray, array
from .telemetry import tracing as _tracing

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "MNISTIter", "CSVIter",
           "LibSVMIter", "ImageRecordIter", "ImageDetRecordIter", "MXDataIter",
           "pad_batch"]


# batch-fetch metric handles, cached per registry generation (a registry
# lookup per batch adds up on fast in-memory iterators)
_IO_METRICS = None


def _io_metrics():
    global _IO_METRICS
    reg = telemetry.get_registry()
    gen = reg.generation
    if _IO_METRICS is None or _IO_METRICS[0] != gen:
        _IO_METRICS = (
            gen,
            reg.histogram(
                "mxnet_io_batch_fetch_seconds",
                "wall time the training loop waited for the next batch "
                "(a stall here is an input-pipeline bottleneck)").labels(),
            reg.counter("mxnet_io_batches_total",
                        "batches handed to the consumer").labels())
    return _IO_METRICS


def _prefetch_depth(pipeline, depth):
    telemetry.gauge(
        "mxnet_io_prefetch_depth",
        "batches parked ahead of the consumer").labels(
        pipeline=pipeline).set(depth)


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

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


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
        # every iterator funnels through here when consumed by a for-loop
        # or next() (fit's hot path), so fetch latency, a prefetcher's
        # stall included, is measured in one place
        if not telemetry.enabled():
            return self.next()
        t0 = time.perf_counter()
        batch = self.next()      # StopIteration propagates unmeasured
        _gen, fetch_hist, batches = _io_metrics()
        fetch_hist.observe(time.perf_counter() - t0)
        batches.inc()
        return batch

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


class ResizeIter(DataIter):
    """A fixed number of batches per epoch over another iterator, which
    is reset and read again when it runs out (reference: io.py:284)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        self.cur += 1
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index


class _Prefetcher:
    """One daemon thread keeping one batch ahead of its consumer: it
    fetches while ``_hungry`` is set, parks the batch and sets
    ``_ready``; ``advance()`` hands the slot back.  A fetch error is
    recorded for the next sync point and parks None, as the epoch's end
    does."""

    def __init__(self, it):
        self.it = it
        self.batch = None
        self._ready = threading.Event()
        self._hungry = threading.Event()
        self._hungry.set()
        self._live = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            self._hungry.wait()
            if not self._live:
                return
            try:
                # a prefetch-thread fault defers to the next sync point
                # like a real decode or IO error
                with _tracing.span("io.prefetch"):
                    if _fault.ACTIVE[0]:
                        _fault.fire("io.prefetch")
                    fetched = self.it.next()
            except StopIteration:
                fetched = None
            except Exception as exc:    # rethrown at the next sync point
                from . import engine
                engine.record_exception(exc)
                fetched = None
            self.batch = fetched
            self._hungry.clear()
            self._ready.set()

    def peek(self):
        """The parked batch, once there (None at the epoch's end)."""
        self._ready.wait()
        return self.batch

    def advance(self):
        self._ready.clear()
        self._hungry.set()

    def restart(self):
        """A new epoch: let a fetch in flight land, reset, fetch again."""
        self._ready.wait()
        self.it.reset()
        self.advance()

    def close(self):
        self._live = False
        self._hungry.set()


class PrefetchingIter(DataIter):
    """Prefetches each of one or more iterators on its own thread and
    joins their batches (reference: io.py:349); ``rename_data`` and
    ``rename_label`` map each source's names, one dict a source."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise ValueError("PrefetchingIter needs at least one iterator")
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = None
        self._workers = [_Prefetcher(it) for it in iters]

    def __del__(self):
        for w in self._workers:
            w.close()

    def _descs(self, attr, rename):
        if rename is None:
            return sum([getattr(i, attr) for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in getattr(i, attr)]
                    for r, i in zip(rename, self.iters)], [])

    @property
    def provide_data(self):
        return self._descs("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._descs("provide_label", self.rename_label)

    def reset(self):
        for w in self._workers:
            w.restart()

    def iter_next(self):
        if telemetry.enabled():
            # depth-1 handshake per worker: ready == one batch parked
            _prefetch_depth("prefetching", sum(
                1 for w in self._workers if w._ready.is_set()))
        parked = [w.peek() for w in self._workers]
        if parked[0] is None:
            from . import engine
            engine.check_raise()    # a worker's error, not the epoch's end
            if not all(b is None for b in parked):
                raise MXNetError("Number of entry mismatches between "
                                 "iterators")
            return False
        lead = parked[0]
        if not all(b.pad == lead.pad for b in parked):
            raise MXNetError("Different pad number in the data batches")
        self.current_batch = DataBatch(
            [d for b in parked for d in b.data],
            [lab for b in parked for lab in b.label]
            if lead.label is not None else None,
            lead.pad, lead.index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for w in self._workers:
            w.advance()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad

    def getindex(self):
        return self.current_batch.index


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

    def hard_reset(self):
        self.cursor = -self.batch_size

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


class _Delegating(DataIter):
    """An iterator whose batches come from an inner ``NDArrayIter``."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()

    def getdata(self):
        return self._inner.getdata()

    def getlabel(self):
        return self._inner.getlabel()

    def getpad(self):
        return self._inner.getpad()


class MNISTIter(_Delegating):
    """MNIST idx files, gz or raw (reference: src/io/iter_mnist.cc):
    images scaled to [0, 1], as (N, 1, 28, 28) or flat."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_images(image)
        labels = self._read_labels(label)
        if num_parts > 1:
            n = len(imgs) // num_parts
            imgs = imgs[part_index * n:(part_index + 1) * n]
            labels = labels[part_index * n:(part_index + 1) * n]
        imgs = imgs.astype(np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(len(imgs), -1)
        else:
            imgs = imgs.reshape(len(imgs), 1, 28, 28)
        self._inner = NDArrayIter(
            {"data": imgs}, {"softmax_label": labels.astype(np.float32)},
            batch_size=batch_size, shuffle=shuffle)

    @staticmethod
    def _open(path):
        if path.endswith(".gz") or (not os.path.exists(path)
                                    and os.path.exists(path + ".gz")):
            return gzip.open(path if path.endswith(".gz") else path + ".gz",
                             "rb")
        return open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError("bad MNIST image magic %d in %s"
                                 % (magic, path))
            return np.frombuffer(f.read(n * rows * cols),
                                 dtype=np.uint8).reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError("bad MNIST label magic %d in %s"
                                 % (magic, path))
            return np.frombuffer(f.read(n), dtype=np.uint8)


class CSVIter(_Delegating):
    """Rows of a CSV file as samples of ``data_shape`` (reference:
    src/io/iter_csv.cc); labels from ``label_csv``, else zeros."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        else:
            label = np.zeros((len(data),), dtype=np.float32)
        self._inner = NDArrayIter(
            {"data": data}, {"softmax_label": label}, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")


def _parse_libsvm(path, width):
    """``(indptr, indices, values, labels)`` of a libsvm file, one CSR
    row a non-empty line (``label idx:val ...``, indices 0-based): each
    row's indices sorted, a repeated index keeping its last value and a
    zero value dropped, as a dense row per line would give them, though
    no dense row is built."""
    counts, idx, vals, labels = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            counts.append(len(parts) - 1)
            for tok in parts[1:]:
                i, v = tok.split(":")
                idx.append(int(i))
                vals.append(float(v))
    idx = np.asarray(idx, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    if idx.size and (idx.min() < 0 or idx.max() >= width):
        raise MXNetError("%s: a feature index lies outside [0, %d)"
                         % (path, width))
    rows = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    key = rows * width + idx
    order = np.argsort(key, kind="stable")
    key, rows, idx, vals = key[order], rows[order], idx[order], vals[order]
    keep = np.ones(key.size, dtype=bool)
    keep[:-1] = key[1:] != key[:-1]          # the last of a repeated index
    keep &= vals != 0
    rows, idx, vals = rows[keep], idx[keep], vals[keep]
    indptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=len(counts)), out=indptr[1:])
    return indptr, idx, vals, np.asarray(labels, dtype=np.float32)


class LibSVMIter(DataIter):
    """A libsvm file's rows as CSR batches (reference:
    src/io/iter_libsvm.cc): ``data`` a ``CSRNDArray`` of ``(batch_size,
    prod(data_shape))``, ``softmax_label`` dense, or from
    ``label_libsvm``'s rows when given.  The file is parsed straight into
    one CSR matrix (the JAX package builds a dense row a line); each
    batch is a slice of it, built on the context current where the
    iterator was made.  The last batch is padded with empty rows and
    zero labels (``pad``)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self._width = int(np.prod(self.data_shape))
        self._indptr, self._indices, self._values, labels = _parse_libsvm(
            data_libsvm, self._width)
        if label_libsvm is not None:
            lw = int(np.prod(tuple(label_shape)))
            ip, ix, vals, _ = _parse_libsvm(label_libsvm, lw)
            dense = np.zeros((len(ip) - 1, lw), dtype=np.float32)
            dense[np.repeat(np.arange(len(ip) - 1), np.diff(ip)), ix] = vals
            labels = dense.reshape(-1) if lw == 1 else dense
        self._labels = labels
        self.num = len(self._indptr) - 1
        self.round_batch = round_batch
        self.cursor = 0
        self._ctx = current_context()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self.cursor = 0

    def iter_next(self):
        return self.cursor < self.num

    def next(self):
        from .ndarray.sparse import CSRNDArray
        if self.cursor >= self.num:
            raise StopIteration
        c, b = self.cursor, self.batch_size
        n = min(b, self.num - c)
        lo, hi = int(self._indptr[c]), int(self._indptr[c + n])
        indptr = np.full(b + 1, hi - lo, dtype=np.int64)
        indptr[:n + 1] = self._indptr[c:c + n + 1] - lo
        lab = np.zeros((b,), dtype=np.float32)
        lab[:n] = self._labels[c:c + n]
        self.cursor += n
        data = CSRNDArray(self._values[lo:hi], indptr=indptr,
                          indices=self._indices[lo:hi],
                          shape=(b, self._width), ctx=self._ctx)
        return DataBatch(data=[data], label=[array(lab, ctx=self._ctx)],
                         pad=b - n)


_kREC_MAGIC = 0xced7230a


def _next_frame(read_header, skip):
    """One record's frames: ``read_header()`` gives each 8-byte frame
    header, ``skip(n)`` moves over (or takes) n payload bytes plus their
    padding."""
    magic, lrec = struct.unpack("<II", read_header())
    if magic != _kREC_MAGIC:
        raise MXNetError("invalid RecordIO magic %x" % magic)
    cflag = lrec >> 29
    length = lrec & ((1 << 29) - 1)
    skip(length)
    return cflag


def _scan_record_spans(path):
    """Byte spans ``[(start, end), ...]`` of the logical records of a
    RecordIO file, read from the frame headers alone (reference: the
    dmlc chunk reader of iter_image_recordio_2.cc:139)."""
    spans = []
    with open(path, "rb") as f:
        while True:
            start = f.tell()
            header = f.read(8)
            if len(header) < 8:
                break

            def skip(n):
                f.seek(n + (4 - n % 4) % 4, 1)

            cflag = _next_frame(lambda h=header: h, skip)
            while cflag not in (0, 3):      # multi-chunk continuation
                cflag = _next_frame(lambda: f.read(8), skip)
            spans.append((start, f.tell()))
    return spans


def _split_chunk_records(buf):
    """The logical record payloads in one contiguous byte range."""
    out = []
    pos = 0
    n = len(buf)
    while pos + 8 <= n:
        parts = []

        def header():
            nonlocal pos
            pos += 8
            return buf[pos - 8:pos]

        def take(length):
            nonlocal pos
            parts.append(buf[pos:pos + length])
            pos += length + (4 - length % 4) % 4

        cflag = _next_frame(header, take)
        while cflag not in (0, 3):
            cflag = _next_frame(header, take)
        out.append(parts[0] if len(parts) == 1 else b"".join(parts))
    return out


_MP_CFG = {}


def _mp_init(cfg):
    _MP_CFG.update(cfg)


def _mp_decode(job, cfg=None):
    """Decode and augment one record into a uint8 HWC crop: resize the
    short side, a random or centre crop, a random mirror, drawn from
    ``np.random.default_rng(seed)``.  Returns ``(crop, label)``.  ``cfg``
    defaults to the one ``_mp_init`` set; an ``ImageRecordIter`` passes
    its own, so that two iterators with other augmentations (a training
    and an evaluation one) each keep theirs.  (The JAX package reads the
    one module-wide dict, which the iterator made last overwrites.)"""
    raw, seed = job
    from . import recordio
    cfg = _MP_CFG if cfg is None else cfg
    header, img_bytes = recordio.unpack(raw)
    rng = np.random.default_rng(seed)
    _c, h, w = cfg["data_shape"]
    img = _imdecode(img_bytes)
    if cfg["resize"] > 0:
        img = _resize_short(img, cfg["resize"])
    ih, iw = img.shape[:2]
    if cfg["rand_crop"] and ih >= h and iw >= w:
        y = int(rng.integers(0, ih - h + 1))
        x = int(rng.integers(0, iw - w + 1))
        img = img[y:y + h, x:x + w]
    else:
        img = _center_crop_resize(img, h, w)
    if cfg["rand_mirror"] and rng.random() < 0.5:
        img = img[:, ::-1]
    label = header.label
    if isinstance(label, (np.ndarray, list, tuple)):
        label = np.asarray(label, np.float32)
    else:
        label = np.float32(label)
    return np.ascontiguousarray(img), label


def _normalize_batch(raw_u8, mean, std, scale):
    """uint8 NHWC -> float32 NCHW, then ``(x - mean) / std * scale``,
    each step taken only where it changes the values."""
    data = raw_u8.transpose(0, 3, 1, 2).astype(np.float32)
    if np.any(mean):
        data -= mean[None]
    if np.any(std != 1.0):
        data /= std[None]
    if scale != 1.0:
        data *= scale
    return data


class ImageRecordIter(DataIter):
    """The streaming RecordIO image pipeline (reference:
    src/io/iter_image_recordio_2.cc:50-332).

    - At open, a span index read from the frame headers alone; with
      ``num_parts`` > 1 this reader keeps every ``num_parts``-th record
      from ``part_index``.
    - A producer thread reads contiguous chunks of ``shuffle_chunk_size``
      records with one ``read()`` each, shuffling the chunk order and
      then the records within a chunk (``shuffle``).
    - A pool of ``preprocess_threads`` threads decodes and augments
      (``_mp_decode``); record ``i`` of epoch ``e`` draws its crop and
      mirror from seed ``(seed_aug, e, i)``, and the chunk order from
      ``seed_aug + e``.
    - The batch is normalised in one pass, padded at the epoch's end
      (``round_batch``: the pad rows are zeros and ``pad`` counts them),
      and parked in a queue of ``prefetch_buffer`` batches.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, scale=1.0, preprocess_threads=4,
                 round_batch=True, part_index=0, num_parts=1, resize=-1,
                 prefetch_buffer=4, shuffle_chunk_size=256, seed_aug=None,
                 **kwargs):
        super().__init__(batch_size)
        self.path_imgrec = path_imgrec
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = int(resize)
        self.mean = np.array([mean_r, mean_g, mean_b],
                             np.float32).reshape(3, 1, 1)
        self.std = np.array([std_r, std_g, std_b],
                            np.float32).reshape(3, 1, 1)
        self.scale = scale
        self.num_parts = num_parts
        self.part_index = part_index
        self.seed_aug = seed_aug
        self._ctx = Context(current_context())
        self._prefetch = max(int(prefetch_buffer), 1)
        spans = _scan_record_spans(path_imgrec)
        if num_parts > 1:
            spans = spans[part_index::num_parts]
        self._num_records = len(spans)
        csize = max(int(shuffle_chunk_size), 1)
        self._chunks = [spans[i:i + csize]
                        for i in range(0, len(spans), csize)]
        self._nproc = max(int(preprocess_threads), 1)
        self._cfg = dict(data_shape=self.data_shape, resize=self.resize,
                         rand_crop=rand_crop, rand_mirror=rand_mirror)
        _mp_init(self._cfg)
        self._pool = None
        if self._nproc > 1 and (os.cpu_count() or 1) > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=self._nproc)
        self._epoch = 0
        self._producer = None
        self._stop = None
        self._queue = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = ((self.batch_size,) if self.label_width == 1
               else (self.batch_size, self.label_width))
        return [DataDesc("softmax_label", shp)]

    def _stop_producer(self):
        if self._producer is not None and self._producer.is_alive():
            self._stop.set()
            # drain, so that a blocked put() wakes and sees the flag
            while self._producer.is_alive():
                try:
                    self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass
            self._producer.join()
        self._producer = None

    def reset(self):
        self._stop_producer()
        self._epoch += 1
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._prefetch)
        self._producer = threading.Thread(
            target=self._produce, args=(self._stop, self._queue, self._epoch),
            daemon=True)
        self._producer.start()
        self._next_batch = None

    def _decode(self, batch_raws, seeds):
        jobs = list(zip(batch_raws, seeds))
        if self._pool is not None:
            return list(self._pool.map(
                lambda job: _mp_decode(job, self._cfg), jobs))
        return [_mp_decode(j, self._cfg) for j in jobs]

    def _produce(self, stop, out_queue, epoch):
        """IO, decode and batch assembly, on the producer thread."""
        base_seed = (self.seed_aug if self.seed_aug is not None
                     else np.random.randint(1 << 31))
        order_rng = np.random.default_rng(base_seed + epoch)
        chunk_ids = np.arange(len(self._chunks))
        if self.shuffle:
            order_rng.shuffle(chunk_ids)
        pending = []
        counter = 0
        c, h, w = self.data_shape

        def put(item):
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue    # the consumer is slow: check stop, retry
            return False

        def flush(batch_raws, pad):
            nonlocal counter
            n = len(batch_raws)
            seeds = [(base_seed, epoch, counter + i) for i in range(n)]
            counter += n
            raw_u8 = np.zeros((self.batch_size, h, w, c), np.uint8)
            label = self._label_array()
            for i, (d, lab) in enumerate(self._decode(batch_raws, seeds)):
                raw_u8[i] = d
                self._store_label(label, i, lab)
            data = _normalize_batch(raw_u8, self.mean, self.std, self.scale)
            with self._ctx:
                batch = DataBatch(
                    data=[array(data)],
                    label=[array(self._finalize_label(label))], pad=pad)
            return put(batch)

        try:
            with open(self.path_imgrec, "rb") as f:
                for ci in chunk_ids:
                    if stop.is_set():
                        return
                    with _tracing.span("io.prefetch", chunk=int(ci)):
                        if _fault.ACTIVE[0]:
                            _fault.fire("io.prefetch")
                        chunk = self._chunks[ci]
                        start, end = chunk[0][0], chunk[-1][1]
                        f.seek(start)
                        buf = f.read(end - start)
                    # this shard's spans only: with num_parts > 1 the
                    # range also holds other shards' records
                    raws = [_split_chunk_records(buf[s - start:e - start])[0]
                            for s, e in chunk]
                    if self.shuffle:
                        order_rng.shuffle(raws)
                    pending.extend(raws)
                    while len(pending) >= self.batch_size:
                        if not flush(pending[:self.batch_size], 0):
                            return
                        pending = pending[self.batch_size:]
            if pending and not stop.is_set():
                if not flush(pending, self.batch_size - len(pending)):
                    return
            put(None)     # the epoch's end
        except Exception as exc:   # rethrown at next() and at a sync point
            from . import engine
            engine.record_exception(exc)
            try:
                out_queue.put(exc, timeout=1.0)
            except queue.Full:
                pass

    # label layout hooks (ImageDetRecordIter overrides them)
    def _label_array(self):
        return np.zeros((self.batch_size, self.label_width), np.float32)

    def _store_label(self, arr, i, lab):
        arr[i] = np.asarray(lab, np.float32).ravel()[:self.label_width]

    def _finalize_label(self, arr):
        return arr[:, 0] if self.label_width == 1 else arr

    def next(self):
        if self._next_batch is not None:
            b, self._next_batch = self._next_batch, None
            return b
        if telemetry.enabled():
            # queue depth BEFORE the (possibly blocking) get: 0 here while
            # the card waits means the decode pipeline is behind
            _prefetch_depth("image_record", self._queue.qsize())
        item = self._queue.get()
        if item is None:
            self._queue.put(None)       # later calls see the end too
            raise StopIteration
        if isinstance(item, Exception):
            from . import engine
            engine.consume_exception(item)
            raise item
        return item

    def iter_next(self):
        if self._next_batch is not None:
            return True
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False

    def close(self):
        self._stop_producer()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ImageDetRecordIter(ImageRecordIter):
    """Detection records: a header label ``[header_w, obj_w, extras...,
    then N rows of obj_w]`` (or bare rows of 5) becomes a
    ``(B,) + label_shape`` label, short images padded with -1 rows
    (reference: src/io/iter_image_det_recordio.cc)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_shape=(16, 5), **kwargs):
        self._det_label_shape = tuple(label_shape)
        kwargs.pop("label_width", None)
        super().__init__(path_imgrec, data_shape, batch_size,
                         label_width=int(np.prod(self._det_label_shape)),
                         **kwargs)

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size,)
                         + self._det_label_shape)]

    def _label_array(self):
        return np.full((self.batch_size,) + self._det_label_shape, -1.0,
                       np.float32)

    def _store_label(self, arr, i, lab):
        raw = np.asarray(lab, np.float32).ravel()
        if raw.size >= 7:
            header_w = int(raw[0])
            obj_w = int(raw[1])
            objs = raw[header_w:].reshape(-1, obj_w)
        else:
            objs = raw.reshape(-1, 5)
        n = min(objs.shape[0], self._det_label_shape[0])
        w = min(objs.shape[1], self._det_label_shape[1])
        arr[i, :n, :w] = objs[:n, :w]

    def _finalize_label(self, arr):
        return arr


def _imdecode(img_bytes):
    """JPEG or PNG bytes -> HWC uint8 RGB, by PIL."""
    from PIL import Image
    import io as _pyio
    return np.asarray(Image.open(_pyio.BytesIO(img_bytes)).convert("RGB"))


def _resize_short(img, size):
    """Resize so that the shorter edge is ``size`` (PIL bilinear)."""
    from PIL import Image
    ih, iw = img.shape[:2]
    if min(ih, iw) == size:
        return img
    if ih < iw:
        h, w = size, max(int(round(iw * size / ih)), 1)
    else:
        h, w = max(int(round(ih * size / iw)), 1), size
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def _center_crop_resize(img, h, w):
    """A centre crop to (h, w), or a nearest-neighbour resize when the
    image is smaller."""
    ih, iw = img.shape[:2]
    if ih == h and iw == w:
        return img
    if ih >= h and iw >= w:
        y, x = (ih - h) // 2, (iw - w) // 2
        return img[y:y + h, x:x + w]
    yi = (np.arange(h) * ih / h).astype(int)
    xi = (np.arange(w) * iw / w).astype(int)
    return img[yi][:, xi]


class MXDataIter(DataIter):
    """The reference's wrapper of a C++ iterator (``python/mxnet/io.py:
    766``).  Every iterator here is Python, so this shell only wraps a
    given ``DataIter`` (``handle``), for code that subclasses it or
    checks ``isinstance``; anything else raises."""

    def __init__(self, handle=None, data_name="data",
                 label_name="softmax_label", **_):
        super().__init__()
        if handle is None or not isinstance(handle, DataIter):
            raise MXNetError(
                "MXDataIter wraps a native iterator in this build; pass a "
                "DataIter instance (or use the named iterators directly)")
        self._it = handle
        self.data_name = data_name
        self.label_name = label_name

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label

    @property
    def batch_size(self):
        return self._it.batch_size

    @batch_size.setter
    def batch_size(self, value):    # DataIter.__init__ assigns it
        pass

    def reset(self):
        self._it.reset()

    def next(self):
        return self._it.next()


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
