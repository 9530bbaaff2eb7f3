"""Bucketing data iterator for variable-length sequences.

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference: ``python/mxnet/rnn/
io.py``): ``BucketSentenceIter`` (:78) puts each sentence in the
smallest bucket that holds it, pads it with ``invalid_label`` to the
bucket's length, and emits batches with ``bucket_key`` so that a
``BucketingModule`` switches executors.  The label is the input shifted
by one token.  The bucket arrays are made on the current context at
each ``reset()``.
"""
from __future__ import annotations

import random as pyrandom

import numpy as np

from .. import ndarray
from ..io import DataIter, DataBatch, DataDesc

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Bucketing iterator over encoded sentences (reference: io.py:78)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for i, sent in enumerate(sentences):
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        if ndiscard:
            import logging
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket.", ndiscard)

        self.batch_size, self.buckets = batch_size, buckets
        self.data_name, self.label_name = data_name, label_name
        self.dtype, self.invalid_label = dtype, invalid_label
        self.layout, self.major_axis = layout, layout.find("N")
        self.nddata, self.ndlabel = [], []
        self.default_bucket_key = max(buckets)

        if self.major_axis == 0:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(batch_size, self.default_bucket_key),
                layout=self.layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(batch_size, self.default_bucket_key),
                layout=self.layout)]
        elif self.major_axis == 1:
            self.provide_data = [DataDesc(
                name=self.data_name,
                shape=(self.default_bucket_key, batch_size),
                layout=self.layout)]
            self.provide_label = [DataDesc(
                name=self.label_name,
                shape=(self.default_bucket_key, batch_size),
                layout=self.layout)]
        else:
            raise ValueError("Invalid layout %s: Must by NT (batch major) or "
                             "TN (time major)" % layout)

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        """Shuffle buckets and within buckets (reference: io.py reset)."""
        self.curr_idx = 0
        pyrandom.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)

        self.nddata, self.ndlabel = [], []
        for buck in self.data:
            # label = input shifted by one (next-token prediction)
            label = np.concatenate(
                [buck[:, 1:],
                 np.full((len(buck), 1), self.invalid_label, buck.dtype)],
                axis=1)
            self.nddata.append(ndarray.array(buck, dtype=self.dtype))
            self.ndlabel.append(ndarray.array(label, dtype=self.dtype))

    def next(self):
        """Next bucketed batch (reference: io.py next)."""
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1

        if self.major_axis == 1:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]

        def desc(name, arr):
            return DataDesc(name=name, shape=arr.shape, layout=self.layout)

        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[desc(self.data_name, data)],
                         provide_label=[desc(self.label_name, label)])
