"""Detection image iterator.

Counterpart of ``mxnet_tpu/image/detection.py`` (reference:
``python/mxnet/image/detection.py``): ``ImageDetIter`` with the
detection augmenters ``DetBorrowAug`` and ``DetHorizontalFlipAug`` over
the label format ``[header_width, obj_width, (id, xmin, ymin, xmax,
ymax)...]``.
"""
from __future__ import annotations

import random as pyrandom

import numpy as np

from .. import io as mxio
from .. import ndarray
from .image import Augmenter, CreateAugmenter, ImageIter, imdecode

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter base (reference: detection.py:44)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):  # pragma: no cover - abstract
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Borrow a classification augmenter (reference: detection.py:77)."""

    def __init__(self, augmenter):
        assert isinstance(augmenter, Augmenter)
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image + boxes (reference: detection.py:106)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            a = src.asnumpy()
            src = ndarray.array(a[:, ::-1], dtype=a.dtype)
            valid = label[:, 0] > -1
            tmp = 1.0 - label[valid, 1]
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = tmp
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2, **kwargs):
    """Standard detection augmenter list (reference: detection.py
    CreateDetAugmenter)."""
    auglist = []
    cls_augs = CreateAugmenter(data_shape, resize=resize, mean=mean, std=std,
                               brightness=brightness, contrast=contrast,
                               saturation=saturation, pca_noise=pca_noise,
                               hue=hue, inter_method=inter_method)
    for aug in cls_augs:
        auglist.append(DetBorrowAug(aug))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator (reference: detection.py ImageDetIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=aug_list,
                         imglist=imglist, data_name=data_name,
                         label_name=label_name)
        # detection label: variable number of objects per image; find the
        # padded label shape by scanning
        self.max_objects = 0
        self.label_shape = None
        self._scan_label_shape()
        self.provide_label = [mxio.DataDesc(
            label_name, (batch_size,) + self.label_shape)]

    def _scan_label_shape(self):
        max_count = 1
        obj_width = 5
        saved = self.cur
        self.cur = 0
        count = 0
        try:
            while count < 64:  # sample for a bound
                label, _ = self.next_sample()
                label = self._parse_label(label)
                max_count = max(max_count, label.shape[0])
                obj_width = label.shape[1]
                count += 1
        except StopIteration:
            pass
        self.cur = saved
        self.max_objects = max_count
        self.label_shape = (max_count, obj_width)

    def _parse_label(self, label):
        """Decode packed header label to (N, 5) boxes (reference:
        detection.py _parse_label)."""
        if isinstance(label, ndarray.NDArray):
            label = label.asnumpy()
        # a copy: a label unpacked from a record is a read-only view of
        # its bytes, and the augmenters write into the boxes (the JAX
        # package parses the view, and its DetHorizontalFlipAug raises)
        raw = np.array(label, np.float32).ravel()
        if raw.size < 7:
            # plain [id x1 y1 x2 y2]
            return raw.reshape(-1, 5)
        header_width = int(raw[0])
        obj_width = int(raw[1])
        assert obj_width >= 5, "object width must >= 5"
        assert (raw.size - header_width) % obj_width == 0, \
            "label length %d is invalid" % raw.size
        out = raw[header_width:].reshape(-1, obj_width)
        return out

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, c, h, w), np.float32)
        batch_label = np.full((batch_size,) + self.label_shape, -1.0,
                              np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                data = imdecode(s) if isinstance(s, (bytes, bytearray)) \
                    else ndarray.array(s)
                label = self._parse_label(label)
                for aug in self.auglist:
                    data, label = aug(data, label)
                batch_data[i] = data.asnumpy().transpose(2, 0, 1)
                n = min(label.shape[0], self.max_objects)
                batch_label[i, :n, :label.shape[1]] = label[:n]
                i += 1
        except StopIteration:
            if not i:
                raise
        pad = batch_size - i
        return mxio.DataBatch([ndarray.array(batch_data)],
                              [ndarray.array(batch_label)], pad=pad)

    def reshape(self, data_shape=None, label_shape=None):
        """Reference: detection.py reshape."""
        if data_shape is not None:
            self.check_data_shape(data_shape)
            self.data_shape = tuple(data_shape)
            self.provide_data = [mxio.DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + self.data_shape)]
        if label_shape is not None:
            self.label_shape = tuple(label_shape)
            self.provide_label = [mxio.DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + self.label_shape)]
