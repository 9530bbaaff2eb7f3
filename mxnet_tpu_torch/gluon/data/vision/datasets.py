"""Gluon vision datasets (reference:
python/mxnet/gluon/data/vision/datasets.py; counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10, CIFAR100, ImageRecordDataset and ImageFolderDataset.

MNIST and CIFAR read the files already under ``root`` (the idx files,
plain or gzipped; CIFAR's python pickle batches) and raise MXNetError
naming the missing file: nothing is downloaded.  Images are uint8 HWC
NDArrays made on the current context.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from .... import ndarray
from ....base import MXNetError
from .... import recordio
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """Base for file-backed datasets (reference: datasets.py:43)."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):  # pragma: no cover - abstract
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (reference: datasets.py:70); reads idx files from root."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _open(self, fname):
        path = os.path.join(self._root, fname)
        if os.path.exists(path):
            return open(path, "rb")
        if os.path.exists(path + ".gz"):
            return gzip.open(path + ".gz", "rb")
        raise MXNetError(
            "MNIST file %s not found under %s (nothing is downloaded; place "
            "the idx files there)" % (fname, self._root))

    def _get_data(self):
        image_file, label_file = (self._train_files if self._train
                                  else self._test_files)
        with self._open(label_file) as fin:
            magic, n = struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(n), dtype=np.uint8).astype(np.int32)
        with self._open(image_file) as fin:
            magic, n, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(n * rows * cols), dtype=np.uint8)
            data = data.reshape(n, rows, cols, 1)
        self._data = ndarray.array(data, dtype=np.uint8)
        self._label = label


class FashionMNIST(MNIST):
    """FashionMNIST, same format as MNIST (reference: datasets.py:125)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the python pickle batches (reference: datasets.py:156)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            batch = pickle.load(fin, encoding="latin1")
        data = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = batch.get("labels", batch.get("fine_labels"))
        return data, np.asarray(labels, dtype=np.int32)

    def _batch_files(self):
        if self._train:
            return ["data_batch_%d" % i for i in range(1, 6)]
        return ["test_batch"]

    def _find(self, fname):
        for base in (self._root,
                     os.path.join(self._root, "cifar-10-batches-py"),
                     os.path.join(self._root, "cifar-100-python")):
            p = os.path.join(base, fname)
            if os.path.exists(p):
                return p
        raise MXNetError(
            "CIFAR file %s not found under %s (nothing is downloaded; "
            "extract the python-version archive there)"
            % (fname, self._root))

    def _get_data(self):
        data, label = zip(*[self._read_batch(self._find(f))
                            for f in self._batch_files()])
        data = np.concatenate(data)
        label = np.concatenate(label)
        self._data = ndarray.array(data, dtype=np.uint8)
        self._label = label


class CIFAR100(CIFAR10):
    """CIFAR100 (reference: datasets.py:207)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            batch = pickle.load(fin, encoding="latin1")
        data = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        labels = batch["fine_labels" if self._fine_label else "coarse_labels"]
        return data, np.asarray(labels, dtype=np.int32)

    def _batch_files(self):
        return ["train"] if self._train else ["test"]


class ImageRecordDataset(RecordFileDataset):
    """Images in a RecordIO file (reference: datasets.py:256)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = super().__getitem__(idx)
        header, img = recordio.unpack_img(record, self._flag)
        img = ndarray.array(img, dtype=np.uint8)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """folder/label/img.jpg layout (reference: datasets.py:290)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from PIL import Image
        fname, label = self.items[idx]
        img = np.asarray(Image.open(fname).convert(
            "RGB" if self._flag else "L"))
        if img.ndim == 2:
            img = img[:, :, None]
        img = ndarray.array(img, dtype=np.uint8)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
