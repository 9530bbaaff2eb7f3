"""Image IO and augmentation.

Counterpart of ``mxnet_tpu/image/image.py`` (reference:
``python/mxnet/image/image.py``): ``imread``/``imdecode`` and the resize
and crop helpers, the ``Augmenter`` classes (:482-760),
``CreateAugmenter`` and ``ImageIter``, the Python pipeline over a
``.rec``, a ``.lst`` or a list of images.  Decoding and augmenting run
on the host, in numpy with PIL (there is no OpenCV), drawing from
Python's ``random`` and numpy's global generator as the JAX package
does; results are NDArrays on the current context.
"""
from __future__ import annotations

import os
import random as pyrandom

import numpy as np

from .. import io as mxio
from .. import ndarray
from .. import recordio
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["imread", "imdecode", "imresize", "resize_short", "scale_down",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug",
           "RandomOrderAug", "ResizeAug",
           "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug",
           "ColorNormalizeAug", "RandomGrayAug", "CreateAugmenter",
           "ImageIter"]


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError:  # pragma: no cover
        raise MXNetError("image operations require PIL in this build")


def imread(filename, flag=1, to_rgb=True):
    """Read image file to NDArray HWC uint8 (reference: image.py imread)."""
    img = _pil().open(filename)
    img = img.convert("RGB" if flag else "L")
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    if flag and not to_rgb:
        a = a[:, :, ::-1]
    return ndarray.array(a, dtype=np.uint8)


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode image bytes (reference: image.py imdecode)."""
    import io as pyio
    img = _pil().open(pyio.BytesIO(buf))
    img = img.convert("RGB" if flag else "L")
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[:, :, None]
    if flag and not to_rgb:
        a = a[:, :, ::-1]
    return ndarray.array(a, dtype=np.uint8)


def _np_resize(a, w, h):
    """Bilinear resize via PIL (HWC uint8/float)."""
    Image = _pil()
    dtype = a.dtype
    if a.shape[2] == 1:
        img = Image.fromarray(a[:, :, 0].astype(np.uint8))
    else:
        img = Image.fromarray(a.astype(np.uint8))
    img = img.resize((w, h), Image.BILINEAR)
    out = np.asarray(img)
    if out.ndim == 2:
        out = out[:, :, None]
    return out.astype(dtype)


def imresize(src, w, h, interp=1):
    """Resize to (w, h) (reference: image.py imresize)."""
    a = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    return ndarray.array(_np_resize(a, w, h), dtype=a.dtype)


def scale_down(src_size, size):
    """Scale (w, h) down to fit within src_size, keeping aspect ratio
    (reference: image.py scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize the shorter edge to `size` (reference: image.py resize_short)."""
    a = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    h, w = a.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return ndarray.array(_np_resize(a, new_w, new_h), dtype=a.dtype)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop at (x0, y0) sized (w, h), optionally resize
    (reference: image.py fixed_crop)."""
    a = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    out = a[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _np_resize(out, size[0], size[1])
    return ndarray.array(out, dtype=a.dtype)


def random_crop(src, size, interp=2):
    """Random crop to size (reference: image.py random_crop)."""
    a = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    h, w = a.shape[:2]
    new_w, new_h = size
    x0 = pyrandom.randint(0, max(0, w - new_w))
    y0 = pyrandom.randint(0, max(0, h - new_h))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop (reference: image.py center_crop)."""
    a = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    h, w = a.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random crop with size/aspect jitter (reference: image.py
    random_size_crop)."""
    a = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    h, w = a.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std (reference: image.py color_normalize)."""
    a = src.asnumpy().astype(np.float32) if isinstance(src, NDArray) \
        else np.asarray(src, np.float32)
    mean = np.asarray(mean, np.float32)
    out = a - mean
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return ndarray.array(out)


# ---------------------------------------------------------------------------
# augmenters (reference: image.py:482-760)
# ---------------------------------------------------------------------------
class Augmenter:
    """Image augmenter base (reference: image.py:482)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                kwargs[k] = v.asnumpy().tolist()

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):  # pragma: no cover - abstract
        raise NotImplementedError


class SequentialAug(Augmenter):
    """Compose augmenters (reference: image.py SequentialAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply augmenters in a random order (reference: image.py
    RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        import random as _pyrandom
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for aug in ts:
            src = aug(src)
        return src


class ResizeAug(Augmenter):
    """Resize shorter edge (reference: image.py ResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Force exact size (reference: image.py ForceResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            a = src.asnumpy() if isinstance(src, NDArray) else src
            return ndarray.array(a[:, ::-1], dtype=a.dtype)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        a = src.asnumpy()
        gray = (a * self.coef).sum()
        gray = (3.0 * (1.0 - alpha) / a.size) * gray
        return ndarray.array(a * alpha + gray)


class SaturationJitterAug(Augmenter):
    coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        a = src.asnumpy()
        gray = (a * self.coef).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return ndarray.array(a * alpha + gray)


class HueJitterAug(Augmenter):
    """Hue jitter via YIQ rotation (reference: image.py HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], np.float32)

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      np.float32)
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        a = src.asnumpy()
        return ndarray.array(np.dot(a, t))


class ColorJitterAug(SequentialAug):
    """Random order brightness/contrast/saturation (reference: image.py)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA lighting noise (reference: image.py LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return src + ndarray.array(rgb.astype(np.float32))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = np.array([[0.21, 0.21, 0.21],
                             [0.72, 0.72, 0.72],
                             [0.07, 0.07, 0.07]], np.float32)

    def __call__(self, src):
        if pyrandom.random() < self.p:
            a = src.asnumpy()
            return ndarray.array(np.dot(a, self.mat))
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference: image.py
    CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean)
        assert mean.shape[0] in [1, 3]
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std)
        assert std.shape[0] in [1, 3]
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(mxio.DataIter):
    """Python image iterator over .rec or .lst (reference: image.py
    ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.seq = None
        self.imgrec = None
        self.imglist = {}
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx,
                                                         path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self._records = []
                while True:
                    item = self.imgrec.read()
                    if item is None:
                        break
                    self._records.append(item)
                self.seq = list(range(len(self._records)))
        elif path_imglist:
            with open(path_imglist) as fin:
                for line in fin.readlines():
                    line = line.strip().split("\t")
                    label = np.array(line[1:-1], dtype=np.float32)
                    key = int(line[0])
                    self.imglist[key] = (label, line[-1])
            self.seq = sorted(self.imglist.keys())
        else:
            self.imglist = {}
            index = 0
            for img in imglist:
                key = str(index)
                index += 1
                if isinstance(img[0], (list, np.ndarray)):
                    label = np.array(img[0], dtype=np.float32)
                else:
                    label = np.array([img[0]], dtype=np.float32)
                self.imglist[key] = (label, img[1])
            self.seq = sorted(self.imglist.keys())

        if num_parts > 1:
            assert part_index < num_parts
            N = len(self.seq)
            C = N // num_parts
            self.seq = self.seq[part_index * C:(part_index + 1) * C]

        self.path_root = path_root
        self.shuffle = shuffle
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.provide_data = [mxio.DataDesc(data_name,
                                           (batch_size,) + self.data_shape)]
        if label_width > 1:
            self.provide_label = [mxio.DataDesc(label_name,
                                                (batch_size, label_width))]
        else:
            self.provide_label = [mxio.DataDesc(label_name, (batch_size,))]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle:
            pyrandom.shuffle(self.seq)
        self.cur = 0

    def next_sample(self):
        """Next (label, image bytes/array) (reference: image.py
        next_sample)."""
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            if hasattr(self, "_records"):
                s = self._records[idx]
            else:
                s = self.imgrec.read_idx(idx)
            header, img = recordio.unpack(s)
            return header.label, img
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root or "", fname), "rb") as f:
            img = f.read()
        return label, img

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, c, h, w), np.float32)
        batch_label = np.zeros((batch_size, self.label_width), np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                data = imdecode(s) if isinstance(s, (bytes, bytearray)) \
                    else ndarray.array(s)
                data = self.augmentation_transform(data)
                batch_data[i] = data.asnumpy().transpose(2, 0, 1)
                batch_label[i] = label
                i += 1
        except StopIteration:
            if not i:
                raise
        pad = batch_size - i
        lab = batch_label[:, 0] if self.label_width == 1 else batch_label
        return mxio.DataBatch([ndarray.array(batch_data)],
                              [ndarray.array(lab)], pad=pad)

    def augmentation_transform(self, data):
        """Apply augmenter chain (reference: image.py
        augmentation_transform)."""
        for aug in self.auglist:
            data = aug(data)
        return data

    def check_data_shape(self, data_shape):
        if not len(data_shape) == 3:
            raise ValueError("data_shape should have length 3, with "
                             "dimensions CxHxW")
        if not data_shape[0] == 3:
            raise ValueError("This iterator expects inputs to have 3 "
                             "dimensions.")
