"""Gluon vision transforms (reference:
python/mxnet/gluon/data/vision/transforms.py; counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``): Compose, Cast, ToTensor,
Normalize, RandomResizedCrop, CenterCrop, Resize, RandomFlipLeftRight/
TopBottom, RandomBrightness/Contrast/Saturation/Hue, RandomColorJitter
and RandomLighting.

They work on host arrays, as the JAX package's do: each reads its input
back to the host, computes in numpy (random draws from numpy's global
generator, resizing by nearest neighbour) and returns an NDArray on the
current context, so inside a DataLoader they run on its worker threads
and, iterated under ``with mx.cpu():``, never touch the card.
"""
from __future__ import annotations

import numpy as np

from .... import ndarray
from ....ndarray import NDArray
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "CenterCrop", "Resize", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomLighting",
           "RandomColorJitter", "ColorJitter"]


def _as_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


class Compose(Sequential):
    """Sequentially composes transforms (reference: transforms.py:37)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            if not isinstance(t, Block):
                t = _FnTransform(t)
            self.add(t)


class _FnTransform(Block):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, x):
        return self._fn(x)


class Cast(Block):
    """Cast dtype (reference: transforms.py:82)."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference: transforms.py:100)."""

    def forward(self, x):
        a = _as_np(x).astype(np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return ndarray.array(a)


class Normalize(Block):
    """(x - mean) / std per channel on CHW (reference: transforms.py:133)."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def forward(self, x):
        a = _as_np(x)
        mean = self._mean.reshape(-1, 1, 1)
        std = self._std.reshape(-1, 1, 1)
        return ndarray.array((a - mean) / std)


def _resize(a, size):
    """Nearest-neighbor resize HWC (no cv2 dependency)."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    ih, iw = a.shape[:2]
    yi = np.clip((np.arange(h) * ih / h).astype(int), 0, ih - 1)
    xi = np.clip((np.arange(w) * iw / w).astype(int), 0, iw - 1)
    return a[yi][:, xi]


class Resize(Block):
    """Resize to (w, h) (reference: transforms.py:316)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        return ndarray.array(_resize(_as_np(x), self._size))


class CenterCrop(Block):
    """Center crop to size (reference: transforms.py:284)."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        a = _as_np(x)
        w, h = self._size
        ih, iw = a.shape[:2]
        if ih < h or iw < w:
            a = _resize(a, (max(w, iw), max(h, ih)))
            ih, iw = a.shape[:2]
        y0, x0 = (ih - h) // 2, (iw - w) // 2
        return ndarray.array(a[y0:y0 + h, x0:x0 + w])


class RandomResizedCrop(Block):
    """Random crop + resize (reference: transforms.py:236)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        a = _as_np(x)
        ih, iw = a.shape[:2]
        area = ih * iw
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= iw and h <= ih:
                x0 = np.random.randint(0, iw - w + 1)
                y0 = np.random.randint(0, ih - h + 1)
                return ndarray.array(_resize(a[y0:y0 + h, x0:x0 + w],
                                             self._size))
        return ndarray.array(_resize(a, self._size))


class RandomFlipLeftRight(Block):
    """Reference: transforms.py:344."""

    def forward(self, x):
        if np.random.rand() < 0.5:
            return ndarray.array(_as_np(x)[:, ::-1])
        return x if isinstance(x, NDArray) else ndarray.array(x)


class RandomFlipTopBottom(Block):
    """Reference: transforms.py:361."""

    def forward(self, x):
        if np.random.rand() < 0.5:
            return ndarray.array(_as_np(x)[::-1])
        return x if isinstance(x, NDArray) else ndarray.array(x)


class RandomBrightness(Block):
    """Reference: transforms.py:378."""

    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        return ndarray.array(np.clip(_as_np(x).astype(np.float32) * alpha,
                                     0, 255))


class RandomContrast(Block):
    """Reference: transforms.py:398."""

    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def forward(self, x):
        a = _as_np(x).astype(np.float32)
        alpha = np.random.uniform(*self._args)
        gray = a.mean()
        return ndarray.array(np.clip(a * alpha + gray * (1 - alpha), 0, 255))


class RandomSaturation(Block):
    """Reference: transforms.py:418."""

    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0, 1 - saturation), 1 + saturation)

    def forward(self, x):
        a = _as_np(x).astype(np.float32)
        alpha = np.random.uniform(*self._args)
        gray = a.mean(axis=-1, keepdims=True)
        return ndarray.array(np.clip(a * alpha + gray * (1 - alpha), 0, 255))


class RandomHue(Block):
    """Random hue rotation in the YIQ plane (reference: transforms.py:438
    random_hue — the same linear-RGB approximation the image_random op
    uses, src/operator/image/image_random-inl.h)."""

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        a = _as_np(x).astype(np.float32)
        alpha = np.random.uniform(-self._hue, self._hue)
        if alpha == 0.0:
            # the YIQ<->RGB matrices are approximate inverses; skip the
            # round-trip entirely for a zero rotation
            return ndarray.array(a)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], np.float32)
        t_rgb = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], np.float32)
        m = t_rgb @ rot @ t_yiq
        return ndarray.array(np.clip(a @ m.T, 0, 255))


class RandomLighting(Block):
    """AlexNet-style PCA noise (reference: transforms.py:478
    random_lighting; eigen basis from the reference augmenter,
    image_aug_default.cc)."""

    _EIGVAL = np.array([55.46, 4.794, 1.148], np.float32)
    _EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _as_np(x).astype(np.float32)
        alpha = np.random.normal(0, self._alpha, 3).astype(np.float32)
        rgb = (self._EIGVEC * alpha) @ self._EIGVAL
        return ndarray.array(np.clip(a + rgb, 0, 255))


class RandomColorJitter(Block):
    """Random brightness/contrast/saturation/hue in random order
    (reference: transforms.py:458)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        order = np.random.permutation(len(self._transforms))
        for i in order:
            x = self._transforms[i](x)
        return x


# pre-1.3 name kept for compatibility
ColorJitter = RandomColorJitter
