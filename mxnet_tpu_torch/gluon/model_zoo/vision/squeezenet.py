"""SqueezeNet 1.0/1.1 (reference:
python/mxnet/gluon/model_zoo/vision/squeezenet.py; arch per 1602.07360)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Activation, AvgPool2D, Conv2D, Dropout, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = _FireExpand(expand1x1_channels, expand3x3_channels)
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, kernel_size, padding=padding))
    out.add(Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """Parallel 1x1 + 3x3 expand paths, concatenated."""

    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _make_fire_conv(e1, 1)
        self.p3 = _make_fire_conv(e3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p3(x), dim=1)


class SqueezeNet(HybridBlock):
    """SqueezeNet (reference: squeezenet.py:60)."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1"), \
            "Unsupported SqueezeNet version {}: 1.0 or 1.1 expected".format(
                version)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(Conv2D(96, kernel_size=7, strides=2))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(Conv2D(64, kernel_size=3, strides=2))
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(MaxPool2D(pool_size=3, strides=2,
                                            ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(Dropout(0.5))
            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, kernel_size=1))
            self.output.add(Activation("relu"))
            self.output.add(GlobalAvgPool2D())
            self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    """Reference: squeezenet.py get_squeezenet."""
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "squeezenet%s" % version, ctx=ctx, root=root)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
