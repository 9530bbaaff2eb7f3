"""AlexNet (reference: python/mxnet/gluon/model_zoo/vision/alexnet.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Conv2D, Dense, Dropout, Flatten, HybridSequential,
                   MaxPool2D)

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """AlexNet per Krizhevsky 2012 (reference: alexnet.py:33)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(Conv2D(64, kernel_size=11, strides=4,
                                         padding=2, activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Conv2D(192, kernel_size=5, padding=2,
                                         activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Conv2D(384, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(Conv2D(256, kernel_size=3, padding=1,
                                         activation="relu"))
                self.features.add(MaxPool2D(pool_size=3, strides=2))
                self.features.add(Flatten())
                self.features.add(Dense(4096, activation="relu"))
                self.features.add(Dropout(0.5))
                self.features.add(Dense(4096, activation="relu"))
                self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """Reference: alexnet.py:77."""
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "alexnet", ctx=ctx, root=root)
    return net
