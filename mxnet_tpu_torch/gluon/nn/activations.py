"""Gluon activation layers (reference: python/mxnet/gluon/nn/activations.py;
counterpart of ``mxnet_tpu/gluon/nn/activations.py``): Activation,
LeakyReLU, PReLU, ELU, SELU and Swish, each one ``LeakyReLU``/
``Activation`` op or, for Swish, ``x * sigmoid(beta * x)``."""
from __future__ import annotations

from ... import initializer
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish"]


class Activation(HybridBlock):
    """Activation by name (reference: activations.py:30)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere (reference:
    activations.py:61)."""

    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise ValueError("Slope coefficient for LeakyReLU must be no "
                             "less than 0.")
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha,
                           name="fwd")

    def __repr__(self):
        return "LeakyReLU(%s)" % self._alpha


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope, the one-element parameter
    ``alpha`` (reference: activations.py:94), 0.25 at first."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def _shape_hook(self, inputs):
        pass

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    """``alpha * (exp(x) - 1)`` below 0 (reference: activations.py:131)."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (reference: activations.py:156)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)`` (reference: activations.py:177)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x, name="fwd")
