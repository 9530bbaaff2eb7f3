"""Gluon convolution and pooling layers (reference:
python/mxnet/gluon/nn/conv_layers.py; counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): the ``_Conv`` base with
Conv1D-3D and their transposes (the ``Deconvolution`` op, with
``output_padding`` as its ``adj``), the ``_Pooling`` base with Max, Avg,
GlobalMax and GlobalAvg pooling in 1-3D (``ceil_mode`` is the op's
``pooling_convention="full"``), and ReflectionPad2D.  A layer made with
``in_channels=0`` takes its weight's input channels from the first
input (``_shape_hook``)."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation
from .basic_layers import _init

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _check_layout(layout, allowed):
    if layout not in allowed:
        raise ValueError("Only supports %s layout for now"
                         % " and ".join("'%s'" % a for a in allowed))


def _to_tuple(x, n):
    if isinstance(x, int):
        return (x,) * n
    return tuple(x)


class _Conv(HybridBlock):
    """Base conv layer (reference: conv_layers.py:36)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            if isinstance(strides, int):
                strides = (strides,) * len(kernel_size)
            if isinstance(padding, int):
                padding = (padding,) * len(kernel_size)
            if isinstance(dilation, int):
                dilation = (dilation,) * len(kernel_size)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj

            self._groups = groups
            dshape = [0] * (len(kernel_size) + 2)
            dshape[layout.find("N")] = 1
            dshape[layout.find("C")] = in_channels
            wshapes = self._infer_weight_shape(op_name, tuple(dshape))
            self.weight = self.params.get(
                "weight", shape=wshapes[1], init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=wshapes[2], init=_init(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_weight_shape(self, op_name, data_shape):
        k = self._kwargs["kernel"]
        nf = self._kwargs["num_filter"]
        ng = self._kwargs["num_group"]
        c = data_shape[1]
        if op_name == "Convolution":
            return (data_shape, (nf, c // ng if c else 0) + tuple(k), (nf,))
        # Deconvolution
        return (data_shape, (c, nf // ng) + tuple(k), (nf,))

    def _shape_hook(self, inputs):
        x = inputs[0]
        c = x.shape[1]
        ng = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        nf = self._kwargs["num_filter"]
        if self._op_name == "Convolution":
            self.weight.shape = (nf, c // ng) + k
        else:
            self.weight.shape = (c, nf // ng) + k

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, name="fwd", **self._kwargs)
        else:
            act = op(x, weight, bias, name="fwd", **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        len_kernel_size = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * len_kernel_size:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * len_kernel_size:
            s += ", dilation={dilate}"
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        s += ")"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]),
                        **self._kwargs)


class Conv1D(_Conv):
    """1D conv, NCW (reference: conv_layers.py:180)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 1)
        _check_layout(layout, ("NCW",))
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    """2D conv, NCHW (reference: conv_layers.py:256)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 2)
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    """3D conv, NCDHW (reference: conv_layers.py:336)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 3)
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """1D transposed conv (reference: conv_layers.py:417)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 1)
        output_padding = _to_tuple(output_padding, 1)
        _check_layout(layout, ("NCW",))
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)
        self.outpad = output_padding


class Conv2DTranspose(_Conv):
    """2D transposed conv (reference: conv_layers.py:504)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 2)
        output_padding = _to_tuple(output_padding, 2)
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)
        self.outpad = output_padding


class Conv3DTranspose(_Conv):
    """3D transposed conv (reference: conv_layers.py:597)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 3)
        output_padding = _to_tuple(output_padding, 3)
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution", adj=output_padding, **kwargs)
        self.outpad = output_padding


class _Pooling(HybridBlock):
    """Base pooling (reference: conv_layers.py:687)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        return "{name}(size={kernel}, stride={stride}, padding={pad}, " \
            "ceil_mode={ceil_mode})".format(
                name=self.__class__.__name__,
                ceil_mode=self._kwargs["pooling_convention"] == "full",
                **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        _check_layout(layout, ("NCW",))
        super().__init__(_to_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        _check_layout(layout, ("NCHW",))
        super().__init__(_to_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        _check_layout(layout, ("NCDHW",))
        super().__init__(_to_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        _check_layout(layout, ("NCW",))
        super().__init__(_to_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW", count_include_pad=True,
                 **kwargs):
        _check_layout(layout, ("NCHW",))
        super().__init__(_to_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", count_include_pad=True,
                 **kwargs):
        _check_layout(layout, ("NCDHW",))
        super().__init__(_to_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        _check_layout(layout, ("NCW",))
        super().__init__((1,), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        _check_layout(layout, ("NCHW",))
        super().__init__((1, 1), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        _check_layout(layout, ("NCDHW",))
        super().__init__((1, 1, 1), None, 0, True, True, "max", **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        _check_layout(layout, ("NCW",))
        super().__init__((1,), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        _check_layout(layout, ("NCHW",))
        super().__init__((1, 1), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        _check_layout(layout, ("NCDHW",))
        super().__init__((1, 1, 1), None, 0, True, True, "avg", **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding (reference: conv_layers.py:1083)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if len(padding) != 8:
            raise ValueError("ReflectionPad2D takes 8 pad widths, got %d"
                             % len(padding))
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
