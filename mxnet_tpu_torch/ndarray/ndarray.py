"""NDArray over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``: the handle keeps its
tensor in ``_data`` (executors and predictors alias parameters by
assigning ``_data``, never by copying).  This package carries the
surface the serving and training paths touch — construction (``array``,
``zeros``, ``ones``, ``empty``), ``asnumpy``, ``shape``, ``dtype``,
``context``, ``copyto`` (into another NDArray, which may be a view of a
larger buffer, or onto a context), ``astype``, ``wait_to_read``, basic
indexing and ``arr[:] = value`` — and the surface gluon blocks touch:
``+ - * / **`` (and the reflected forms and negation) with NDArrays or
scalars, ``reshape`` with MXNet's 0/-1/-2/-3/-4 codes, ``expand_dims``,
``sum``, ``mean``, ``abs``, ``square``, ``exp``, ``log``, ``pick``, each
through its registered op, and ``arange``; and autograd's surface:
``attach_grad``, ``grad``, ``backward`` and ``detach``.  Every op on an
array records exactly while ``autograd.record()`` is on (torch's grad
mode follows the flag).  The rest of the JAX package's surface: ``ctx``,
``ndim``, ``T``, ``as_in_context``, ``asscalar``/``item`` (and
``float()``, ``int()``, ``bool()``, ``len()``, iteration), ``%`` and the
comparison operators (0/1 arrays of the left operand's dtype), the
in-place operators (which rebind the array to the new values), and the
fluent methods, each its registered op (``register.attach_methods``
adds the single-tensor ones).

``save``/``load``/``load_buffer`` read and write MXNet's V2 NDArray
container byte for byte as the JAX package does, so ``.params`` files
move between the two packages; ``load`` puts the arrays on ``ctx``
(default the current context).  An NDArray pickles through host memory,
so a pickle holds no CUDA storage and loads on a machine without a
card.
"""
from __future__ import annotations

import io
import numbers
import struct

import numpy as np
import torch

from .. import autograd, engine, telemetry
from .._atomic_io import atomic_writer
from ..base import MXNetError, dtype_from_id, dtype_id, dtype_name, dtype_torch
from ..context import Context, resolve

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "moveaxis", "concat", "concatenate", "onehot_encode", "waitall",
           "save", "load", "load_buffer", "imdecode"]

# the 64-bit numpy types nd.array narrows, as the JAX package does
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


# sync-point metric handles, cached per registry generation (they run per
# output per request under the serving batcher: skip the registry lock)
_SYNC_METRICS = None


def _sync_metrics():
    global _SYNC_METRICS
    reg = telemetry.get_registry()
    gen = reg.generation
    if _SYNC_METRICS is None or _SYNC_METRICS[0] != gen:
        _SYNC_METRICS = (
            gen,
            reg.counter("mxnet_sync_waits_total",
                        "host blocks on device work "
                        "(wait_to_read/waitall)").labels(),
            reg.counter("mxnet_transfer_d2h_total",
                        "device->host copies (asnumpy sync points)"
                        ).labels(),
            reg.counter("mxnet_transfer_d2h_bytes_total",
                        "bytes copied device->host at asnumpy sync "
                        "points").labels())
    return _SYNC_METRICS


class NDArray:
    """A device tensor handle (reference: python/mxnet/ndarray/ndarray.py)."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, ctx=None):
        """Wrap ``data`` (a tensor, an NDArray's tensor, or a host array,
        narrowed to 32 bits as ``array`` does), moved to ``ctx`` when one
        is given."""
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
            data = data.to(_NARROW.get(data.dtype, data.dtype))
        if ctx is not None:
            data = data.to(resolve(ctx))
        self._data = data
        self._grad = None           # the grad buffer of a marked variable
        self._grad_req = "null"

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        """The MXNet dtype string (``"float32"``, ``"bfloat16"``...)."""
        return dtype_name(self._data.dtype)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def handle(self):
        """The reference exposes the C handle; here the torch tensor that
        holds the data is the handle."""
        return self._data

    @property
    def context(self):
        d = self._data.device
        return Context("gpu" if d.type == "cuda" else "cpu", d.index or 0)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    def as_in_context(self, context):
        """This array on ``context``: itself when it is there already,
        else a copy (reference: ndarray.py as_in_context)."""
        if Context(context) == self.context:
            return self
        return self.copyto(context)

    def asscalar(self):
        """The value of a one-element array, as a numpy scalar."""
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def asnumpy(self):
        """Copy to a host numpy array (the synchronisation point, which
        first rethrows a deferred worker exception: ``engine``).
        bfloat16, which numpy lacks, comes back as float32."""
        engine.check_raise()
        t = self._data.detach()
        if telemetry.enabled():
            _gen, _sync, d2h, d2h_bytes = _sync_metrics()
            d2h.inc()
            d2h_bytes.inc(t.numel() * t.element_size())
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def wait_to_write(self):
        self.wait_to_read()

    def wait_to_read(self):
        """Block until every queued write to this array has finished
        (the device's queue is drained; on the CPU there is nothing to
        wait for).  A deferred worker exception is rethrown first
        (``engine``)."""
        engine.check_raise()
        if telemetry.enabled():
            _sync_metrics()[1].inc()
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, written in place, so a view of
        a larger buffer stays one) or onto a Context (a new NDArray
        there)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            other[:] = self
            return other
        with autograd.grad_mode():
            return NDArray(self._data.to(resolve(other), copy=True))

    def copy(self):
        with autograd.grad_mode():
            return NDArray(self._data.clone())

    def detach(self):
        """The same values outside the recorded graph."""
        return NDArray(self._data.detach())

    def astype(self, dtype, copy=True):
        """A copy in ``dtype`` (``copy=False`` returns self when the dtype
        already matches)."""
        dt = dtype_torch(dtype)
        if not copy and dt == self._data.dtype:
            return self
        with autograd.grad_mode():
            return NDArray(self._data.to(dtype=dt, copy=True))

    def __getitem__(self, key):
        """Basic indexing (ints and slices): a view, as in MXNet."""
        if isinstance(key, (numbers.Integral, slice)) or (
                isinstance(key, tuple) and all(
                    isinstance(k, (numbers.Integral, slice)) for k in key)):
            with autograd.grad_mode():
                return NDArray(self._data[key])
        raise MXNetError("NDArray indexing takes ints and slices, got %r"
                         % (key,))

    def __setitem__(self, key, value):
        """``arr[:] = value`` (a scalar, an NDArray, a tensor or a host
        array) writes in place; other keys write that region.  Under
        ``record()`` the write records (a value that records flows into
        the region); a write into a marked variable raises MXNetError."""
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (torch.Tensor, numbers.Number)):
            value = torch.from_numpy(np.ascontiguousarray(value))

        def write():
            dst = self._data if (isinstance(key, slice)
                                 and key == slice(None)) \
                else self._data[key]
            if isinstance(value, numbers.Number):
                dst.fill_(value)
            else:
                dst.copy_(value)

        if not autograd.is_recording():
            with torch.no_grad():
                write()
            return
        try:
            with torch.enable_grad():
                write()
        except RuntimeError as exc:
            raise MXNetError(
                "in-place write under autograd.record() refused (%s): an "
                "array marked for gradient, or a view of one, cannot be "
                "written while its values are recorded; write outside "
                "record(), or compute a new array" % exc) from exc

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)

    def __reduce__(self):
        """Pickle through a host numpy array (bfloat16, which numpy lacks,
        as its raw 16-bit words); the copy comes back on the CPU."""
        t = self._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _rebuild_ndarray, (t.view(torch.int16).numpy(),
                                      "bfloat16")
        return _rebuild_ndarray, (t.numpy(),)

    # -- ops gluon blocks call as methods (each its registered op) ----------
    def _op(self, name, inputs=(), **attrs):
        from ..imperative import invoke
        return invoke(name, [self, *inputs], attrs)

    def reshape(self, *shape, **kwargs):
        """Reshape with MXNet's codes: 0 copies a dim, -1 infers one, -2
        copies the rest, -3 merges two, -4 splits one
        (``reverse=True`` matches from the right)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self._op("Reshape", shape=kwargs.get("shape", shape),
                        reverse=kwargs.get("reverse", False))

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def sum(self, axis=None, keepdims=False):
        return self._op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._op("mean", axis=axis, keepdims=keepdims)

    def abs(self):
        return self._op("abs")

    def square(self):
        return self._op("square")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def pick(self, index, axis=-1, keepdims=False, mode="clip"):
        """``self[..., index, ...]`` along ``axis``, one element per
        position of ``index`` (reference: ndarray.py pick)."""
        return self._op("pick", [index], axis=axis, keepdims=keepdims,
                        mode=mode)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def broadcast_to(self, shape):
        return self._op("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other):
        return self._op("broadcast_like", [other])

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._op("transpose", **({"axes": axes} if axes else {}))

    def swapaxes(self, dim1, dim2):
        return self._op("SwapAxis", dim1=dim1, dim2=dim2)

    def flatten(self):
        return self._op("Flatten")

    def squeeze(self, axis=None):
        return self._op("squeeze", **({"axis": axis} if axis is not None
                                      else {}))

    def flip(self, axis):
        return self._op("reverse", axis=axis)

    def tile(self, reps):
        return self._op("tile", reps=reps)

    def repeat(self, repeats, axis=None):
        return self._op("repeat", repeats=repeats, axis=axis)

    def pad(self, mode, pad_width, constant_value=0.0):
        return self._op("Pad", mode=mode, pad_width=pad_width,
                        constant_value=constant_value)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op("SliceChannel", num_outputs=num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=None):
        return self._op("slice", begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", [indices], axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return self._op("one_hot", depth=depth, on_value=on_value,
                        off_value=off_value, dtype=dtype)

    def clip(self, a_min=None, a_max=None):
        return self._op("clip", a_min=a_min, a_max=a_max)

    def sign(self):
        return self._op("sign")

    def sqrt(self):
        return self._op("sqrt")

    def sigmoid(self):
        return self._op("sigmoid")

    def tanh(self):
        return self._op("tanh")

    def relu(self):
        return self._op("relu")

    def softmax(self, axis=-1):
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op("log_softmax", axis=axis)

    def prod(self, axis=None, keepdims=False):
        return self._op("prod", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op("argmin", axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return self._op("argsort", axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return self._op("sort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._op("topk", axis=axis, k=k, ret_typ=ret_typ,
                        is_ascend=is_ascend)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return self._op("dot", [other], transpose_a=transpose_a,
                        transpose_b=transpose_b)

    def tostype(self, stype):
        """This array in the storage type ``stype``: itself for
        ``default``, else a sparse array (``sparse.cast_storage``)."""
        if stype == "default":
            return self
        from . import sparse
        return sparse.cast_storage(self, stype)

    def as_nd_ndarray(self):
        return self

    # -- autograd (reference: ndarray.py attach_grad, grad, backward) -------
    @property
    def grad(self):
        """The grad buffer ``attach_grad`` attached, or None."""
        return self._grad

    def attach_grad(self, grad_req="write", stype=None):
        """Mark this array as a variable to take gradients for, with a
        zero buffer of its shape (``autograd.mark_variables``).  The
        buffer is dense whatever ``stype`` says, as in the JAX package."""
        buf = NDArray(torch.zeros_like(self._data,
                                       memory_format=torch.contiguous_format))
        autograd.mark_variables([self], [buf], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """``autograd.backward`` from this array, with ``out_grad`` as its
        gradient (ones by default)."""
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph, train_mode)

    # -- arithmetic (reference: ndarray.py _binop) ---------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, np.ndarray):
            other = array(other, ctx=self.context)
        if isinstance(other, NDArray):
            return self._op(op, [other]) if not reverse \
                else other._op(op, [self])
        if isinstance(other, numbers.Number) and scalar_op is not None:
            return self._op(scalar_op, scalar=float(other))
        return NotImplemented

    def __add__(self, other):
        return self._binop(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "elemwise_sub", "_rminus_scalar",
                           reverse=True)

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "elemwise_div", "_rdiv_scalar",
                           reverse=True)

    def __pow__(self, other):
        return self._binop(other, "_power", "_power_scalar")

    def __neg__(self):
        return self._op("negative")

    def __rpow__(self, other):
        return self._binop(other, "_power", "_rpower_scalar", reverse=True)

    def __mod__(self, other):
        return self._binop(other, "_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binop(other, "_mod", "_rmod_scalar", reverse=True)

    def __eq__(self, other):
        if other is None:
            return False
        return self._binop(other, "_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return self._binop(other, "_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._binop(other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binop(other, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binop(other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binop(other, "_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def _inplace(self, res):
        if res is NotImplemented:
            return res
        self._data = res._data
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))


def _rebuild_ndarray(a, dtype=None):
    t = torch.from_numpy(np.require(a, requirements=("C", "W")))
    return NDArray(t.view(torch.bfloat16) if dtype == "bfloat16" else t)


def array(source_array, ctx=None, dtype=None):
    """A new NDArray holding a copy of ``source_array`` on ``ctx`` (default the
    current context), with the JAX package's dtype rule: an explicit ``dtype``
    wins; an NDArray keeps its dtype; a numpy array keeps its dtype, except
    that float64 becomes float32 (MXNet's default) and int64 int32 (the JAX
    package runs with 32-bit types); anything else (a list, a scalar, a torch
    tensor) becomes float32."""
    device = resolve(ctx)
    if isinstance(source_array, NDArray):
        src = source_array._data
        dt = src.dtype
    elif isinstance(source_array, np.ndarray):
        src = torch.from_numpy(np.asarray(source_array, order="C"))
        dt = _NARROW.get(src.dtype, src.dtype)
    elif isinstance(source_array, torch.Tensor):
        src, dt = source_array, torch.float32
    else:
        src = torch.from_numpy(np.asarray(source_array, dtype=np.float32))
        dt = torch.float32
    if dtype is not None:
        dt = dtype_torch(dtype)
    return NDArray(src.detach().to(device=device, dtype=dt, copy=True))


def zeros(shape, ctx=None, dtype=None):
    return NDArray(torch.zeros(tuple(shape), dtype=dtype_torch(dtype),
                               device=resolve(ctx)))


def ones(shape, ctx=None, dtype=None):
    return NDArray(torch.ones(tuple(shape), dtype=dtype_torch(dtype),
                              device=resolve(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``[start, stop)`` by ``step``, each value ``repeat`` times, on
    ``ctx`` (default the current context), float32 unless ``dtype`` says
    otherwise (reference: ndarray.py arange, the ``_arange`` op)."""
    from ..imperative import invoke
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "ctx": ctx, "dtype": dtype})


def empty(shape, ctx=None, dtype=None):
    """An uninitialised array (``torch.empty``)."""
    return NDArray(torch.empty(tuple(shape), dtype=dtype_torch(dtype),
                               device=resolve(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(tuple(shape), val, dtype=dtype_torch(dtype),
                              device=resolve(ctx)))


def moveaxis(tensor, source, destination):
    with autograd.grad_mode():
        return NDArray(torch.movedim(tensor._data, source, destination))


def concat(*data, dim=1):
    from ..imperative import invoke
    return invoke("Concat", list(data), {"dim": dim})


def concatenate(arrays, axis=0, always_copy=True):
    from ..imperative import invoke
    return invoke("Concat", list(arrays), {"dim": axis})


def onehot_encode(indices, out):
    """``out`` rebound to the one-hot rows of ``indices`` (its width is
    out's second dim)."""
    from ..imperative import invoke
    out._data = invoke("one_hot", [indices],
                       {"depth": out.shape[1]})._data.to(out._data.dtype)
    return out


def imdecode(buf, **kwargs):
    """Decode image bytes into an (H, W, 3) uint8 RGB NDArray (reference:
    the ``_cvimdecode`` op behind ``nd.imdecode``), through the PIL
    decoder of ``image.imdecode``; extra arguments are ignored."""
    del kwargs
    from ..image.image import imdecode as _decode
    return _decode(buf, flag=1, to_rgb=True)


def waitall():
    """Block until every queued operation on every card has finished
    (reference: MXNDArrayWaitAll), then rethrow a deferred worker
    exception (``engine``)."""
    if telemetry.enabled():
        _sync_metrics()[1].inc()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    engine.check_raise()


# ---------------------------------------------------------------------------
# serialization: MXNet's V2 NDArray container (reference:
# src/ndarray/ndarray.cc:1552; mxnet_tpu/ndarray/ndarray.py), little-endian:
# the list magic 0x112, a reserved u64 and the array count (u64 each); per
# array the V2 magic (u64), stype -1 (i32), ndim (u32), each dim (i64), the
# context (two i32, always cpu(0), as the JAX package writes it), the dtype
# id (i32) and the raw bytes; then the name count (u64) and each name as a
# u64 length and its UTF-8 bytes.
# ---------------------------------------------------------------------------
_LIST_MAGIC = 0x112
_NDARRAY_V2_MAGIC = 0xF993FAC9


def _write_ndarray(f, arr):
    t = arr._data.detach().cpu().contiguous()
    f.write(struct.pack("<Qi", _NDARRAY_V2_MAGIC, -1))
    f.write(struct.pack("<I", t.dim()))
    f.write(struct.pack("<%dq" % t.dim(), *t.shape))
    f.write(struct.pack("<iii", 1, 0, dtype_id(t.dtype)))
    if t.numel():
        f.write(t.reshape(-1).view(torch.uint8).numpy())


def save(fname, data):
    """Save an NDArray, a list of them or a ``{name: NDArray}`` dict
    (reference: mx.nd.save) in the V2 container, atomically: a killed
    writer leaves the previous file or the new one, never a truncated
    one.  A sparse array is written as its dense value (stype -1), as the
    JAX package writes it."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data), list(data.values())
    else:
        names, arrays = [], list(data)
    if not all(isinstance(a, NDArray) for a in arrays):
        raise MXNetError("nd.save takes NDArrays")
    with atomic_writer(fname) as f:
        f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        for a in arrays:
            _write_ndarray(f, a)
        f.write(struct.pack("<Q", len(names)))
        for name in names:
            b = name.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def _unpack(f, fmt):
    size = struct.calcsize(fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise MXNetError("truncated NDArray file")
    return struct.unpack(fmt, buf)


# the JAX package reads a blob into nd.array, which narrows the 64-bit
# types; load gives the same dtypes
_LOAD_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _read_ndarray(f, device):
    (magic,) = _unpack(f, "<Q")
    if magic != _NDARRAY_V2_MAGIC:
        raise MXNetError("invalid NDArray file format (magic %x)" % magic)
    _unpack(f, "<i")                                    # stype
    (ndim,) = _unpack(f, "<I")
    shape = _unpack(f, "<%dq" % ndim)
    _unpack(f, "<ii")                                   # context
    dt = dtype_from_id(_unpack(f, "<i")[0])
    nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    host = torch.empty(nbytes, dtype=torch.uint8)
    if nbytes and f.readinto(memoryview(host.numpy())) != nbytes:
        raise MXNetError("truncated NDArray file")
    host = host.view(dt).reshape(shape)
    return NDArray(host.to(device=device, dtype=_LOAD_NARROW.get(dt, dt)))


def _load_stream(f, ctx):
    device = resolve(ctx)
    (magic,) = _unpack(f, "<Q")
    if magic != _LIST_MAGIC:
        raise MXNetError("invalid NDArray container (magic %x)" % magic)
    _, n = _unpack(f, "<QQ")
    arrays = [_read_ndarray(f, device) for _ in range(n)]
    (m,) = _unpack(f, "<Q")
    names = []
    for _ in range(m):
        (ln,) = _unpack(f, "<Q")
        names.append(f.read(ln).decode())
    return dict(zip(names, arrays)) if names else arrays


def load(fname, ctx=None):
    """Load a V2 container (reference: mx.nd.load): a ``{name: NDArray}``
    dict, or a list when the file has no names, on ``ctx`` (default
    the current context).  Each blob is read once into host memory and
    copied to the device once."""
    with open(fname, "rb") as f:
        return _load_stream(f, ctx)


def load_buffer(buf, ctx=None):
    """Load a V2 container from its bytes (the ``param_bytes`` of
    c_predict_api's MXPredCreate), as :func:`load`."""
    return _load_stream(io.BytesIO(buf), ctx)
