"""Autograd: recording, training state and backward through imperative ops.

Counterpart of ``mxnet_tpu/autograd.py`` (reference surface:
python/mxnet/autograd.py record:122, pause:146, train_mode:166,
predict_mode:181, mark_variables:197, backward:243, grad:270,
Function:363).  The JAX package keeps its own tape of ``jax.vjp``
closures; here the tape is PyTorch's autograd graph:

- ``imperative.invoke`` runs every op with torch's grad mode on while a
  scope records and off otherwise, so an op records exactly when the
  reference's tape would (an input that is marked, or the output of a
  recorded op);
- ``mark_variables`` (and ``NDArray.attach_grad``, ``Parameter``) turn an
  array into a variable: its tensor requires grad, and the array keeps a
  grad buffer and a ``grad_req``.  The marked arrays are held weakly in a
  registry, so ``backward`` finds the variables its heads reach without a
  list from the caller;
- ``backward`` runs ``torch.autograd.grad`` over the heads and the marked
  variables and writes each gradient into its buffer (``write``), adds it
  (``add``) or leaves it (``null``); ``grad`` returns new arrays and
  touches no buffer, with ``create_graph`` for higher orders;
- as in the reference, a backward frees the recorded graph unless
  ``retain_graph``, and a second backward through it then raises;
- ``Function`` is a thin layer over ``torch.autograd.Function``;
- ``get_symbol`` raises MXNetError, as in the JAX package: a recorded
  graph is not exported as a Symbol.

``Module.fit`` trains through the executor's own autograd and does not
use this module's backward.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]

_STATE = threading.local()

_MARKED_LOCK = threading.Lock()
# guarded-by: _MARKED_LOCK — marked NDArrays by id (a WeakSet would compare
# them with ==, which is an elementwise op on NDArrays)
_MARKED = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording():
    """Reference: python/mxnet/autograd.py:88."""
    return _st().recording


def is_training():
    """Reference: python/mxnet/autograd.py:98."""
    return _st().training


def set_recording(is_rec):
    """Set the thread's recording flag; returns the previous one."""
    st = _st()
    prev = st.recording
    st.recording = bool(is_rec)
    return prev


def set_training(train_mode):
    """Set the thread's training flag; returns the previous one."""
    st = _st()
    prev = st.training
    st.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Reference: python/mxnet/autograd.py:108."""

    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)

    def __exit__(self, *args):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """A scope that records (and, by default, runs in training mode)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """A scope that does not record (predict mode by default)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    """A scope in training mode, recording unchanged."""
    return _RecordingStateScope(None, True)


def predict_mode():
    """A scope in predict mode, recording unchanged."""
    return _RecordingStateScope(None, False)


def grad_mode():
    """Torch's grad mode as the recording flag says: what every op on an
    array runs under, so it records exactly when a scope records."""
    return torch.set_grad_enabled(is_recording())


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark arrays as variables to take gradients for, with ``gradients``
    as their buffers (reference: python/mxnet/autograd.py:197).  A
    variable's tensor then requires grad; under ``null`` it keeps its
    buffer, which no backward writes (MXNet's kNullOp; the JAX package
    writes the buffer of an ``attach_grad("null")`` all the same)."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, buf, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be one of 'write', 'add' or "
                             "'null', got %r" % (req,))
        if req != "null" and not var._data.is_floating_point():
            raise MXNetError("cannot take gradients for an array of dtype "
                             "%s" % var.dtype)
        var._grad = buf
        var._grad_req = req
        if req != "null" and not var._data.requires_grad:
            var._data.requires_grad_(True)
        with _MARKED_LOCK:
            _MARKED[id(var)] = var


def _heads(heads, head_grads):
    """Heads and their gradients as tensors (ones where none is given);
    raises for a head that no recorded op produced."""
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    outs, seeds = [], []
    for i, h in enumerate(heads):
        if not h._data.requires_grad:
            raise MXNetError("head array is not connected to the recorded "
                             "graph")
        g = head_grads[i] if head_grads is not None else None
        outs.append(h._data)
        seeds.append(torch.ones_like(h._data) if g is None
                     else g._data.to(h._data.dtype))
    return outs, seeds


def _torch_grad(outs, seeds, inputs, retain_graph, create_graph):
    """``torch.autograd.grad`` with None for an input the heads do not
    reach; a graph that an earlier backward freed raises MXNetError."""
    try:
        return torch.autograd.grad(outs, inputs, seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as exc:
        if "second time" not in str(exc):
            raise
        raise MXNetError("the recorded graph was freed by an earlier "
                         "backward; pass retain_graph=True to go through it "
                         "again") from exc


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (with ``head_grads``, ones by default) into
    the grad buffers of the marked variables they reach: written for
    ``write``, added for ``add`` (reference: python/mxnet/autograd.py:243).
    Variables the heads do not reach keep their buffers."""
    outs, seeds = _heads(heads, head_grads)
    with _MARKED_LOCK:
        marked = [v for v in list(_MARKED.values())
                  if v._grad_req != "null" and v._data.requires_grad]
    grads = _torch_grad(outs, seeds, [v._data for v in marked],
                        retain_graph, False)
    for var, g in zip(marked, grads):
        if g is None:
            continue
        buf = var._grad
        if var._grad_req == "add":
            buf._data = buf._data + g
        else:
            buf._data = g.to(buf._data.dtype)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` as new arrays,
    leaving the variables' grad buffers alone (reference:
    python/mxnet/autograd.py:270).  With ``create_graph`` the gradients
    record, so a further ``backward`` or ``grad`` goes through them (and
    ``retain_graph`` defaults to True)."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    var_list = [variables] if single else list(variables)
    for v in var_list:
        if not isinstance(v, NDArray):
            raise MXNetError("variables must be NDArrays")
        if v._grad_req == "null" or not v._data.requires_grad:
            raise MXNetError(
                "cannot differentiate with respect to a variable that is "
                "not marked for gradient; call attach_grad() (or "
                "mark_variables) on it BEFORE the recorded computation")
    if retain_graph is None:
        retain_graph = create_graph
    outs, seeds = _heads(heads, head_grads)
    grads = _torch_grad(outs, seeds, [v._data for v in var_list],
                        retain_graph, create_graph)
    if any(g is None for g in grads):
        raise MXNetError("a requested variable is not reachable from the "
                         "heads in the recorded graph")
    res = [NDArray(g) for g in grads]
    return res[0] if single else res


def get_symbol(x):
    """Reference: autograd.py get_symbol; the recorded graph has no
    Symbol form here, as in the JAX package."""
    raise MXNetError("autograd.get_symbol is not supported; use symbolic "
                     "API")


class Function:
    """A differentiable function with its own backward (reference:
    python/mxnet/autograd.py:363): subclass it with ``forward`` and
    ``backward`` over NDArrays.  Both run paused; under ``record()`` the
    call is one node of torch's graph whose backward calls ``backward``
    with the output gradients."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):  # pragma: no cover - abstract
        raise NotImplementedError

    def backward(self, *out_grads):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        with grad_mode():
            outs = _CustomFunction.apply(self, *[x._data for x in inputs])
        if self._single:
            return NDArray(outs[0])
        return [NDArray(o) for o in outs]


class _CustomFunction(torch.autograd.Function):
    """The torch node of a user ``Function``: forward and backward run
    the user's NDArray code, paused."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        ctx.func = func
        with pause():
            outputs = func.forward(*[NDArray(t) for t in tensors])
        func._single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if func._single else list(outputs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        with pause():
            in_grads = ctx.func.backward(*[NDArray(g) for g in out_grads])
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        return (None,) + tuple(g._data if g is not None else None
                               for g in in_grads)
