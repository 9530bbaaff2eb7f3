"""Autograd recording and training state.

Counterpart of ``mxnet_tpu/autograd.py`` (reference surface:
python/mxnet/autograd.py record:122, pause:146, train_mode:166,
predict_mode:181).  This package carries the thread-local state the
imperative path reads: whether a scope records, and whether ops run in
training mode (``Dropout``, and BatchNorm's batch statistics) or in
predict mode, which is the default outside ``record()``.

Recording for a backward pass through imperative ops is not ported yet
(ROADMAP queue 1, the transformer training slice): ``backward`` and
``grad`` raise, and so does any op invoked while a scope records
(``imperative.invoke``), so a forward under ``record()`` never pretends
to have recorded.  ``Module.fit`` trains through the
executor's own autograd and does not use this module.
"""
from __future__ import annotations

import threading

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "backward",
           "grad", "NOT_PORTED"]

NOT_PORTED = ("autograd backward through imperative ops is not ported yet "
              "(ROADMAP.md queue 1: the transformer training slice)")

_STATE = threading.local()


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


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Not ported yet: raises MXNetError."""
    raise MXNetError(NOT_PORTED)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Not ported yet: raises MXNetError."""
    raise MXNetError(NOT_PORTED)
