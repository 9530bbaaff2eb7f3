"""Executor-manager helpers, the legacy module surface.

Counterpart of ``mxnet_tpu/executor_manager.py`` (reference:
``python/mxnet/executor_manager.py``): ``_split_input_slice``,
``_load_data`` and ``_load_label``, which older user code imports
directly; the executor group of ``module/executor_group.py`` is their
home.
"""
from .module.executor_group import (  # noqa: F401
    _load_general,
    _split_input_slice,
)

__all__ = ["_split_input_slice", "_load_data", "_load_label",
           "_load_general"]


def _load_data(batch, targets):
    """Scatter a DataBatch's data into per-device buffers
    (reference: executor_manager.py:81)."""
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    """Scatter a DataBatch's labels (reference: executor_manager.py:86)."""
    _load_general(batch.label, targets)
