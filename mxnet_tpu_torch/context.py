"""Device context.

Counterpart of ``mxnet_tpu/context.py``: a ``Context`` names a device and
maps to a ``torch.device``.  ``gpu(i)`` is ``cuda:i``; ``tpu(i)`` is an
alias of ``gpu(i)`` so scripts written for the JAX package run; ``cpu()``
is the host.

The default context is thread-local, as in the reference: ``with
cpu(0): ...`` makes ``cpu(0)`` the default of the block's thread, and the
block's end restores the one before.  Outside any block the default is
the accelerator, ``gpu(0)``; ``resolve(None)`` reads the default, and a
GPU context on a machine without CUDA raises instead of carrying on
quietly on the CPU.  Callers that want the CPU say ``ctx=cpu()`` or open
a ``with cpu():`` block.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_gpus",
           "num_tpus", "resolve"]


class Context:
    """Device context (reference: python/mxnet/context.py:23)."""

    devtype2id = {"cpu": 1, "gpu": 2}
    devid2type = {1: "cpu", 2: "gpu"}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type == "tpu":
            device_type = "gpu"
        if device_type not in self.devtype2id:
            raise MXNetError("unknown device type %s" % device_type)
        self.device_typeid = self.devtype2id[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devid2type[self.device_typeid]

    @property
    def torch_device(self):
        """The ``torch.device`` this context names; raises for a GPU
        context when CUDA is absent or the index is out of range."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s needs an NVIDIA GPU, but CUDA is not available "
                "on this machine; pass ctx=cpu() to run on the CPU" % self)
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError("context %s: GPU index out of range (%d GPUs)"
                             % (self, n))
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = Context.default_ctx()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @classmethod
    def default_ctx(cls):
        """This thread's default context: the innermost ``with`` block's,
        else ``gpu(0)``."""
        if not hasattr(cls._default_ctx, "value"):
            cls._default_ctx.value = Context("gpu", 0)
        return cls._default_ctx.value


def cpu(device_id=0):
    """Host context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`, so scripts written for the JAX package run."""
    return gpu(device_id)


def current_context():
    """The default context of this thread (reference:
    python/mxnet/context.py:216)."""
    return Context.default_ctx()


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus():
    """The JAX package's name for the accelerator count: the GPUs here."""
    return num_gpus()


def resolve(ctx):
    """``ctx`` (a Context, a ``torch.device`` or None) -> ``torch.device``.
    None means :func:`current_context`."""
    if isinstance(ctx, torch.device):
        return Context(ctx.type.replace("cuda", "gpu"),
                       ctx.index or 0).torch_device
    return Context(ctx if ctx is not None
                   else current_context()).torch_device
