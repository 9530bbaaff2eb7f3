"""Random number state.

Counterpart of ``mxnet_tpu/random.py`` (reference: python/mxnet/random.py
``mx.random.seed``).  The JAX package keeps a host-side (seed, counter)
chain of threefry keys; here each device has one explicit
``torch.Generator``, created on first use and seeded from the package
seed.  The initializers and ``NDArrayIter(shuffle=True)`` draw from the
generator of the device they fill; nothing reads PyTorch's global RNG
state.  The two packages give different numbers from the same seed:
tests hand both the same numpy inputs.
"""
from __future__ import annotations

import threading

import torch

from .context import Context, resolve

__all__ = ["seed", "generator"]

_LOCK = threading.Lock()
_SEED = [0]            # guarded-by: _LOCK
_GENS = {}             # guarded-by: _LOCK — torch.device -> torch.Generator


def seed(seed_state=0, ctx="all"):
    """Seed the generator of ``ctx`` (a Context or torch.device), or with
    ``ctx="all"`` of every device, present and future (reference:
    python/mxnet/random.py:28)."""
    with _LOCK:
        if isinstance(ctx, str) and ctx == "all":
            _SEED[0] = int(seed_state)
            for g in _GENS.values():
                g.manual_seed(_SEED[0])
            return
        device = resolve(ctx if isinstance(ctx, (Context, torch.device))
                         else Context(ctx))
        _generator_locked(device).manual_seed(int(seed_state))


def _generator_locked(device):
    g = _GENS.get(device)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(_SEED[0])
        _GENS[device] = g
    return g


def generator(device):
    """The ``torch.Generator`` of ``device`` (a torch.device, Context or
    device string)."""
    if not isinstance(device, torch.device):
        device = resolve(device) if isinstance(device, Context) \
            else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        return _generator_locked(device)
