"""Random number state.

Counterpart of ``mxnet_tpu/random.py`` (reference: python/mxnet/random.py
``mx.random.seed``).  The JAX package keeps a host-side (seed, counter)
chain of threefry keys; here each device has one explicit
``torch.Generator``, created on first use and seeded from the package
seed.  The initializers and ``NDArrayIter(shuffle=True)`` draw from the
generator of the device they fill; nothing reads PyTorch's global RNG
state.  The two packages give different numbers from the same seed:
tests hand both the same numpy inputs.

``get_state``/``set_state`` snapshot and restore the package seed and
every generator's state (the CPU's and each card's, as torch keeps them),
so the draws after ``set_state`` equal the uninterrupted run's, the JAX
package's contract (``mxnet_tpu/random.py`` get_state); the content is
torch's generator state, not the JAX package's (seed, count) pair.
"""
from __future__ import annotations

import threading

import torch

from .context import Context, resolve

__all__ = ["seed", "generator", "get_state", "set_state"]

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


def get_state():
    """The package seed and each device's generator state: ``{"seed":
    int, "generators": {device string: uint8 CPU tensor}}``."""
    with _LOCK:
        return {"seed": int(_SEED[0]),
                "generators": {str(d): g.get_state()
                               for d, g in _GENS.items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot: each device's next draws are
    the ones it gave after the snapshot.  A generator created since the
    snapshot starts again from the seed."""
    with _LOCK:
        _SEED[0] = int(state["seed"])
        saved = state["generators"]
        for d in set(_GENS) | {torch.device(k) for k in saved}:
            g = _generator_locked(d)
            if str(d) in saved:
                g.set_state(saved[str(d)].clone())
            else:
                g.manual_seed(_SEED[0])
