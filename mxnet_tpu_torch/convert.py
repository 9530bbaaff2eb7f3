"""Carry parameters across from the JAX package.

Both packages use the same names and layouts — OIHW convolution
weights, ``(num_hidden, in)`` FullyConnected and Dense weights,
per-channel BatchNorm and LayerNorm vectors, a ``FusedRNNCell``'s packed
``RNN`` parameter vector (all weights, then all biases) — so moving a
model is a matter of dtype and device placement: ``params_from_numpy`` for a
symbol's arg and aux dicts, ``block_params_from_numpy`` for a gluon
block, ``spec_from_numpy`` for a ``TransformerLM.generative_spec()``
export (generative serving's weight feed).  The caller hands numpy arrays (``{k: v.asnumpy()}`` on the JAX
side); this module never sees a JAX object.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, dtype_torch
from .context import resolve
from .ndarray import NDArray

__all__ = ["params_from_numpy", "block_params_from_numpy",
           "spec_from_numpy"]


def _to_nd(name, v, device, dtype):
    a = np.asarray(v)
    if a.dtype.kind != "f":
        raise MXNetError("parameter %r is %s; parameters are floating point"
                         % (name, a.dtype))
    return NDArray(torch.from_numpy(np.require(a, requirements=("C", "W"))).to(
        device=device, dtype=dtype))


def params_from_numpy(arg_params, aux_params, ctx=None, symbol=None,
                      dtype="float32"):
    """``{name: np.ndarray}`` dicts -> the port's ``{name: NDArray}``
    dicts on ``ctx`` (default the current context), in ``dtype``.

    With ``symbol``, every argument the symbol needs — all but its data
    inputs and its label, those ending in ``data`` or ``label`` — and
    every aux state must be present, or MXNetError names the missing
    ones."""
    device, dt = resolve(ctx), dtype_torch(dtype)
    args = {k: _to_nd(k, v, device, dt) for k, v in (arg_params or {}).items()}
    auxs = {k: _to_nd(k, v, device, dt) for k, v in (aux_params or {}).items()}
    if symbol is not None:
        need = [n for n in symbol.list_arguments()
                if not n.endswith(("data", "label"))]
        missing = [n for n in need if n not in args] + \
            [n for n in symbol.list_auxiliary_states() if n not in auxs]
        if missing:
            raise MXNetError("parameters missing for the symbol: %s"
                             % missing)
    return args, auxs


def _root_prefix(names):
    """The root block's prefix of gluon parameter names: everything up to
    and including the first ``_`` (a root block is named
    ``<alias><count>_``), which every name must share."""
    names = list(names)
    if not names:
        return ""
    head = names[0].split("_", 1)[0] + "_"
    if not all(n.startswith(head) for n in names):
        raise MXNetError("parameter names do not share one root prefix "
                         "(%r in %r)" % (head, names[:4]))
    return head


def block_params_from_numpy(block, arrays, ctx=None):
    """Set every parameter of gluon ``block`` from ``arrays``, ``{name:
    np.ndarray}`` as the JAX block's ``collect_params()`` names them, on
    ``ctx`` (default the current context) in each parameter's dtype.

    Names match with each side's root prefix stripped (``transformerlm0_``
    here may be ``transformerlm3_`` there: the count is per process), so
    the two blocks must have been built alike.  A parameter missing from
    ``arrays``, a name in ``arrays`` the block lacks, or a shape that
    disagrees with a known dim raises MXNetError naming them; deferred
    parameters take their shape from the array."""
    ours = {n[len(block.prefix):]: p
            for n, p in block.collect_params().items()}
    theirs_prefix = _root_prefix(arrays)
    theirs = {n[len(theirs_prefix):]: a for n, a in arrays.items()}
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise MXNetError("block_params_from_numpy: parameters missing from "
                         "the arrays: %s; arrays the block lacks: %s"
                         % (missing, extra))
    device = resolve(ctx)
    for name, p in ours.items():
        a = np.asarray(theirs[name])
        known = p.shape
        if known is not None and (len(known) != a.ndim or any(
                k not in (0, s) for k, s in zip(known, a.shape))):
            raise MXNetError("block_params_from_numpy: %s is %s in the "
                             "block, %s in the arrays"
                             % (name, known, a.shape))
        p._load_init(_to_nd(name, a, device, dtype_torch(p.dtype)))


def spec_from_numpy(spec, ctx=None, dtype="float32"):
    """A ``generative_spec()`` export whose leaves are host arrays (the
    JAX package's, ``np.asarray`` of each leaf) -> the port's spec: the
    same ``config`` and the same nested ``params`` layout, every leaf a
    tensor on ``ctx`` (default the current context) in ``dtype``."""
    device, dt = resolve(ctx), dtype_torch(dtype)

    def carry(tree, path):
        if isinstance(tree, dict):
            return {k: carry(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [carry(v, path + (str(i),)) for i, v in enumerate(tree)]
        return _to_nd("/".join(path), tree, device, dt)._data

    return {"config": dict(spec["config"]),
            "params": carry(spec["params"], ())}
