"""Range constraint overlay (counterpart of ``mxnet_tpu/ops/constraints.py``).

The bounds the reference declares with ``DMLC_DECLARE_FIELD(...)
.set_range/set_lower_bound`` (dmlc-core parameter.h), in one table keyed
op -> param, overlaid on the registry's parameter tables once every op
module has registered (``install()``, called from ``ops/__init__.py``).
An out-of-range value then raises the same ``MXNetError`` here as in the
JAX package.  The table is the JAX package's, without the entries of ops
this package has not ported yet (ROIPooling, the PSROI and deformable
ops, Correlation: ROADMAP.md queue 7).

Application rules (``apply()``), as in the JAX package:

- a hand-declared bound wins: the overlay only fills in missing
  ``low``/``high``/types;
- a signature-derived (``derived``) param gains the type the bound
  implies, so the bound is enforced;
- ``dtype`` fields stay untyped.

As in the JAX package, ``lr``, ``eps`` and ``epsilon`` are floored at 0
(stricter than the reference, which leaves them unbounded).
"""
from __future__ import annotations

# op -> param -> {low, high: inclusive bounds (per element for tuples);
# type: the python type a derived or untyped param takes}
CONSTRAINTS = {
    # src/operator/nn/convolution-inl.h:78,82 (workspace 0..8192 MB)
    "Convolution": {"workspace": dict(type=int, low=0, high=8192)},
    # src/operator/nn/deconvolution-inl.h:88,92
    "Deconvolution": {"num_filter": dict(high=100000),
                      "workspace": dict(type=int, low=0, high=8192)},
    # src/operator/nn/upsampling-inl.h:59,75,80
    "UpSampling": {"scale": dict(high=1000),
                   "num_args": dict(low=1),
                   "workspace": dict(type=int, low=0, high=8192)},
    # src/operator/nn/concat-inl.h:53
    "Concat": {"num_args": dict(low=1)},
    # src/operator/contrib/bilinear_resize-inl.h:54,56
    "_contrib_BilinearResize2D": {"height": dict(type=int, low=1, high=1000),
                                  "width": dict(type=int, low=1, high=1000)},
    # src/operator/optimizer_op-inl.h:746-753 (AdamParam)
    "adam_update": {"beta1": dict(low=0.0, high=1.0),
                    "beta2": dict(low=0.0, high=1.0)},
    # src/operator/optimizer_op-inl.h:661-667 (FTMLParam)
    "ftml_update": {"beta1": dict(low=0.0, high=1.0),
                    "beta2": dict(low=0.0, high=1.0)},
    # src/operator/identity_attach_KL_sparse_reg-inl.h:53,58
    "IdentityAttachKLSparseReg": {
        "sparseness_target": dict(low=0.0, high=1.0),
        "momentum": dict(low=0.0, high=1.0)},
    # src/operator/tensor/indexing_op.h:640 (take axis lower bound 0)
    "take": {"axis": dict(low=0)},
    # src/operator/tensor/broadcast_reduce_op.h:72,981 (norm: only L1/L2)
    "norm": {"ord": dict(low=1, high=2)},
    # src/operator/sequence_mask-inl.h:63 ("Only values of 0 and 1 are
    # currently supported."); same contract in sequence_last/reverse
    "SequenceMask": {"axis": dict(low=0, high=1)},
    "SequenceLast": {"axis": dict(low=0, high=1)},
    "SequenceReverse": {"axis": dict(low=0, high=1)},
    # src/operator/slice_channel-inl.h (num_outputs lower bound 1)
    "SliceChannel": {"num_outputs": dict(low=1)},
}

# bounds that hold for every op with a param of this name (window
# geometry, stabilisers, count-like fields the reference lower-bounds
# at 1).  `shape`, `axis`, `begin`, `end`, `step`, `clip_gradient`, `wd`,
# `rescale_grad` and `momentum` are deliberately absent.
NAME_DEFAULTS = {
    "eps": dict(low=0.0),
    "epsilon": dict(low=0.0),
    "lr": dict(low=0.0),
    "kernel": dict(low=1),
    "stride": dict(low=1),
    "dilate": dict(low=1),
    "pad": dict(low=0),
    "num_filter": dict(low=1),
    "num_hidden": dict(low=1),
    "num_layers": dict(low=1),
    "num_group": dict(low=1),
    "state_size": dict(low=1),
    "input_dim": dict(low=1),
    "output_dim": dict(low=1),
    "depth": dict(low=1),
    "pooled_size": dict(low=1),
    "block_size": dict(low=1),
}


def _apply_one(param, c):
    """Overlay one constraint dict onto a Param (hand-declared wins)."""
    changed = False
    want_type = c.get("type")
    if want_type is not None and (param.ptype is None or param.derived):
        param.ptype = want_type
        changed = True
    if param.ptype is None and ("low" in c or "high" in c):
        # an untyped param cannot be range-checked; the bound's type wins
        param.ptype = float if isinstance(
            c.get("low", c.get("high")), float) else int
        changed = True
    if param.low is None and "low" in c:
        param.low = c["low"]
        changed = True
    if param.high is None and "high" in c:
        param.high = c["high"]
        changed = True
    if changed:
        param.derived = False
    return changed


def apply():
    """Overlay CONSTRAINTS and NAME_DEFAULTS onto the registry; returns
    the (op, param) entries that found no op or param (none in a sound
    build)."""
    from .registry import _OP_REGISTRY

    unapplied = []
    for opname, fields in CONSTRAINTS.items():
        op = _OP_REGISTRY.get(opname)
        if op is None:
            unapplied.extend((opname, p) for p in fields)
            continue
        for pname, c in fields.items():
            p = op.params.get(pname)
            if p is None:
                unapplied.append((opname, pname))
                continue
            _apply_one(p, c)
    for op in {id(o): o for o in _OP_REGISTRY.values()}.values():
        for pname, c in NAME_DEFAULTS.items():
            p = op.params.get(pname)
            if p is not None and p.ptype in (int, float, tuple, None):
                _apply_one(p, c)
    return unapplied


UNAPPLIED = ()


def install():
    global UNAPPLIED
    UNAPPLIED = tuple(apply())
