"""Reshard-on-restore compatibility — checked BEFORE binding anything.

Counterpart of ``mxnet_tpu/checkpoint/compat.py``.  ``ParallelTrainerState``
payloads are mesh-independent, so a restore may land on another mesh
width, ZeRO stage or bucket plan; what it may not survive is a logical
mismatch: missing or reshaped parameters, another optimizer's slots.
``ParallelTrainer.load_state_dict`` rejects those at restore time; this
gives the same verdict statically, from a snapshot and a target trainer's
plan, so an elastic controller can vet a (checkpoint, new topology) pair
before it tears anything down.  The comparison is ``_plan.reshard_compat``,
the port's copy of the JAX package's.
"""
from __future__ import annotations

from ._plan import MeshSpec, PlanSpec, reshard_compat

__all__ = ["state_plan_spec", "check_restore_compat"]


def state_plan_spec(state, name="checkpoint"):
    """A plan view of a :class:`~.state.ParallelTrainerState` (or its
    ``as_state_dict()`` dict): parameter names and shapes, slot
    vocabulary, codec and ZeRO metadata."""
    if hasattr(state, "as_state_dict"):
        state = state.as_state_dict()
    meta = dict(state.get("meta", {}))
    params = [{"name": n, "shape": [int(s) for s in v.shape],
               "dtype_size": int(getattr(v, "itemsize", None)
                                 or v.dtype.itemsize),
               "trainable": True, "spec": None}
              for n, v in sorted(state.get("params", {}).items())]
    slots = sorted(state.get("slots", {}).keys())
    scalars = [[n, 4] for n in sorted(state.get("scalars", {}))]
    codec = meta.get("codec")
    return PlanSpec(
        name=name, kind="trainer",
        origin="mxnet_tpu_torch/checkpoint/state.py",
        mesh=MeshSpec([("dp", 1)]),     # the payload is mesh-independent
        params=params, zero=int(meta.get("zero", 0)),
        optimizer={"slots": slots, "scalar_slots": scalars},
        codec={"name": codec} if codec else None)


def check_restore_compat(state, trainer, name="checkpoint"):
    """Static verdict for restoring ``state`` into ``trainer``:
    ``{"compatible": bool, "problems": [...], "notes": [...]}``.
    ``problems`` mirrors what ``load_state_dict`` would raise; ``notes``
    records the legal reshard (mesh width, zero stage, dropped
    residuals)."""
    saved = state_plan_spec(state, name=name)
    target = PlanSpec.from_trainer(trainer, name="restore-target")
    return reshard_compat(saved, target)
