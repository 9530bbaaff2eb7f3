"""Preemption-safe, async, integrity-checked training checkpoints
(counterpart of ``mxnet_tpu/checkpoint``).

Three guarantees, as in the JAX package:

1. **Atomicity** — per-array shards + a sha256 manifest written to a
   hidden temp dir, committed by ONE directory rename
   (:mod:`~mxnet_tpu_torch.checkpoint.store`).  A crash at any instant
   leaves the previous complete checkpoint reachable and the partial
   write invisible.  The layout is the JAX package's, so a checkpoint
   moves between the two packages both ways.
2. **Full-state resume** — :class:`TrainState` snapshots params, aux
   states, optimizer slots (the fused step's too) + schedule position,
   the RNG state, and the data-iterator cursor, so a SIGTERM'd job
   resumes bit-identically (:mod:`~mxnet_tpu_torch.checkpoint.state`).
3. **Off-the-step-path saves** — :class:`AsyncCheckpointer` stages
   device arrays to host, then serializes on a background worker under
   ``engine.worker_scope`` with at-most-one save in flight.

:class:`CheckpointManager` is the user-facing handle (step ids,
retention, restore fallback, SIGTERM hook); ``BaseModule.fit`` builds
one from the ``MXNET_CKPT_*`` knobs when ``MXNET_CKPT_DIR`` is set, and
``serving.ModelRegistry.watch_checkpoints`` hot-swaps committed
checkpoints into the serving layer.  :class:`ParallelTrainerState` is
the data-parallel trainer's mesh-independent snapshot, and
:func:`check_restore_compat` (``compat``) vets a (checkpoint, new
topology) pair before a restore.
"""
from __future__ import annotations

from .async_ckpt import AsyncCheckpointer, write_checkpoint  # noqa: F401
from .compat import check_restore_compat, state_plan_spec  # noqa: F401
from .manager import (CheckpointManager, default_manager,  # noqa: F401
                      sigterm_flag_scope)
from .state import (ParallelTrainerState, TrainState,  # noqa: F401
                    capture_iter_state, restore_iter_state)
from .store import (CheckpointError, CheckpointStore,  # noqa: F401
                    IntegrityError, RetentionPolicy)

__all__ = ["AsyncCheckpointer", "CheckpointError", "CheckpointManager",
           "ParallelTrainerState",
           "CheckpointStore", "IntegrityError", "RetentionPolicy",
           "TrainState", "capture_iter_state", "check_restore_compat",
           "default_manager", "restore_iter_state", "sigterm_flag_scope",
           "state_plan_spec", "write_checkpoint"]
