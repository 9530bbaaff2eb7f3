"""Fault-injection hook surface — the only fault module runtime code
imports (counterpart of ``mxnet_tpu/fault/hooks.py``).

Fault-injection sites live on hot paths (kvstore push/pull, the serving
batcher, io prefetch) and must cost nothing in production: a flat
one-element flag list plus a late-bound callable the plan runtime
rebinds, so the instrumentation idiom at every site is::

    from ..fault import hooks as _fault
    ...
    if _fault.ACTIVE[0]:
        _fault.fire("kvstore.push")

— exactly one boolean check per event while no plan is installed
(``tests/test_torch_fault.py`` holds the fast path).

Nothing here imports the package runtime (no torch, no telemetry, no
config): ``fault.plan`` imports this module and rebinds :func:`fire`
when :func:`mxnet_tpu_torch.fault.install` arms a plan.

``STEP`` is the schedule's training-step address: loops that have a
step notion (``fit``, the elastic runner) publish it via
:func:`set_step` so plan rules can say "fire at step 7" instead of
"fire at the Nth site hit".
"""
from __future__ import annotations

__all__ = ["ACTIVE", "STEP", "fire", "set_step", "current_step"]

# master switch, flipped by fault.plan.install()/uninstall()
ACTIVE = [False]

# the current training step as published by the driving loop; -1 means
# "no step context" (rules addressed by step never match then)
STEP = [-1]


def fire(site, **ctx):            # pragma: no cover - rebound by install()
    """A named injection site was reached.  Default: no-op — a site is
    safe even if ``ACTIVE`` is flipped by hand without ``install()``.
    The installed plan MAY raise, sleep, or signal from here; ``ctx``
    carries site-specific handles (e.g. the open temp file at the
    ``atomic_io.commit`` site, which torn-write faults truncate)."""


def set_step(step):
    """Publish the driving loop's current step for step-addressed rules
    (one int store; called per batch only by opted-in loops)."""
    STEP[0] = int(step)


def current_step():
    return STEP[0]
