"""Deterministic fault injection (counterpart of ``mxnet_tpu/fault``).

Three layers, two of them ported:

- :mod:`.hooks` — the dependency-free leaf instrumented sites import;
  one boolean per site while no plan is armed;
- :mod:`.plan` — :class:`FaultPlan`: seeded, site/step-addressed fault
  schedules (raise / transient-IO / torn-write / delay / SIGTERM /
  SIGKILL / hard-exit / NaN), armed process-wide via
  ``MXNET_FAULT_PLAN`` or :func:`install`;
- :mod:`.backoff` — :class:`BackoffPolicy`, the shared retry policy.

The JAX package's supervised training runtime (``fault/elastic.py``,
``fit(elastic=True)``) and its chaos drills (``fault/drill.py``) are not
ported yet; ``fit(elastic=True)`` raises naming them.

The package stays importable from ``_atomic_io`` (which loads before
everything): nothing here imports torch.
"""
from __future__ import annotations

from . import hooks  # noqa: F401
from .backoff import BackoffPolicy  # noqa: F401
from .plan import (FaultInjected, FaultPlan, Reorder,  # noqa: F401
                   active_plan, install, installed, uninstall)

__all__ = ["hooks", "BackoffPolicy", "FaultPlan", "FaultInjected",
           "Reorder", "install", "uninstall", "installed", "active_plan"]
