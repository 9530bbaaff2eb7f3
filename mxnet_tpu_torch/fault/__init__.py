"""Deterministic fault injection and elastic training (counterpart of
``mxnet_tpu/fault``).

- :mod:`.hooks` — the dependency-free leaf instrumented sites import;
  one boolean per site while no plan is armed;
- :mod:`.plan` — :class:`FaultPlan`: seeded, site/step-addressed fault
  schedules (raise / transient-IO / torn-write / delay / SIGTERM /
  SIGKILL / hard-exit / NaN), armed process-wide via
  ``MXNET_FAULT_PLAN`` or :func:`install`;
- :mod:`.backoff` — :class:`BackoffPolicy`, the shared retry policy;
- :mod:`.elastic` — the supervised training runtime the injection core
  exists to drill: ``fit(elastic=True)``'s restore-and-retry under a
  budgeted backoff (:class:`ElasticSupervisor`),
  :class:`ProcessSupervisor` for whole worker processes, and
  :func:`run_elastic`, the data-parallel trainer's loop that resumes on
  another mesh width.

The JAX package's chaos drills (``fault/drill.py``) come later.

``elastic`` imports the checkpoint stack, so it loads lazily: the
package itself stays importable from ``_atomic_io`` (which loads before
everything), and nothing it imports eagerly imports torch.
"""
from __future__ import annotations

from . import hooks  # noqa: F401
from .backoff import BackoffPolicy  # noqa: F401
from .plan import (FaultInjected, FaultPlan, Reorder,  # noqa: F401
                   active_plan, install, installed, uninstall)

__all__ = ["hooks", "BackoffPolicy", "FaultPlan", "FaultInjected",
           "Reorder", "install", "uninstall", "installed", "active_plan",
           "elastic", "ElasticError", "ElasticSupervisor",
           "ProcessSupervisor", "run_elastic"]

_LAZY = ("elastic", "ElasticError", "ElasticSupervisor",
         "ProcessSupervisor", "run_elastic")


def __getattr__(name):
    if name in _LAZY:
        # import_module, NOT ``from . import elastic``: the from-import
        # probes this package's attribute first, which re-enters this
        # __getattr__ before the submodule binds
        import importlib
        elastic = importlib.import_module(__name__ + ".elastic")
        if name == "elastic":
            return elastic
        return getattr(elastic, name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
