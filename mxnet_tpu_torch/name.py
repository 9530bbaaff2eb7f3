"""Automatic naming of symbol nodes (counterpart of ``mxnet_tpu/name.py``):
an unnamed op node is called ``<hint><n>``, counted per hint by the
thread's current manager, so graphs built here carry the same node names
as the JAX package's.  ``with NameManager():`` starts the counts afresh
for the block; ``with Prefix("p_"):`` also puts ``p_`` in front of every
name, given or made."""
from __future__ import annotations

import threading


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @classmethod
    def current(cls):
        if not hasattr(cls._current, "value"):
            cls._current.value = NameManager()
        return cls._current.value


class Prefix(NameManager):
    """Every name the block gives or makes, with ``prefix`` in front
    (reference: python/mxnet/name.py Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name
