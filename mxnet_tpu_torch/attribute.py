"""Attribute scoping (counterpart of ``mxnet_tpu/attribute.py``;
reference: python/mxnet/attribute.py AttrScope): ``with
AttrScope(ctx_group="stage1"):`` gives every symbol node built in the
block those string attrs, nested scopes merging outward in."""
from __future__ import annotations

import threading


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be strings")
        self._attr = kwargs

    def get(self, attr):
        """The scope's attrs updated with ``attr``."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        self._old_scope = AttrScope._current.value
        attr = AttrScope._current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @classmethod
    def current(cls):
        if not hasattr(cls._current, "value"):
            cls._current.value = AttrScope()
        return cls._current.value
