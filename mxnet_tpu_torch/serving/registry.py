"""Model registry — named, versioned checkpoints (counterpart of
``mxnet_tpu/serving/registry.py``).

A registered version holds the symbol, the parameter NDArrays and the
per-input SAMPLE shapes (the declared shapes minus the batch axis); the
batch axis belongs to the serving layer's shape buckets.  The registry
never binds: the executor cache does.  ``load`` reads a checkpoint's
files (or their contents) as ``Predictor`` does.  Checkpoint watching
comes with the ``checkpoint/`` package.
"""
from __future__ import annotations

import threading

from .errors import BadRequest, ModelNotFound

__all__ = ["ModelVersion", "ModelRegistry"]


class ModelVersion:
    """One immutable loaded checkpoint: symbol, params, input signature."""

    __slots__ = ("name", "version", "symbol", "arg_params", "aux_params",
                 "sample_shapes", "input_names", "num_outputs")

    def __init__(self, name, version, symbol, arg_params, aux_params,
                 input_shapes):
        self.name = name
        self.version = int(version)
        self.symbol = symbol
        self.arg_params = dict(arg_params or {})
        self.aux_params = dict(aux_params or {})
        if not input_shapes:
            raise BadRequest("model %r needs at least one declared input"
                             % (name,))
        self.sample_shapes = {}
        for k, shp in input_shapes.items():
            shp = tuple(int(d) for d in shp)
            if len(shp) < 1:
                raise BadRequest("input %r of model %r needs a batch axis; "
                                 "got shape %r" % (k, name, shp))
            self.sample_shapes[k] = shp[1:]
        self.input_names = list(self.sample_shapes)
        self.num_outputs = len(symbol.list_outputs())

    def full_shapes(self, batch):
        """Declared input shapes with the batch axis set to ``batch``."""
        return {k: (int(batch),) + s for k, s in self.sample_shapes.items()}


class ModelRegistry:
    """Thread-safe name -> {version -> ModelVersion} store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models = {}      # guarded-by: _lock — name -> {version: entry}
        self._default = {}     # guarded-by: _lock — name -> version

    def load(self, name, symbol_file, param_file, input_shapes,
             version=None, ctx=None):
        """Register a checkpoint from its files or their contents (the
        ``Predictor`` contract), the parameters on ``ctx`` (default
        the current context); returns the version."""
        from ..predictor import _load_params, _load_symbol
        sym = _load_symbol(symbol_file)
        arg_params, aux_params = _load_params(param_file, ctx)
        return self.add(name, sym, arg_params, aux_params, input_shapes,
                        version=version)

    def add(self, name, symbol, arg_params, aux_params, input_shapes,
            version=None):
        """Register a loaded symbol and params; returns the version
        (auto-incremented when not given).  The first version of a name
        becomes its default."""
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version is None:
                version = max(versions) + 1 if versions else 1
            version = int(version)
            if version in versions:
                raise BadRequest("model %r version %d already registered"
                                 % (name, version))
            versions[version] = ModelVersion(
                name, version, symbol, arg_params, aux_params, input_shapes)
            self._default.setdefault(name, version)
            return version

    def get(self, name, version=None):
        """Resolve (name, version) -> ModelVersion; None means the
        default version.  Raises ModelNotFound."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound("model %r is not registered" % (name,))
            if version is None:
                version = self._default[name]
            entry = versions.get(int(version))
            if entry is None:
                raise ModelNotFound("model %r version %r is not registered"
                                    % (name, version))
            return entry

    def describe(self):
        """name -> {"versions", "default"} for the stats surface."""
        with self._lock:
            return {name: {"versions": sorted(vs),
                           "default": self._default[name]}
                    for name, vs in self._models.items()}
