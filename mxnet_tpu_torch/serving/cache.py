"""LRU executor cache keyed on (model, version, bucket) (counterpart of
``mxnet_tpu/serving/cache.py``).

Each entry is an inference-bound ``Predictor`` at one shape bucket,
aliasing the registry's parameter tensors.  A miss is a bind.  Eviction
only drops the cache's reference: a batch still running on an evicted
predictor keeps it alive until it completes.  Per-model quotas and the
warmup manifest's miss hook (``on_miss``) come with the multi-tenant
slice.

The per-instance counts back ``stats()``; the telemetry registry mirrors
them in ``mxnet_serving_cache_events_total{outcome,model}`` and
``mxnet_serving_cache_evictions_total``, and each lookup is a
``serving.cache.get`` span while tracing is on.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from .. import telemetry
from ..predictor import Predictor
from ..telemetry import tracing as _trace

__all__ = ["ExecutorCache"]


class ExecutorCache:
    def __init__(self, capacity=16, ctx=None):
        if capacity < 1:
            raise ValueError("executor cache capacity must be >= 1")
        self._capacity = int(capacity)
        self._ctx = ctx
        self._lock = threading.Lock()
        self._entries = OrderedDict()   # guarded-by: _lock
        self.hits = 0                   # guarded-by: _lock
        self.misses = 0                 # guarded-by: _lock
        self.evictions = 0              # guarded-by: _lock
        self._t_events = telemetry.counter(
            "mxnet_serving_cache_events_total",
            "executor-cache lookups by outcome (hit/miss/eviction); "
            "miss count IS the serving recompile count")
        self._t_evictions = telemetry.counter(
            "mxnet_serving_cache_evictions_total",
            "bound executors dropped by LRU capacity pressure; a "
            "rising rate means the (model, version, bucket) working "
            "set exceeds MXNET_SERVING_EXECUTOR_CACHE and steady-state "
            "traffic is rebinding")

    def get(self, entry, bucket):
        """The bound predictor for ``entry`` (a ModelVersion) at
        ``bucket`` rows, binding on a miss.  ``id(entry)`` is part of the
        key, so a re-registered (name, version) never serves from the
        old entry's predictor."""
        key = (entry.name, entry.version, id(entry), int(bucket))
        with _trace.span("serving.cache.get", model=entry.name,
                         bucket=str(int(bucket))) as sp:
            with self._lock:
                cached = self._entries.get(key)
                if cached is not None:
                    self._hit_locked(entry, key)
                    sp.tag(outcome="hit")
                    return cached[1]
            # bind outside the lock: lookups of cached buckets never wait
            pred = Predictor.from_parts(entry.symbol, entry.arg_params,
                                        entry.aux_params,
                                        entry.full_shapes(bucket),
                                        ctx=self._ctx)
            with self._lock:
                race = self._entries.get(key)
                if race is not None:      # another thread bound it first
                    self._hit_locked(entry, key)
                    sp.tag(outcome="hit")
                    return race[1]
                self.misses += 1
                self._t_events.labels(outcome="miss",
                                      model=entry.name).inc()
                self._entries[key] = (entry, pred)
                while len(self._entries) > self._capacity:
                    (gone, _v, _i, _b), _ = self._entries.popitem(last=False)
                    self.evictions += 1
                    self._t_events.labels(outcome="eviction",
                                          model=gone).inc()
                    self._t_evictions.inc()
                    self._t_evictions.labels(model=gone).inc()
            sp.tag(outcome="miss")
        return pred

    def _hit_locked(self, entry, key):
        self.hits += 1
        self._t_events.labels(outcome="hit", model=entry.name).inc()
        self._entries.move_to_end(key)

    def stats(self):
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._entries),
                    "capacity": self._capacity}
