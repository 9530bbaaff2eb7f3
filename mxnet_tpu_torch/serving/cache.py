"""LRU executor cache keyed on (model, version, bucket) (counterpart of
``mxnet_tpu/serving/cache.py``).

The bound working set: each entry is an inference-bound ``Predictor``
(``Predictor.from_parts``) at one shape bucket, on the cache's device,
aliasing the registry's parameter tensors across buckets.  A miss is a
bind, so the cache's miss counter is the rebind count the /stats surface
reports; after warmup a healthy server's miss count stays flat.

Eviction (capacity ``MXNET_SERVING_EXECUTOR_CACHE``) only DROPS the
cache's reference: the batcher may still be mid-forward on an evicted
or invalidated executor, so buffers are reclaimed by refcount once any
in-flight batch completes — never freed out from under it.  The shared
params live in the registry entries and are untouched either way.

Multi-tenancy: ``set_quota(name, entries)`` RESERVES executor slots
for one model.  A quota'd model over its own budget evicts its OWN
least-recent entries (a tenant pays for its own churn), and the global
LRU sweep skips entries of quota'd models that are within budget — so
one tenant's bind storm can never evict another tenant's hot
executors (the cross-tenant recompile storm the shared LRU allowed).
Reserved slots are a guarantee, not an allocation: when the sum of
quotas exceeds ``capacity`` the cache is allowed to run over capacity
rather than break a reservation (it warns once — fix the config).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from .. import telemetry
from ..fault import hooks as _fault
from ..predictor import Predictor
from ..telemetry import tracing as _trace

__all__ = ["ExecutorCache"]


class ExecutorCache:
    def __init__(self, capacity=16, on_miss=None, *, ctx=None):
        if capacity < 1:
            raise ValueError("executor cache capacity must be >= 1")
        self._capacity = int(capacity)
        self._ctx = ctx     # the device predictors bind on (None: current)
        self._lock = threading.Lock()
        # (name, version, id(entry), bucket) -> (ModelVersion, Predictor)
        self._entries = OrderedDict()   # guarded-by: _lock
        self.hits = 0                   # guarded-by: _lock
        self.misses = 0                 # guarded-by: _lock
        self.evictions = 0              # guarded-by: _lock
        self._quotas = {}               # guarded-by: _lock — name -> slots
        self._per_model = {}            # guarded-by: _lock — name -> counts
        self._over_capacity_warned = False   # guarded-by: _lock
        # miss hook: the server records every freshly-bound (entry,
        # bucket) key into the warmup manifest, so a restarted replica
        # knows the working set to re-warm.  Called OUTSIDE the lock
        # (it does file I/O) and never allowed to poison the bind.
        self._on_miss = on_miss
        # per-instance ints stay the stats() source of truth; the shared
        # telemetry namespace mirrors them, so one snapshot()/exposition
        # correlates serving rebinds with the executor's first-dispatch
        # counter
        self._t_events = telemetry.counter(
            "mxnet_serving_cache_events_total",
            "executor-cache lookups by outcome (hit/miss/eviction); "
            "miss count IS the serving recompile count")
        # evictions also get a first-class counter: cache pressure
        # (capacity churn → recompile storms) must be visible as its
        # own series, not a label slice someone forgets to query
        self._t_evictions = telemetry.counter(
            "mxnet_serving_cache_evictions_total",
            "bound executors dropped by LRU capacity pressure; a "
            "rising rate means the (model, version, bucket) working "
            "set exceeds MXNET_SERVING_EXECUTOR_CACHE and steady-state "
            "traffic is rebinding")

    @staticmethod
    def _norm_bucket(bucket):
        """Bucket keys are ints (batch rungs) or int tuples (the
        generative prefill grid's (batch, length) cells) — one cache,
        one LRU/quota policy, for both working sets."""
        if isinstance(bucket, (tuple, list)):
            return tuple(int(b) for b in bucket)
        return int(bucket)

    def get(self, entry, bucket, binder=None):
        """The bound predictor for ``entry`` (a ModelVersion) at
        ``bucket`` rows, binding on a miss.

        ``id(entry)`` is part of the key: after an unload +
        re-register under the SAME (name, version), a still-queued
        old-entry request must not repopulate a key that new-entry
        requests would then hit — old weights would serve new traffic
        silently.  The cached value holds the entry itself, so the id
        in a live key can never be recycled onto a different
        ModelVersion by the allocator.

        ``binder`` overrides the miss-path bind (the JAX package's
        generative engine caches its prefill programs keyed on (batch,
        length) grid cells through the same machinery)."""
        # a failed lookup/bind poisons only the batch that
        # needed it (worker_scope delivers to its futures); the batcher
        # and every cached entry keep serving
        bucket = self._norm_bucket(bucket)
        with _trace.span("serving.cache.get", model=entry.name,
                         bucket=str(bucket)) as _sp:
            if _fault.ACTIVE[0]:
                _fault.fire("serving.cache.get", model=entry.name,
                            bucket=bucket)
            key = (entry.name, entry.version, id(entry), bucket)
            with self._lock:
                cached = self._entries.get(key)
                if cached is not None:
                    self.hits += 1
                    self._count_locked(entry.name, "hits")
                    self._t_events.labels(outcome="hit",
                                          model=entry.name).inc()
                    self._entries.move_to_end(key)
                    _sp.tag(outcome="hit")
                    return cached[1]
            # bind OUTSIDE the lock: concurrent lookups of already-
            # cached buckets never wait for it
            if binder is not None:
                pred = binder()
            else:
                pred = Predictor.from_parts(entry.symbol,
                                            entry.arg_params,
                                            entry.aux_params,
                                            entry.full_shapes(bucket),
                                            ctx=self._ctx)
            with self._lock:
                race = self._entries.get(key)
                if race is not None:    # another thread bound it first
                    self.hits += 1
                    self._count_locked(entry.name, "hits")
                    self._t_events.labels(outcome="hit",
                                          model=entry.name).inc()
                    self._entries.move_to_end(key)
                    _sp.tag(outcome="hit")
                    return race[1]
                self.misses += 1
                self._count_locked(entry.name, "misses")
                self._t_events.labels(outcome="miss",
                                      model=entry.name).inc()
                self._entries[key] = (entry, pred)
                self._evict_locked(entry.name)
            _sp.tag(outcome="miss")
        if self._on_miss is not None:
            try:
                self._on_miss(entry, bucket)
            # deliberate swallow: the manifest is a best-effort restart
            # optimization — failing a SUCCESSFUL bind over its I/O
            # would turn a lost warm-start into lost traffic
            except Exception:   # noqa: BLE001
                pass
        return pred

    def set_quota(self, name, entries):
        """Reserve ``entries`` executor slots for model ``name`` (the
        serving ladder's length is the natural value).  ``None`` or
        ``<= 0`` clears the reservation back to shared-LRU behavior."""
        with self._lock:
            if entries is None or int(entries) <= 0:
                self._quotas.pop(name, None)
            else:
                self._quotas[name] = int(entries)
                if sum(self._quotas.values()) > self._capacity and \
                        not self._over_capacity_warned:
                    self._over_capacity_warned = True
                    import logging
                    logging.warning(
                        "executor-cache quotas reserve %d slots but "
                        "capacity is %d; reservations win and the cache "
                        "may run over capacity — raise "
                        "MXNET_SERVING_EXECUTOR_CACHE",
                        sum(self._quotas.values()), self._capacity)

    def quotas(self):
        with self._lock:
            return dict(self._quotas)

    def _count_locked(self, name, outcome, n=1):
        per = self._per_model.setdefault(
            name, {"hits": 0, "misses": 0, "evictions": 0})
        per[outcome] += n

    def _size_locked(self, name):
        return sum(1 for k in self._entries if k[0] == name)

    def _evict_locked(self, inserted_name):
        """Capacity enforcement after inserting a key of
        ``inserted_name``.  Two passes: (1) a quota'd model over its
        OWN budget sheds its own LRU entries; (2) the global sweep
        evicts LRU entries whose model is NOT protected — protected =
        quota'd and within budget.  When every remaining entry is
        protected the cache runs over capacity (reservations win)."""
        quota = self._quotas.get(inserted_name)
        if quota is not None:
            while self._size_locked(inserted_name) > quota:
                victim = next(k for k in self._entries
                              if k[0] == inserted_name)
                self._evict_one_locked(victim)
        while len(self._entries) > self._capacity:
            victim = None
            for k in self._entries:          # LRU order
                q = self._quotas.get(k[0])
                if q is None or self._size_locked(k[0]) > q:
                    victim = k
                    break
            if victim is None:
                break                        # all protected: run over
            self._evict_one_locked(victim)

    def _evict_one_locked(self, key):
        self._entries.pop(key)
        self.evictions += 1
        self._count_locked(key[0], "evictions")
        self._t_events.labels(outcome="eviction", model=key[0]).inc()
        # dual-write: the unlabeled child stays the cross-model total
        # (the pre-multi-tenant series dashboards alert on), the
        # model child is the per-tenant slice
        self._t_evictions.inc()
        self._t_evictions.labels(model=key[0]).inc()

    def invalidate(self, name, version=None):
        """Drop cached executors for a model (hot swap / unload path)."""
        with self._lock:
            doomed = [k for k in self._entries
                      if k[0] == name and (version is None
                                           or k[1] == int(version))]
            for k in doomed:
                self._entries.pop(k)
            return len(doomed)

    def clear(self):
        with self._lock:
            self._entries.clear()

    def stats(self):
        with self._lock:
            per_model = {
                n: dict(c, size=self._size_locked(n),
                        quota=self._quotas.get(n))
                for n, c in sorted(self._per_model.items())}
            return {"hits": self.hits, "misses": self.misses,
                    "recompiles": self.misses, "evictions": self.evictions,
                    "size": len(self._entries),
                    "capacity": self._capacity,
                    "per_model": per_model}
