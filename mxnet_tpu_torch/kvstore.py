"""KVStore — key-value store for parameter synchronisation.

Counterpart of ``mxnet_tpu/kvstore.py:119-425`` (reference:
python/mxnet/kvstore.py, src/kvstore/) for one process on one device:

- ``local`` / ``device``: ``push`` reduces the pushed values and applies
  the updater (``set_optimizer``) to the stored weight, or adds to it;
  ``pull`` hands the stored tensor out (an alias, as the JAX package).
- ``tpu`` (``KVStoreTPU``): ``push`` only buffers the gradient and the
  next ``pull`` applies every buffered key at once through the
  optimizer's per-array update (``optimizer.fused_update_kernel``), with
  the same arithmetic as the per-key path, its slots kept as the
  ``Updater``'s states.  Under ``Module`` on one device this store is
  what asks for the executor's fused step, where the update runs inside
  ``forward(is_train=True)`` and the store is bypassed.

``save_optimizer_states``/``load_optimizer_states`` write and read the
updater's pickled states, atomically.

The multi-process stores (``dist_*``) come with the multi-GPU slice.

Telemetry as in the JAX package: a completed user-visible ``push`` or
``pull`` counts in ``mxnet_kvstore_ops_total{op}``, its payload bytes in
``mxnet_kvstore_bytes_total{op}`` and its wall time in
``mxnet_kvstore_op_seconds{op}``, while telemetry is on.  Under an armed
fault plan each user-visible call is the ``kvstore.push`` or
``kvstore.pull`` site, inside a span of the same name.
"""
from __future__ import annotations

import functools
import threading
import time

import torch

from . import telemetry
from ._atomic_io import atomic_write
from .base import MXNetError
from .fault import hooks as _fault
from .ndarray import NDArray
from . import optimizer as opt
from .telemetry import tracing as _tracing

__all__ = ["KVStore", "KVStoreTPU", "create"]


# a thread-local reentrancy flag keeps super() chains (KVStoreTPU.pull ->
# KVStore.pull) from counting one user-visible call twice
_TELEM_TL = threading.local()


def _payload_nbytes(v):
    """Byte count of a push value / pull out tree."""
    if isinstance(v, NDArray):
        return v._data.numel() * v._data.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_payload_nbytes(x) for x in v)
    if isinstance(v, dict):
        return sum(_payload_nbytes(x) for x in v.values())
    return 0


def _instrumented(op):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, key, *args, **kwargs):
            # one "kvstore.push"/"kvstore.pull" site hit (and span) per
            # user-visible call under an armed fault plan: the inner
            # call re-enters with the flag set and runs the body
            if _fault.ACTIVE[0] and not getattr(_TELEM_TL, "fault_busy",
                                                False):
                _TELEM_TL.fault_busy = True
                try:
                    with _tracing.span("kvstore." + op):
                        _fault.fire("kvstore." + op)
                        return wrapper(self, key, *args, **kwargs)
                finally:
                    _TELEM_TL.fault_busy = False
            if not telemetry.enabled() or getattr(_TELEM_TL, "busy", False):
                return fn(self, key, *args, **kwargs)
            _TELEM_TL.busy = True
            t0 = time.perf_counter()
            try:
                result = fn(self, key, *args, **kwargs)
            finally:
                _TELEM_TL.busy = False
            # success path only: a raising call moved no traffic
            dt = time.perf_counter() - t0
            payload = (args[0] if args else
                       kwargs.get("value") or kwargs.get("out"))
            telemetry.counter(
                "mxnet_kvstore_ops_total",
                "completed kvstore data-plane calls").labels(op=op).inc()
            telemetry.counter(
                "mxnet_kvstore_bytes_total",
                "payload bytes moved through kvstore push/pull"
            ).labels(op=op).inc(_payload_nbytes(payload))
            telemetry.histogram(
                "mxnet_kvstore_op_seconds",
                "wall time of completed kvstore push/pull calls").labels(
                op=op).observe(dt)
            return result
        return wrapper
    return deco


def _key_values(keys, vals):
    """(keys, values) -> parallel lists of keys and of value lists
    (reference: kvstore.py:45)."""
    if isinstance(keys, (tuple, list)):
        if len(keys) != len(vals):
            raise MXNetError("%d keys for %d values" % (len(keys), len(vals)))
        out_keys, out_vals = [], []
        for k, v in zip(keys, vals):
            ks, vs = _key_values(k, v)
            out_keys.extend(ks)
            out_vals.extend(vs)
        return out_keys, out_vals
    if isinstance(vals, NDArray):
        return [keys], [[vals]]
    if not all(isinstance(v, NDArray) for v in vals):
        raise MXNetError("kvstore values must be NDArrays")
    return [keys], [list(vals)]


class KVStore:
    """In-process key-value store (reference: include/mxnet/kvstore.h:47)."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None

    def init(self, key, value):
        """Store a copy of each key's first value, once (reference:
        kvstore.py:114)."""
        keys, vals = _key_values(key, value)
        for k, vlist in zip(keys, vals):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = NDArray(vlist[0]._data.clone())

    def _reduce(self, vlist):
        """The sum of one key's pushed values (one per device)."""
        merged = vlist[0]._data
        for v in vlist[1:]:
            merged = merged + v._data.to(merged.device)
        return NDArray(merged)

    @_instrumented("push")
    def push(self, key, value, priority=0):
        """Aggregate values into the store, applying the updater if set
        (reference: kvstore.py:158)."""
        keys, vals = _key_values(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % (k,))
            merged = self._reduce(vlist)
            if self._updater is not None:
                self._updater(self._key_int(k), merged, self._store[k])
            else:
                self._store[k]._data = self._store[k]._data + merged._data

    @_instrumented("pull")
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Point each out array at the stored value (reference:
        kvstore.py:238)."""
        if out is None:
            raise MXNetError("pull needs out arrays")
        keys, outs = _key_values(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % (k,))
            src = self._store[k]._data
            for o in olist:
                o._data = src if (src.dtype == o._data.dtype
                                  and src.device == o._data.device) \
                    else src.to(device=o._data.device, dtype=o._data.dtype)

    def set_optimizer(self, optimizer):
        """Run the optimizer on the store (update on kvstore; reference
        kvstore.py:443)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    @staticmethod
    def _key_int(k):
        """Integer-like keys as ints; names pass through (the optimizer
        looks its multipliers up by name)."""
        if isinstance(k, int):
            return k
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the updater's states to ``fname`` (reference:
        kvstore.py save_optimizer_states)."""
        if self._updater is None:
            raise MXNetError("this kvstore runs no optimizer: it has no "
                             "states to save")
        atomic_write(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Read states written by ``save_optimizer_states``."""
        if self._updater is None:
            raise MXNetError("this kvstore runs no optimizer: set one "
                             "before loading its states")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1


class KVStoreTPU(KVStore):
    """The fused-update store (``kvstore="tpu"``): pushes are buffered and
    the first pull applies every buffered update at once, through the
    optimizer's per-array form, with lr and wd for all keys in one small
    fp32 tensor (reference for the semantics: the server-side update,
    kvstore_dist_server.h:282).  The slots are the updater's states, so
    they are what ``save_optimizer_states`` writes (the JAX package keeps
    them apart and writes an empty updater)."""

    fused_update = True

    def __init__(self, kv_type="tpu"):
        super().__init__(kv_type)
        self._pending = {}    # key -> merged gradient tensor

    def _fused(self):
        o = self._optimizer
        return None if o is None else opt.fused_update_kernel(o)

    @_instrumented("push")
    def push(self, key, value, priority=0):
        if self._updater is None or self._fused() is None:
            return super().push(key, value, priority)
        keys, vals = _key_values(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % (k,))
            if k in self._pending:
                # one update per push: apply the buffered one first
                self._flush()
            self._pending[k] = self._reduce(vlist)._data

    @_instrumented("pull")
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if self._pending:
            self._flush()
        return super().pull(key, out=out, priority=priority,
                            ignore_sparse=ignore_sparse)

    def _flush(self):
        o = self._optimizer
        init_state, one = self._fused()
        keys = list(self._pending)
        hyper = [opt.fused_lr_wd(o, self._key_int(k)) for k in keys]
        device = self._store[keys[0]]._data.device
        hyper = torch.tensor(hyper, dtype=torch.float32, device=device)
        states = self._updater.states
        for j, k in enumerate(keys):
            w = self._store[k]._data
            slots = tuple(s.to(w.device) for s in opt.state_slots(
                states[k])) if k in states else init_state(w)
            nw, nst = one(w, self._pending[k], slots, hyper[j, 0],
                          hyper[j, 1])
            self._store[k]._data = nw
            states[k] = opt.slots_state(tuple(nst))
        self._pending.clear()


def create(name="local"):
    """A kvstore by type name (reference: kvstore.py create):
    ``local``/``device`` or ``tpu`` (``nccl`` is an alias of ``tpu``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "device", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStore(name)
    if name in ("tpu", "nccl"):
        return KVStoreTPU("tpu")
    raise MXNetError("kvstore type %r is not ported yet (this package has "
                     "local, device and tpu)" % name)
