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
updater's pickled states, atomically.  ``set_gradient_compression`` runs
the shared codecs of ``gradient_compression`` (2bit, bf16, fp8, with
error feedback) on every push, as the JAX package does.

- ``dist_sync`` / ``dist_device_sync`` / ``dist`` (``KVStoreDist``,
  counterpart of ``mxnet_tpu/kvstore.py:426-612``): synchronous data
  parallelism over the ranks of ``torch.distributed``'s process group
  (``parallel.init_distributed``: ``tools/launch.py``'s ``DMLC_*`` or
  torchrun's environment).  There is no server process: ``init``
  broadcasts rank 0's value, ``push`` buffers the locally merged
  gradient, and the first ``pull`` flushes every pending key through
  ONE all-reduce of their concatenation (NCCL on the card, gloo on the
  CPU), then through ``KVStoreTPU``'s update.  Every rank then applies
  the same update to its copy.  ``barrier``, the heartbeat directory
  (``MXNET_KVSTORE_HEARTBEAT_DIR``, ``get_num_dead_node``) and the
  ``transport.collective`` fault site are the JAX package's.
  ``dist_async`` comes with the next multi-GPU slice.

Telemetry as in the JAX package: a completed user-visible ``push`` or
``pull`` counts in ``mxnet_kvstore_ops_total{op}``, its payload bytes in
``mxnet_kvstore_bytes_total{op}`` and its wall time in
``mxnet_kvstore_op_seconds{op}``, while telemetry is on.  Under an armed
fault plan each user-visible call is the ``kvstore.push`` or
``kvstore.pull`` site, inside a span of the same name.
"""
from __future__ import annotations

import functools
import os
import threading
import time

import torch

from . import config as _config
from . import telemetry
from ._atomic_io import atomic_write
from .base import MXNetError
from .fault import hooks as _fault
from .ndarray import NDArray
from . import optimizer as opt
from .telemetry import tracing as _tracing

__all__ = ["KVStore", "KVStoreTPU", "KVStoreDist", "create",
           "is_worker_node", "is_server_node", "is_scheduler_node"]


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
        self._compression_params = None
        self._gc = None

    def init(self, key, value):
        """Store a copy of each key's first value, once (reference:
        kvstore.py:114)."""
        keys, vals = _key_values(key, value)
        for k, vlist in zip(keys, vals):
            if k in self._store:
                raise MXNetError("key %r already initialized" % (k,))
            self._store[k] = NDArray(vlist[0]._data.clone())

    def _merge(self, k, vlist):
        """The sum of one key's pushed values (one per device), through
        the compression codec when one is set."""
        merged = vlist[0]._data
        for v in vlist[1:]:
            merged = merged + v._data.to(merged.device)
        if self._gc is not None:
            merged = self._gc.compress_decompress(k, merged).to(merged.dtype)
        return NDArray(merged)

    def _reduce(self, k, vlist):
        """One key's gradient as the update sees it; the dist store adds
        the sum over the ranks."""
        return self._merge(k, vlist)

    @_instrumented("push")
    def push(self, key, value, priority=0):
        """Aggregate values into the store, applying the updater if set
        (reference: kvstore.py:158)."""
        keys, vals = _key_values(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % (k,))
            merged = self._reduce(k, vlist)
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

    def set_gradient_compression(self, compression_params):
        """Compress every gradient pushed from now on with error feedback
        (reference: kvstore.py set_gradient_compression over
        gradient_compression.cc), e.g. ``{"type": "2bit", "threshold":
        0.5}``."""
        from .gradient_compression import GradientCompression
        self._compression_params = dict(compression_params)
        self._gc = GradientCompression(**self._compression_params)

    def set_optimizer(self, optimizer):
        """Run the optimizer on the store (update on kvstore; reference
        kvstore.py:443)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

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
        """Reference: kvstore.h:319 get_rank."""
        from .parallel import distributed
        return distributed.rank()

    @property
    def num_workers(self):
        """Reference: kvstore.h:326 get_group_size."""
        from .parallel import distributed
        return distributed.num_workers()

    def barrier(self):
        """Reference: kvstore.h:349 Barrier; a no-op in one process."""

    def get_num_dead_node(self, node_id=0, timeout_sec=60):
        """Unresponsive workers (reference: kvstore.h:338); a store in one
        process has no peers to lose."""
        return 0


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
            self._pending[k] = self._merge(k, vlist)._data

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


class KVStoreDist(KVStoreTPU):
    """Multi-process synchronous data-parallel store (``kvstore=dist_*``;
    see the module docstring).  Numerics are dist_sync's: one update per
    step on the gradient summed over the ranks, from replicas that start
    identical (rank 0's values)."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        from .parallel import distributed
        distributed.init_distributed()
        self._hb_dir = None
        hb = _config.get("MXNET_KVSTORE_HEARTBEAT_DIR")
        if hb:
            os.makedirs(hb, exist_ok=True)
            self._hb_dir = hb
            self._touch_heartbeat()

    # -- failure detection -----------------------------------------------
    def _touch_heartbeat(self):
        if self._hb_dir is None:
            return
        path = "%s/worker-%d.hb" % (self._hb_dir, self.rank)
        with open(path, "w") as f:
            f.write(str(time.time()))
        os.utime(path, None)

    def get_num_dead_node(self, node_id=0, timeout_sec=60):
        """Workers whose heartbeat file is stale or absent (reference:
        kvstore.h:338 over ps-lite heartbeats; here over the shared
        ``MXNET_KVSTORE_HEARTBEAT_DIR``)."""
        if self._hb_dir is None:
            return 0
        now = time.time()
        dead = 0
        for r in range(self.num_workers):
            path = "%s/worker-%d.hb" % (self._hb_dir, r)
            try:
                if now - os.path.getmtime(path) > timeout_sec:
                    dead += 1
            except OSError:
                dead += 1
        return dead

    # -- collective data plane -------------------------------------------
    def _allreduce_many(self, tensors, root_only=False):
        """The SUM over the ranks of each tensor (``root_only``: rank 0's
        value, the broadcast of ``init``), through ONE collective per
        dtype over their concatenation, on this rank's device."""
        from .parallel import collectives, distributed
        # dist_sync's traffic crosses ONE named seam per reduce: a plan
        # can partition or slow the whole step (peer="all": an
        # all-reduce has no single victim link)
        if _fault.ACTIVE[0]:
            with _tracing.span("transport.collective", keys=len(tensors)):
                _fault.fire("transport.collective", peer="all",
                            keys=len(tensors))
        if not distributed._group_up():
            return list(tensors)
        dev = distributed.device()
        out = list(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idxs in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1).to(dev)
                              for i in idxs])
            if root_only:
                collectives.broadcast(flat, 0, None)
            else:
                collectives.all_reduce(flat, None)
            off = 0
            for i in idxs:
                t = tensors[i]
                out[i] = flat[off:off + t.numel()].view(t.shape).to(
                    t.device)
                off += t.numel()
        return out

    def _flush(self):
        """Step boundary: one all-reduce over every pending key, then the
        fused store's update."""
        if self._pending:
            keys = list(self._pending)
            summed = self._allreduce_many([self._pending[k] for k in keys])
            self._pending = dict(zip(keys, summed))
            self._touch_heartbeat()
        super()._flush()

    def init(self, key, value):
        super().init(key, value)
        keys, _ = _key_values(key, value)
        vals = self._allreduce_many([self._store[k]._data for k in keys],
                                    root_only=True)
        for k, v in zip(keys, vals):
            self._store[k]._data = v

    def _reduce(self, k, vlist):
        merged = super()._reduce(k, vlist)
        self._touch_heartbeat()
        # a fresh tensor: with one value the merge IS the caller's
        # gradient, which push must not change
        return NDArray(self._allreduce_many([merged._data.clone()])[0])

    def barrier(self):
        """Global sync point (reference: kvstore.h:349 Barrier)."""
        from .parallel import distributed
        if distributed._group_up():
            import torch.distributed as dist
            dist.barrier()


def is_worker_node():
    """Reference: kvstore.h IsWorkerNode (DMLC_ROLE)."""
    return os.environ.get("DMLC_ROLE", "worker") == "worker"


def is_server_node():
    """Reference: kvstore.h IsServerNode — False unless DMLC_ROLE says
    so: the collective backend has no server processes."""
    return os.environ.get("DMLC_ROLE") == "server"


def is_scheduler_node():
    """Reference: kvstore.h IsSchedulerNode; process 0 plays the
    coordinator role."""
    if os.environ.get("DMLC_ROLE") == "scheduler":
        return True
    return os.environ.get("DMLC_WORKER_ID", "0") == "0"


def create(name="local"):
    """A kvstore by type name (reference: kvstore.py create):
    ``local``/``device``, ``tpu`` (``nccl`` is an alias), or the
    multi-process ``dist_sync``/``dist_device_sync``/``dist``."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "device", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStore(name)
    if name in ("tpu", "nccl"):
        return KVStoreTPU("tpu")
    if name in ("dist_sync", "dist_device_sync", "dist"):
        return KVStoreDist(name)
    if name == "dist_async":
        raise MXNetError("kvstore type 'dist_async' comes with the next "
                         "multi-GPU slice (dist_sync is ported)")
    raise MXNetError("unknown KVStore type %r" % name)
