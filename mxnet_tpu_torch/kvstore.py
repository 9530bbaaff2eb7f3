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

``row_sparse_pull`` (every store) hands out only the rows a batch
names: a row-sparse out gets them as its payload.  A push of row-sparse
values merges them into a row-sparse sum, so an updater with
``lazy_update`` moves only those rows; the ``tpu`` and ``dist_*`` stores
reduce a row-sparse push densely, as the JAX package does.

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
- ``dist_async`` (``KVStoreDistAsync``, counterpart of
  ``mxnet_tpu/kvstore.py:614-838``): update on arrival.  The coordinator
  (``DMLC_WORKER_ID`` 0) runs a server thread that applies each pushed
  gradient through the updater, on the store's device, in arrival order,
  and publishes every weight atomically into the shared spool
  (``MXNET_KVSTORE_ASYNC_DIR``); gradients cross on
  ``parallel.transport.SpoolTransport``, so the ``transport.*`` fault
  sites reach them.  ``push`` returns without waiting; ``pull`` reads the
  current, possibly stale, weights: that is the async contract.

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

__all__ = ["KVStore", "KVStoreTPU", "KVStoreDist", "KVStoreDistAsync",
           "create",
           "is_worker_node", "is_server_node", "is_scheduler_node"]


# a thread-local reentrancy flag keeps super() chains (KVStoreTPU.pull ->
# KVStore.pull) from counting one user-visible call twice
_TELEM_TL = threading.local()


def _payload_nbytes(v):
    """Byte count of a push value / pull out tree."""
    if isinstance(v, NDArray):
        # a sparse value counts its dense size, as in the JAX package,
        # without materialising it
        t = v._data if v.stype == "default" else v._values
        return v.size * t.element_size()
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
        the compression codec when one is set.  Row-sparse values (and no
        codec) merge into a row-sparse sum over the union of their rows,
        as the reference's CommCPU ReduceRowSparse does (src/kvstore/
        comm.h); the JAX package merges them into a dense array
        (ROADMAP queue 3)."""
        if self._gc is None and all(
                getattr(v, "stype", "default") == "row_sparse"
                for v in vlist):
            return _sum_row_sparse(vlist)
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
        """Merge each key's values and apply the updater to them if one
        is set, else store the merged value (reference: kvstore.py:158)."""
        keys, vals = _key_values(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % (k,))
            merged = self._reduce(k, vlist)
            if self._updater is not None:
                self._updater(self._key_int(k), merged, self._store[k])
            else:
                # the merged value replaces the stored one (reference:
                # kvstore_local.h PushImpl ``local = merged``; the JAX
                # package adds it, ROADMAP queue 3), as a copy on the
                # stored value's device
                w = self._store[k]._data
                self._store[k]._data = merged._data.to(
                    device=w.device, dtype=w.dtype, copy=True)

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
            src = self._current(k)
            for o in olist:
                o._data = src if (src.dtype == o._data.dtype
                                  and src.device == o._data.device) \
                    else src.to(device=o._data.device, dtype=o._data.dtype)

    def _current(self, k):
        """The stored tensor of key ``k`` as a pull hands it out."""
        if k not in self._store:
            raise MXNetError("key %r has not been initialized" % (k,))
        return self._store[k]._data

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows named in ``row_ids`` (one array for every
        key, or one a key; reference: kvstore.py row_sparse_pull,
        KVStore::PullRowSparse, kvstore.h:144).  A row-sparse out gets
        the gathered rows as its payload, the ids sorted and unique; a
        dense out gets them scattered into zeros (one scatter shared by
        the dense outs of a key)."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull needs out arrays and row_ids")
        keys, outs = _key_values(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        if len(row_ids) != len(keys):
            raise MXNetError("row_sparse_pull: one row_ids array per key "
                             "is required")
        for k, olist, rid in zip(keys, outs, row_ids):
            src = self._current(k)
            ids = torch.unique(rid._data.to(device=src.device,
                                            dtype=torch.int64))
            rows = src.index_select(0, ids)
            dense = None
            for o in olist:
                if getattr(o, "stype", "default") == "row_sparse":
                    dev = o._values.device
                    o._set_payload(
                        rows.to(device=dev, dtype=o._values.dtype),
                        ids.to(dev), None, src.shape)
                    continue
                if dense is None:
                    dense = torch.zeros_like(src).index_copy_(0, ids, rows)
                o._data = dense if (dense.dtype == o._data.dtype
                                    and dense.device == o._data.device) \
                    else dense.to(device=o._data.device,
                                  dtype=o._data.dtype)

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

    def _current(self, k):
        if self._pending:
            self._flush()
        return super()._current(k)

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


class KVStoreDistAsync(KVStore):
    """dist_async: update-on-arrival semantics (reference: the async
    branch of the ps-lite server, kvstore_dist_server.h:282 ApplyUpdates,
    kvstore.cc:55-58): no per-step aggregation barrier, and workers pull
    whatever weights the server holds (bounded staleness).

    The coordinator (worker 0) runs a server THREAD that applies updates
    in arrival order; gradients ride the fault-addressable
    :class:`~.parallel.transport.SpoolTransport` over a shared
    directory (``MXNET_KVSTORE_ASYNC_DIR``; a temporary one when unset
    and there is one worker).  An armed fault plan can partition, slow,
    lose the ack of or reorder the gradient link; pushes retry under one
    message id and the server's dedup absorbs resends."""

    def __init__(self, kv_type="dist_async"):
        super().__init__(kv_type)
        import tempfile
        from .parallel.transport import SpoolTransport
        self._rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
        self._world = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        root = _config.get("MXNET_KVSTORE_ASYNC_DIR")
        if not root:
            if self._world > 1:
                raise MXNetError(
                    "dist_async with %d workers needs a shared "
                    "MXNET_KVSTORE_ASYNC_DIR" % self._world)
            root = tempfile.mkdtemp(prefix="mxkv_async_")
        self._root = root
        self._push_dir = os.path.join(root, "push")
        self._w_dir = os.path.join(root, "weights")
        os.makedirs(self._push_dir, exist_ok=True)
        os.makedirs(self._w_dir, exist_ok=True)
        # every worker sends to the coordinator, whose inbox is push/;
        # the cap is the transport's exact flock admission
        cap = _config.get("MXNET_KVSTORE_ASYNC_MAX_PENDING")
        self._transport = SpoolTransport(
            root, self._rank, self._world,
            cap=cap if cap and cap > 0 else None,
            inbox=lambda r: "push")
        self._key_by_name = {}   # str(key) -> store key (keys cross the
                                 # spool as strings)
        self._lock = threading.Lock()
        self._applied_log = []   # server: (key, message id), arrivals
        self._stop = threading.Event()
        self._server = None
        if self._rank == 0:
            self._server = threading.Thread(target=self._serve,
                                            name="mxnet-kv-async",
                                            daemon=True)
            self._server.start()

    # -- server (coordinator thread, worker 0) --------------------------
    def _serve(self):
        while not self._stop.is_set():
            if not self._apply_arrivals():
                time.sleep(0.01)

    def _spool_files(self):
        """Completed spool files in arrival order (the coordinator
        inbox's scan)."""
        return self._transport._spool_files(0)

    def _apply_arrivals(self):
        """Apply every delivered push in arrival order; True if any.  The
        transport's recv drops duplicate message ids, so a resend never
        applies a gradient twice."""
        msgs = self._transport.recv()
        for msg in msgs:
            k = str(msg.meta.get("key"))
            grad = msg.arrays.get("grad")
            if grad is None:
                continue
            with self._lock:
                k = self._key_by_name.get(k, k)
                if k in self._store:
                    w = self._store[k]
                    g = NDArray(torch.from_numpy(grad).to(w._data.device))
                    if self._updater is not None:
                        # one optimizer step a push, from any worker
                        self._updater(self._key_int(k), g, w)
                    else:
                        w._data = w._data + g._data
                    if len(self._applied_log) >= 1000:
                        del self._applied_log[:500]  # a ring buffer
                    self._applied_log.append(
                        (k, "%d:%d:%d" % (msg.sender, msg.epoch,
                                          msg.seq)))
                    self._publish(k)
        return bool(msgs)

    def _publish(self, k):
        """Atomically expose the current weight for workers to pull."""
        import numpy as np
        tmp = os.path.join(self._w_dir, ".%s.tmp" % _san(k))
        np.save(tmp, self._store[k].asnumpy())
        os.replace(tmp + ".npy", os.path.join(self._w_dir,
                                              "%s.npy" % _san(k)))

    # -- worker surface ---------------------------------------------------
    def init(self, key, value):
        keys, vals = _key_values(key, value)
        for k in keys:
            self._key_by_name[str(k)] = k
        if self._rank == 0:
            super().init(key, value)
            with self._lock:
                for k in keys:
                    self._publish(k)
            return
        # workers adopt the server's initial weights (reference: only
        # one worker's init lands on the server)
        for k, vlist in zip(keys, vals):
            path = os.path.join(self._w_dir, "%s.npy" % _san(k))
            deadline = time.time() + 60
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise MXNetError(
                        "dist_async init: server never published %r"
                        % (k,))
                time.sleep(0.01)
            self._store[k] = NDArray(torch.from_numpy(
                self._load_weight(k)).to(vlist[0]._data.device))

    def _load_weight(self, k):
        import numpy as np
        from .fault.backoff import BackoffPolicy
        path = os.path.join(self._w_dir, "%s.npy" % _san(k))
        # a read racing a replace retries on the shared backoff policy
        # (millisecond delays, jittered by rank; ~1 s in all)
        policy = BackoffPolicy(retries=40, base_s=0.005, max_s=0.025,
                               seed=self._rank)
        try:
            return policy.call(lambda: np.load(path),
                               retry_on=(OSError, ValueError))
        except (OSError, ValueError):
            raise MXNetError("dist_async: cannot read weight %r" % (k,))

    @_instrumented("push")
    def push(self, key, value, priority=0):
        """Send the merged gradient across the transport and RETURN; the
        server applies it on arrival.  A full coordinator inbox blocks,
        then raises past the backpressure timeout (the server thread is
        dead, not behind).  Injected link faults are retried under one
        message id."""
        keys, vals = _key_values(key, value)
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % (k,))
            merged = self._reduce(k, vlist)
            try:
                self._transport.send_reliable(
                    0, "grad", meta={"key": str(k)},
                    arrays={"grad": merged._data})
            except ConnectionError as exc:
                raise MXNetError("dist_async push: %s" % (exc,))

    @_instrumented("pull")
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Read the server's CURRENT weights, which may miss pushes still
        in flight (the async contract)."""
        if out is None:
            raise MXNetError("pull needs out arrays")
        keys, outs = _key_values(key, out)
        for k, olist in zip(keys, outs):
            src = self._current(k)
            for o in olist:
                o._data = src if (src.dtype == o._data.dtype
                                  and src.device == o._data.device) \
                    else src.to(device=o._data.device, dtype=o._data.dtype)

    def _current(self, k):
        """The server's current weight: the coordinator's own, any other
        worker's read from the spool (and kept as its copy)."""
        if k not in self._store:
            raise MXNetError("key %r has not been initialized" % (k,))
        if self._rank == 0:
            with self._lock:
                return self._store[k]._data
        dev = self._store[k]._data.device
        src = torch.from_numpy(self._load_weight(k)).to(dev)
        self._store[k] = NDArray(src)
        return src

    def wait_to_drain(self, timeout=30):
        """Block until the push spool is empty (tests, clean shutdown)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not self._spool_files():
                return True
            time.sleep(0.01)
        return False

    def close(self):
        self._stop.set()
        if self._server is not None:
            self._server.join(timeout=5)
        self._transport.close()

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._world


def _sum_row_sparse(vlist):
    """The row-sparse sum of row-sparse values: the union of their rows
    (sorted), each the sum of its values, added in push order."""
    from .ndarray.sparse import RowSparseNDArray
    if len(vlist) == 1:
        return vlist[0]
    parts = [v._fresh() for v in vlist]
    dev = parts[0]._values.device
    idx = torch.cat([p._indices.to(dev) for p in parts])
    vals = torch.cat([p._values.to(dev) for p in parts])
    rows, where = torch.unique(idx, return_inverse=True)
    summed = torch.zeros((rows.numel(),) + tuple(vals.shape[1:]),
                         dtype=vals.dtype, device=dev).index_add_(
        0, where, vals)
    return RowSparseNDArray(summed, indices=rows, shape=parts[0].shape)


def _san(k):
    """Filesystem-safe, collision-free key encoding: a readable prefix
    and the crc of the real key ('a/b' and 'a_b' must not share a
    file)."""
    import zlib
    s = str(k)
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in s)
    return "%s-%08x" % (safe, zlib.crc32(s.encode()))


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
    multi-process ``dist_sync``/``dist_device_sync``/``dist`` and
    ``dist_async``."""
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
        return KVStoreDistAsync(name)
    raise MXNetError("unknown KVStore type %r" % name)
