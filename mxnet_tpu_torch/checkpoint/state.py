"""TrainState — everything needed to resume training bit-identically
(counterpart of ``mxnet_tpu/checkpoint/state.py``).

The legacy ``model.save_checkpoint`` persists params only; a restore
from it replays a DIFFERENT training run: the optimizer restarts with
zeroed momentum, the lr scheduler falls back to update 0, the data
iterator starts the epoch over, and the RNG chain re-deals every
dropout mask.  TrainState closes each of those gaps:

- **params / aux states** — staged to host (one device-to-host copy per
  array, before the next step is launched) and stored as raw shards;
- **optimizer state** — the ``Updater`` payload pickled WITH its
  optimizer (``get_states(dump_optimizer=True)``: slots, ``num_update``,
  the per-index update counts and the live ``lr_scheduler``).  Under
  ``kvstore="tpu"`` the executor's fused step owns the slots and the
  kvstore's updater never sees a step, so the payload is built from the
  executor's slots (``optimizer_slots``), in the layout the ``local``
  path's ``Updater`` keeps: SGD's momentum survives a resume there too
  (the JAX package captures the kvstore's empty updater and loses it);
- **RNG** — ``meta["rng"]`` keeps the JAX package's shape, ``{"seed",
  "count"}`` with the package seed and count 0, so the JAX package can
  read a checkpoint this package wrote; the torch generator states (the
  port's RNG, ``random.get_state``) go in the ``torch_rng`` blob, and the
  global numpy generator (which ``NDArrayIter(shuffle=True)`` draws from
  at every epoch reset) in ``np_random``.  A checkpoint the JAX package
  wrote has no ``torch_rng``: restoring it seeds the port's generators
  from ``meta["rng"]["seed"]``, and the draws that follow differ from the
  JAX run's (the two packages' streams differ by design);
- **iterator position** — cursor (plus the shuffled index order when
  present) of any iterator exposing the ``NDArrayIter`` contract;
- **loop position** — epoch / nbatch / global step;
- **serving handoff** — the symbol JSON and bound input shapes, so the
  serving registry can hot-swap a committed checkpoint without the
  training script's help.

A TrainState is a plain host-side value: capture is the staging, all
serialization and hashing happen later (the async writer thread).
"""
from __future__ import annotations

import logging
import pickle
import warnings

import numpy as np
import torch

from .. import optimizer as _opt
from .. import random as _random

__all__ = ["TrainState", "ParallelTrainerState", "capture_iter_state",
           "restore_iter_state"]

_ARG_PREFIX = "arg/"
_AUX_PREFIX = "aux/"
_ITER_IDX_KEY = "iter/idx"
_OPTIMIZER_BLOB = "optimizer"
_SYMBOL_BLOB = "symbol"
_NP_RANDOM_BLOB = "np_random"
_TORCH_RNG_BLOB = "torch_rng"


def capture_iter_state(data_iter):
    """Snapshot a data iterator's position: ``(meta_dict, idx_array)``.

    Supports the in-memory iterator contract (``cursor`` int attribute,
    optional ``idx`` permutation — ``NDArrayIter``); returns ``(None,
    None)`` for iterators with no capturable position (streaming or
    prefetching readers), in which case resume restarts the epoch —
    documented, not silent: callers get a warning."""
    if data_iter is None:
        return None, None
    cursor = getattr(data_iter, "cursor", None)
    if not isinstance(cursor, (int, np.integer)):
        warnings.warn(
            "data iterator %s exposes no cursor; resume will restart "
            "the current epoch" % type(data_iter).__name__, stacklevel=3)
        return None, None
    meta = {"cursor": int(cursor),
            "iter_class": type(data_iter).__name__}
    idx = getattr(data_iter, "idx", None)
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    return meta, (np.asarray(idx) if idx is not None else None)


def restore_iter_state(data_iter, meta, idx):
    """Reposition ``data_iter`` to a captured state (inverse of
    :func:`capture_iter_state`)."""
    if data_iter is None or not meta:
        return False
    if not hasattr(data_iter, "cursor"):
        warnings.warn(
            "data iterator %s cannot be repositioned; resuming from "
            "the top of the epoch" % type(data_iter).__name__, stacklevel=3)
        return False
    if idx is not None and hasattr(data_iter, "idx"):
        # restore the epoch's shuffle order BEFORE the cursor so the
        # remaining batches are the uninterrupted run's batches
        data_iter.idx = np.array(idx)
    data_iter.cursor = int(meta["cursor"])
    return True


class _Staged:
    """Host copies of device tensors, queued without waiting.

    Each tensor is copied into a slice of one host buffer per dtype
    (pinned memory for a CUDA tensor, ``non_blocking``) on the current
    stream, so the copies run after the work already queued (the step
    just taken) and before any work queued later (the next step's fused
    sweep, which updates the weights in place).  The caller goes on at
    once; :meth:`wait` blocks until the copies have landed.  A CPU
    tensor is copied synchronously."""

    def __init__(self, named):
        self._event = None
        self.values = {}
        groups = {}
        for key, t in named:
            t = t.detach()
            groups.setdefault((t.dtype, t.device.type), []).append((key, t))
        for (dtype, kind), items in groups.items():
            n = sum(t.numel() for _k, t in items)
            host = torch.empty(n, dtype=dtype, pin_memory=kind == "cuda")
            off = 0
            for key, t in items:
                view = host[off:off + t.numel()].view(t.shape)
                view.copy_(t, non_blocking=kind == "cuda")
                self.values[key] = view if dtype == torch.bfloat16 \
                    else view.numpy()
                off += t.numel()
            if kind == "cuda":
                self._event = torch.cuda.Event()
                self._event.record()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None


class _SlotsPickle:
    """The fused step's optimizer payload, pickled when ``bytes()`` asks
    (on the writer's thread, after the staged slots have landed): the
    ``{index: state}`` of the local path's ``Updater``, each state its
    numpy slots, with the optimizer."""

    def __init__(self, states, optimizer, staged):
        # the optimizer as it is now: training goes on updating the live
        # one (its counts, its schedule) before the writer pickles this
        self._payload = (states, pickle.loads(pickle.dumps(optimizer)))
        self._staged = staged

    def __bytes__(self):
        self._staged.wait()
        return pickle.dumps(self._payload)


class _PortUnpickler(pickle.Unpickler):
    """Refuses the JAX package's classes: an optimizer payload it
    pickled would import it (and JAX) to load."""

    def find_class(self, module, name):
        if module.split(".")[0] == "mxnet_tpu":
            raise pickle.UnpicklingError(
                "optimizer state pickled by the JAX package (%s.%s)"
                % (module, name))
        return super().find_class(module, name)


def _loads(blob):
    import io
    return _PortUnpickler(io.BytesIO(blob)).load()


def _slot_tensors(state):
    """An optimizer state (None, an NDArray, a numpy array, or a tuple of
    them) -> the tuple of its slots as tensors."""
    if state is None:
        return ()
    if not isinstance(state, (tuple, list)):
        state = (state,)
    return tuple(s._data if hasattr(s, "_data")
                 else torch.from_numpy(np.array(s)) for s in state)


def _rekey_counts(optimizer, names, by_name):
    """The optimizer's per-parameter update counts keyed as the path
    that resumes them keys them: the fused step by weight name, the
    ``Updater`` by index into ``names``."""
    counts = getattr(optimizer, "_index_update_count", None)
    if not counts:
        return
    if by_name:
        optimizer._index_update_count = {
            names[k] if isinstance(k, int) and k < len(names) else k: v
            for k, v in counts.items()}
    else:
        pos = {n: i for i, n in enumerate(names)}
        optimizer._index_update_count = {pos.get(k, k): v
                                         for k, v in counts.items()}


def _to_nd(value, device):
    from ..ndarray import NDArray
    if isinstance(value, torch.Tensor):
        return NDArray(value.to(device))
    return NDArray(torch.from_numpy(np.array(value)).to(device))


def _fused_executor(module):
    """The executor whose fused step owns the optimizer slots, or None."""
    if not getattr(module, "_fused_exec_update", False):
        return None
    return module._exec_group.execs[0]


def _updater_of(module):
    updater = getattr(module, "_updater", None)
    if updater is None:
        updater = getattr(getattr(module, "_kvstore", None), "_updater",
                          None)
    return updater


class TrainState:
    """One resumable snapshot of a training job (host-side value)."""

    def __init__(self, arg_params, aux_params, meta, optimizer_state=None,
                 symbol_json=None, iter_idx=None, np_random_state=None,
                 torch_rng_state=None):
        self.arg_params = dict(arg_params)       # name -> host array
        self.aux_params = dict(aux_params)       # name -> host array
        self.meta = dict(meta)
        # pickle bytes (or an object whose bytes() is the pickle) or None
        self.optimizer_state = optimizer_state
        self.symbol_json = symbol_json           # str or None
        self.iter_idx = iter_idx                 # numpy permutation or None
        self.np_random_state = np_random_state   # pickle bytes or None
        self.torch_rng_state = torch_rng_state   # pickle bytes or None
        self._staged = None      # copies to the host still in flight

    def wait(self):
        """Block until the host copies :meth:`capture` queued have
        landed; the arrays may be read after it (the writer calls it
        before serializing)."""
        if self._staged is not None:
            self._staged.wait()
            self._staged = None

    # -- capture -------------------------------------------------------------
    @classmethod
    def capture(cls, module, epoch=0, nbatch=0, global_step=None,
                train_data=None):
        """Snapshot ``module`` + the loop/RNG/iterator state around it.

        ``get_params`` syncs the master copies from the executor; the
        copies of the masters (and of the fused step's slots) to the host
        are the staging step, queued on the current stream without
        waiting (:class:`_Staged`): ordered before the next step, read by
        the writer after :meth:`wait`.  The snapshot shares nothing with
        device memory, and training goes on while a writer serializes
        it."""
        arg_params, aux_params = module.get_params()
        named = [(("arg", k), v._data) for k, v in arg_params.items()]
        named += [(("aux", k), v._data) for k, v in aux_params.items()]
        fused = _fused_executor(module)
        updater = _updater_of(module)
        slots = {}
        if fused is not None:
            # the fused step's slots, keyed as the local path's Updater
            # keys them, with the optimizer (its counts and schedule)
            names = module._exec_group.param_names
            live = fused.optimizer_slots()
            slots = {i: live[n] for i, n in enumerate(names) if n in live}
            named += [(("slot", i, j), t) for i, ts in slots.items()
                      for j, t in enumerate(ts)]
        staged = _Staged(named)
        host = staged.values
        args = {k: host[("arg", k)] for k in arg_params}
        auxs = {k: host[("aux", k)] for k in aux_params}

        optimizer_state = None
        if fused is not None:
            states = {}
            for i, ts in slots.items():
                st = tuple(host[("slot", i, j)] for j in range(len(ts)))
                states[i] = None if not st else st[0] if len(st) == 1 \
                    else st
            optimizer_state = _SlotsPickle(states, module._optimizer,
                                           staged)
        elif updater is not None:
            optimizer_state = updater.get_states(dump_optimizer=True)
        elif getattr(module, "optimizer_initialized", False):
            warnings.warn(
                "the module's optimizer state is not reachable (no "
                "updater and no fused step); resume restarts optimizer "
                "slots", stacklevel=2)

        rng = _random.get_state()
        np_random_state = pickle.dumps(np.random.get_state())
        torch_rng_state = pickle.dumps(
            {"seed": rng["seed"],
             "generators": {d: t.numpy() for d, t in
                            rng["generators"].items()}})
        # the JAX package's shape: its random.set_state reads both keys
        meta = {"epoch": int(epoch), "nbatch": int(nbatch),
                "rng": {"seed": int(rng["seed"]), "count": 0}}
        if global_step is not None:
            meta["global_step"] = int(global_step)
        optimizer = getattr(module, "_optimizer", None)
        if optimizer is not None:
            meta["num_update"] = int(getattr(optimizer, "num_update", 0))

        iter_meta, iter_idx = capture_iter_state(train_data)
        if iter_meta is not None:
            meta["iter"] = iter_meta

        symbol_json = None
        if getattr(module, "symbol", None) is not None:
            symbol_json = module.symbol.tojson()
        if getattr(module, "binded", False):
            meta["input_shapes"] = {d.name: list(d.shape)
                                    for d in module.data_shapes}
        state = cls(args, auxs, meta, optimizer_state=optimizer_state,
                    symbol_json=symbol_json, iter_idx=iter_idx,
                    np_random_state=np_random_state,
                    torch_rng_state=torch_rng_state)
        state._staged = staged
        return state

    # -- store payload -------------------------------------------------------
    def to_payload(self):
        """``(arrays, blobs, meta)`` in the store's manifest vocabulary."""
        arrays = {_ARG_PREFIX + k: v for k, v in self.arg_params.items()}
        arrays.update({_AUX_PREFIX + k: v
                       for k, v in self.aux_params.items()})
        if self.iter_idx is not None:
            arrays[_ITER_IDX_KEY] = self.iter_idx
        blobs = {}
        if self.optimizer_state is not None:
            blobs[_OPTIMIZER_BLOB] = self.optimizer_state
        if self.symbol_json is not None:
            blobs[_SYMBOL_BLOB] = self.symbol_json.encode()
        if self.np_random_state is not None:
            blobs[_NP_RANDOM_BLOB] = self.np_random_state
        if self.torch_rng_state is not None:
            blobs[_TORCH_RNG_BLOB] = self.torch_rng_state
        return arrays, blobs, self.meta

    @classmethod
    def from_payload(cls, arrays, blobs, meta):
        """Rebuild a TrainState from a store ``read()`` result."""
        args = {k[len(_ARG_PREFIX):]: v for k, v in arrays.items()
                if k.startswith(_ARG_PREFIX)}
        auxs = {k[len(_AUX_PREFIX):]: v for k, v in arrays.items()
                if k.startswith(_AUX_PREFIX)}
        symbol_json = blobs.get(_SYMBOL_BLOB)
        return cls(args, auxs, meta,
                   optimizer_state=blobs.get(_OPTIMIZER_BLOB),
                   symbol_json=(symbol_json.decode()
                                if symbol_json is not None else None),
                   iter_idx=arrays.get(_ITER_IDX_KEY),
                   np_random_state=blobs.get(_NP_RANDOM_BLOB),
                   torch_rng_state=blobs.get(_TORCH_RNG_BLOB))

    # -- restore -------------------------------------------------------------
    def restore_into(self, module, train_data=None, restore_rng=True):
        """Load this snapshot into ``module`` (and optionally reposition
        ``train_data`` / the RNG state).

        A bound module gets ``set_params(force_init=True)``; an unbound
        one gets its master param dicts assigned directly on its context
        (the ``Module.load`` deferred path — ``bind`` pushes them to the
        executor later).  When the module's optimizer is initialized, the
        pickled payload restores the slots and the optimizer's counts and
        schedule: into the fused step's slots under ``kvstore="tpu"``
        (the live optimizer object keeps its identity, its state is
        replaced), else into the local updater, whose optimizer is then
        re-linked as the module's."""
        from ..context import resolve
        self.wait()
        contexts = getattr(module, "_context", None)
        device = resolve(contexts[0] if contexts else None)
        args = {k: _to_nd(v, device) for k, v in self.arg_params.items()}
        auxs = {k: _to_nd(v, device) for k, v in self.aux_params.items()}
        if getattr(module, "binded", False):
            module.set_params(args, auxs, force_init=True)
        else:
            module._arg_params = args
            module._aux_params = auxs
            module.params_initialized = True

        if self.optimizer_state is not None and \
                getattr(module, "optimizer_initialized", False):
            self._restore_optimizer(module)

        if restore_rng and self.torch_rng_state is not None:
            saved = pickle.loads(self.torch_rng_state)
            _random.set_state(
                {"seed": saved["seed"],
                 "generators": {d: torch.from_numpy(np.array(g))
                                for d, g in saved["generators"].items()}})
        elif restore_rng and "rng" in self.meta:
            # a checkpoint the JAX package wrote: its threefry position
            # has no torch counterpart, so only the seed carries over
            _random.seed(int(self.meta["rng"]["seed"]))
        if restore_rng and self.np_random_state is not None:
            np.random.set_state(pickle.loads(self.np_random_state))
        if train_data is not None:
            restore_iter_state(train_data, self.meta.get("iter"),
                               self.iter_idx)
        return self

    def _restore_optimizer(self, module):
        try:
            payload = _loads(bytes(self.optimizer_state))
        except pickle.UnpicklingError as exc:
            logging.warning("checkpoint: %s; optimizer slots not restored "
                            "(optimizer state loads only in the package "
                            "that wrote it)", exc)
            return
        states, optimizer = payload if isinstance(payload, tuple) \
            else (payload, None)
        fused = _fused_executor(module)
        updater = _updater_of(module)
        names = module._exec_group.param_names
        if optimizer is not None:
            _rekey_counts(optimizer, names, by_name=fused is not None)
        if fused is not None:
            fused.load_optimizer_slots({names[i]: _slot_tensors(st)
                                        for i, st in states.items()})
            if optimizer is not None:
                module._optimizer.__dict__.update(optimizer.__getstate__())
        elif updater is not None:
            # the Updater's states as NDArrays, whichever path wrote them
            # (the fused step's payload holds numpy slots)
            updater.states = {i: _opt.slots_state(_slot_tensors(st))
                              for i, st in states.items()}
            updater.states_synced = dict.fromkeys(updater.states, False)
            if optimizer is not None:
                updater.optimizer = optimizer
            module._optimizer = updater.optimizer
        else:
            logging.warning(
                "checkpoint has optimizer state but module has no "
                "local updater; optimizer slots not restored")

    # -- conveniences --------------------------------------------------------
    @property
    def epoch(self):
        return int(self.meta.get("epoch", 0))

    @property
    def nbatch(self):
        return int(self.meta.get("nbatch", 0))

    def __repr__(self):
        return ("TrainState(epoch=%d, nbatch=%d, params=%d, aux=%d, "
                "optimizer=%s)"
                % (self.epoch, self.nbatch, len(self.arg_params),
                   len(self.aux_params),
                   "yes" if self.optimizer_state is not None else "no"))


# ---------------------------------------------------------------------------
# ParallelTrainer snapshots — mesh-independent logical state
# ---------------------------------------------------------------------------

_P_PARAM_PREFIX = "param/"
_P_SLOT_PREFIX = "slot/"
_P_SCALAR_PREFIX = "scalar/"
_P_RESID_PREFIX = "resid/"


class ParallelTrainerState:
    """One resumable :class:`~mxnet_tpu_torch.parallel.ParallelTrainer`
    snapshot in MESH-INDEPENDENT form (counterpart of
    ``mxnet_tpu/checkpoint/state.py:263``).

    ``ParallelTrainer.state_dict()`` gathers the ZeRO shards of every rank
    and hands back full logical host arrays with the optimizer slots PER
    PARAMETER; this class maps that dict onto the store's ``(arrays,
    blobs, meta)`` vocabulary under the JAX package's keys
    (``param/<name>``, ``slot/<slot>/<name>``, ``scalar/<slot>``,
    ``resid/<name>``), so the checkpoint is the JAX package's byte for
    byte and each package restores the other's.  Nothing in the payload
    encodes a mesh, a ZeRO stage or a bucket plan: a restore may land on
    a trainer with any of them changed, bit for bit."""

    kind = "parallel_trainer"

    def __init__(self, params, slots, scalars, residuals, meta):
        self.params = dict(params)       # name -> numpy array
        self.slots = {s: dict(v) for s, v in slots.items()}
        self.scalars = dict(scalars)     # slot scalar (e.g. Adam t)
        self.residuals = dict(residuals)  # name -> numpy array
        self.meta = dict(meta)

    # -- capture -------------------------------------------------------------
    @classmethod
    def capture(cls, trainer):
        """Host-stage ``trainer``'s state (collective over its mesh: every
        rank calls it)."""
        sd = trainer.state_dict()
        meta = dict(sd["meta"])
        meta["kind"] = cls.kind
        return cls(sd["params"], sd["slots"], sd["scalars"],
                   sd["residuals"], meta)

    def wait(self):
        """The arrays are host copies already (the manager's contract)."""

    # -- store payload -------------------------------------------------------
    def to_payload(self):
        """``(arrays, blobs, meta)`` in the store's manifest vocabulary."""
        arrays = {_P_PARAM_PREFIX + n: v for n, v in self.params.items()}
        for slot, per_param in self.slots.items():
            for n, v in per_param.items():
                arrays["%s%s/%s" % (_P_SLOT_PREFIX, slot, n)] = v
        for slot, v in self.scalars.items():
            arrays[_P_SCALAR_PREFIX + slot] = np.asarray(v)
        for n, v in self.residuals.items():
            arrays[_P_RESID_PREFIX + n] = v
        return arrays, {}, self.meta

    @classmethod
    def from_payload(cls, arrays, blobs, meta):
        del blobs  # none in this payload kind
        params, slots, scalars, residuals = {}, {}, {}, {}
        for key, v in arrays.items():
            if key.startswith(_P_PARAM_PREFIX):
                params[key[len(_P_PARAM_PREFIX):]] = v
            elif key.startswith(_P_SLOT_PREFIX):
                slot, name = key[len(_P_SLOT_PREFIX):].split("/", 1)
                slots.setdefault(slot, {})[name] = v
            elif key.startswith(_P_SCALAR_PREFIX):
                scalars[key[len(_P_SCALAR_PREFIX):]] = v
            elif key.startswith(_P_RESID_PREFIX):
                residuals[key[len(_P_RESID_PREFIX):]] = v
        return cls(params, slots, scalars, residuals, meta)

    # -- restore -------------------------------------------------------------
    def as_state_dict(self):
        return {"params": self.params, "slots": self.slots,
                "scalars": self.scalars, "residuals": self.residuals,
                "meta": self.meta}

    def restore_into(self, trainer):
        trainer.load_state_dict(self.as_state_dict())
        return self

    @classmethod
    def restore_latest(cls, store, trainer, step=None):
        """Restore the newest (or ``step``-specific) trainer snapshot in
        ``store`` that verifies, walking backwards past bit-rot and
        payloads of another kind; returns the restored step id or None.
        The trainer's mesh, ZeRO stage and bucket plan may differ from
        the captured ones: :meth:`restore_into` reshards."""
        from .store import IntegrityError
        steps = [step] if step is not None else \
            list(reversed(store.steps()))
        for s in steps:
            try:
                manifest, arrays, blobs = store.read(s, verify=True)
            except (IntegrityError, OSError, ValueError) as exc:
                logging.warning(
                    "checkpoint: step %d unreadable (%s); trying older",
                    s, exc)
                continue
            meta = manifest.get("meta", {})
            if meta.get("kind") != cls.kind:
                logging.warning(
                    "checkpoint: step %d is %r, not a ParallelTrainer "
                    "snapshot; skipping", s, meta.get("kind"))
                continue
            cls.from_payload(arrays, blobs, meta).restore_into(trainer)
            logging.info("checkpoint: restored ParallelTrainer step %d", s)
            return int(s)
        return None

    def __repr__(self):
        return ("ParallelTrainerState(params=%d, slots=%s, residuals=%d)"
                % (len(self.params), sorted(self.slots), len(self.residuals)))
