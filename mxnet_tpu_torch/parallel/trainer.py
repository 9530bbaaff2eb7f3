"""ParallelTrainer — data-parallel training over the ranks of a mesh, with
bucketed gradient collectives and ZeRO-sharded optimizer state.

Counterpart of ``mxnet_tpu/parallel/trainer.py``.  The JAX package runs
each step as ONE compiled program over a device mesh, its collectives
inserted by GSPMD; here every rank of the mesh runs the step eagerly on
its own card and the collectives are explicit ``torch.distributed``
calls on the mesh's ``dp`` group (NCCL on the card, gloo on the CPU).
The numbers are the JAX package's:

- **the global batch** — ``step(data, label)`` takes the GLOBAL batch on
  every rank, and rank r computes on its contiguous 1/n of the rows (the
  JAX package's batch sharding).  Its local mean loss is divided by n
  before the backward, so the SUM of the ranks' gradients is the
  gradient of the global mean, and training-mode BatchNorm takes its
  moments over the whole global batch (``global_batch_stats``), as the
  JAX step, traced on the global array, does.  ``step`` returns the
  global mean loss.
- **one gradient per bucket** — the replicated fp32 trainables live in
  flat buckets (``build_bucket_plan``, reverse registration order,
  padded to the mesh size); each bucket is ONE autograd leaf and the
  parameters are views of it in the forward, so its gradient is one
  tensor.  A ``register_post_accumulate_grad_hook`` on the leaf issues
  the bucket's asynchronous collective the moment the backward finishes
  accumulating it (the JAX package's backward tap, ``_make_bucket_tap``);
  the step waits on every handle before the update.  At construction
  the replicas take the mesh's first rank's values (a broadcast).
- **ZeRO** (``zero=``): 0 all-reduces each bucket and updates the whole
  replicated state per parameter (the JAX package's per-array
  ``tree_map`` path, the sweep mirrors' arithmetic); 1 all-reduces, then
  updates only this rank's contiguous 1/n shard of each bucket with its
  1/n of the optimizer slots; 2 reduce-scatters each bucket straight
  into that shard.  Stages 1 and 2 then all-gather the updated shards
  back into every rank's parameters.  The shard update is one launch of
  the sweep kernel (K1a/K1b/K4) per bucket under
  ``MXNET_PALLAS_FUSED_OPT``, as in the JAX package's ``shard_map``-ped
  sweep.
- **compression** (``compression=``): the JAX package encodes the
  GLOBALLY reduced gradient (its program must complete the sum before
  the codec's nonlinear add of the residual), with error-feedback
  residuals sharded as the slots are.  The port does the same: the fp32
  bucket is reduced (scattered at zero=2), then each rank encodes its
  part with its residual part and decodes it.  ``comm_stats`` still
  reports the codec's modeled wire bytes, as the JAX package's does.
- **mixed precision** (``dtype="bfloat16"``): fp32 masters; the forward
  sees bf16 copies of the fp32 parameters and of the data, the loss is
  taken in fp32 and the gradients reach the buckets in fp32.

The trainer keeps the BatchNorm moving statistics moving: the JAX
package's step discards them (ROADMAP queue 3), this one writes back the
global batch's.  A rank outside the mesh (an elastic job's smaller
width) holds the plan and does nothing in ``step``.

Knobs resolve as argument, then environment, then registered default
(``MXNET_PARALLEL_ZERO``, ``_BUCKET_BYTES``, ``_BUCKET_FIRST_BYTES``,
``_COMPRESSION``), each with its source in ``plan_spec()["tuned_config"]``
(the tuning database of the JAX package is not ported).
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from .. import autograd
from .. import config as _config
from ..base import MXNetError
from ..context import Context
from ..gradient_compression import make_codec
from ..ndarray import NDArray
from . import collectives as coll
from .collectives import build_bucket_plan, flatten_bucket, unflatten_bucket
from .mesh import batch_sharded, make_mesh
from .optimizer import _fused_sweep_on, make_optimizer

__all__ = ["ParallelTrainer", "pure_block_apply"]


def _short(name):
    return name.split(":", 1)[1] if ":" in name else name


def pure_block_apply(block, param_names, is_train):
    """A functional apply of ``block``: ``fn(params, key, *inputs)`` runs
    the block with the tensors of ``params`` (``{name: tensor}``) in place
    of its parameters' values and returns its output tensor(s).  The run
    records (differentiably in those tensors) when any of them requires
    grad.  ``key`` is the JAX package's RNG key, unused: random ops draw
    from the port's generators."""
    del param_names

    def apply_fn(params, key, *inputs):
        del key
        nds = {_short(n): NDArray(t) for n, t in params.items()}
        rec = any(t.requires_grad for t in params.values())
        scope = autograd.record(train_mode=is_train) if rec \
            else autograd.pause(train_mode=is_train)
        with scope:
            out = _apply_with_params(block, nds,
                                     *[NDArray(x) for x in inputs])
        if isinstance(out, (list, tuple)):
            return tuple(o._data for o in out)
        return out._data

    return apply_fn


def _apply_with_params(block, params, *inputs):
    """Install ``params`` (``{name: NDArray}``) into the block tree for
    one call and restore the parameters' own values after."""
    saved = []
    try:
        for name, p in block.collect_params().items():
            if name in params:
                saved.append((p, p._data))
                p._data = params[name]
        return block(*inputs)
    finally:
        for p, old in saved:
            p._data = old


class _BucketViews(torch.autograd.Function):
    """A bucket's parameters as views of its flat leaf.  The backward
    writes every parameter's gradient into ONE new flat tensor (zeros in
    the padded tail), which becomes the leaf's gradient: one tensor per
    bucket, with no full-size zero tensor per view."""

    @staticmethod
    def forward(ctx, flat, bucket):
        ctx.bucket = bucket
        ctx.like = (flat.dtype, flat.device)
        return tuple(unflatten_bucket(flat, bucket).values())

    @staticmethod
    def backward(ctx, *grads):
        b = ctx.bucket
        dtype, device = ctx.like
        out = torch.empty(b.padded_n, dtype=dtype, device=device)
        for g, off, sz in zip(grads, b.offsets, b.sizes):
            if g is None:
                out[off:off + sz].zero_()
            else:
                out[off:off + sz].copy_(g.reshape(-1))
        out[b.n:].zero_()
        return out, None


def _as_tensor(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _host(t):
    return t.detach().to("cpu").numpy().copy()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class ParallelTrainer:
    """Data-parallel trainer for a Gluon block (see the module docstring).

    >>> trainer = ParallelTrainer(net, loss_fn, "sgd",
    ...                           {"learning_rate": 0.1}, zero=2)
    >>> loss = trainer.step(x, y)   # the global batch, on every rank
    """

    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, donate=True, dtype=None, zero=None,
                 bucket_bytes=None, first_bucket_bytes=None,
                 compression=None, compression_params=None):
        self._block = block
        self._loss = loss_fn
        self._mesh = mesh if mesh is not None else make_mesh()
        self._opt = make_optimizer(optimizer, **(optimizer_params or {}))
        # donate: accepted for the JAX package's signature; the port
        # always updates its own buffers in place
        del donate
        if dtype in ("bfloat16", "bf16", torch.bfloat16):
            self._amp_dtype = torch.bfloat16
        elif dtype in (None, "float32", "fp32", torch.float32):
            self._amp_dtype = None
        else:
            raise MXNetError("unsupported trainer dtype: %r" % (dtype,))

        self._tuned = {}

        def _knob(name, arg):
            if arg is not None:
                self._tuned[name] = {"value": arg, "source": "arg"}
                return arg
            src = "env" if os.environ.get(name) is not None else "default"
            info = {"value": _config.get(name), "source": src}
            self._tuned[name] = info
            return info["value"]

        self._zero = int(_knob("MXNET_PARALLEL_ZERO", zero))
        if self._zero not in (0, 1, 2):
            raise MXNetError("zero stage must be 0, 1 or 2; got %r"
                             % (self._zero,))
        bucket_bytes = _knob("MXNET_PARALLEL_BUCKET_BYTES", bucket_bytes)
        first_bucket_bytes = _knob("MXNET_PARALLEL_BUCKET_FIRST_BYTES",
                                   first_bucket_bytes)
        compression = _knob("MXNET_PARALLEL_COMPRESSION", compression)
        cparams = dict(compression_params or {})
        if isinstance(compression, dict):
            cparams = {**compression, **cparams}
            compression = cparams.pop("type", None)
        cparams.setdefault(
            "threshold", _config.get("MXNET_PARALLEL_COMPRESSION_THRESHOLD"))
        self._codec = make_codec(compression, **cparams)

        mesh = self._mesh
        self._n = mesh.size
        # this rank's shard of every bucket (rank 0's on a rank outside
        # the mesh, which never steps)
        self._r = mesh.rank if mesh.is_member else 0
        self._group = mesh.group
        self._device = mesh.device
        params = block.collect_params()
        self._param_names = list(params.keys())
        self._param_objs = [params[k] for k in self._param_names]
        self._trainable = {n: p.grad_req != "null"
                           for n, p in zip(self._param_names,
                                           self._param_objs)}
        # the trainer owns its copies, on this rank's device
        values = {n: p.data()._data.detach().to(self._device, copy=True)
                  for n, p in zip(self._param_names, self._param_objs)}
        self._fused_names = [n for n in self._param_names
                             if self._trainable[n]
                             and values[n].dtype == torch.float32]
        fused = set(self._fused_names)
        self._perparam_names = [n for n in self._param_names
                                if self._trainable[n] and n not in fused]
        self._plan = build_bucket_plan(
            self._fused_names, [values[n].shape for n in self._fused_names],
            bucket_bytes, first_bucket_bytes, pad_multiple=self._n)
        # one autograd leaf per bucket; the parameters are its views
        self._flats = []
        for b in self._plan:
            flat = flatten_bucket([values[n] for n in b.names], b)
            flat.requires_grad_(True)
            flat.register_post_accumulate_grad_hook(self._bucket_hook(b))
            self._flats.append(flat)
        self._others = {}
        for n in self._param_names:
            if n in fused:
                continue
            t = values[n]
            if self._trainable[n]:
                t.requires_grad_(True)
                t.register_post_accumulate_grad_hook(self._perparam_hook(n))
            self._others[n] = t
        if self._group is not None:
            # replicas start from the first rank's values, whatever each
            # rank's block held
            with torch.no_grad():
                for t in self._flats + list(self._others.values()):
                    coll.broadcast(t.detach(), mesh.ranks[0], self._group)
        self._handles = {}
        self._gshards = [None] * len(self._plan)
        self._opt_state = self._init_opt_state()
        self._resids = self._init_residuals()
        self._comm = self._comm_model()
        self._export_state_gauges()

    # -- state layout --------------------------------------------------------
    def _shard_len(self, b):
        return b.padded_n // self._n

    def _shard(self, flat, b):
        s = self._shard_len(b)
        return flat[self._r * s:(self._r + 1) * s]

    def _init_opt_state(self):
        if self._zero == 0:
            # slots follow the parameters they shadow, one per parameter
            train = {n: v for n, v in self._param_values().items()
                     if self._trainable[n]}
            return self._opt.init({n: v.detach() for n, v in train.items()})
        fused = {"b%d" % b.index: torch.zeros(self._shard_len(b),
                                             device=self._device)
                 for b in self._plan}
        perparam = {n: self._others[n].detach()
                    for n in self._perparam_names}
        return {"fused": self._opt.init(fused),
                "perparam": self._opt.init(perparam)}

    def _init_residuals(self):
        if self._codec is None or not self._plan:
            return ()
        # error-feedback residuals are elementwise state: sharded with
        # the slots under ZeRO
        return tuple(torch.zeros(self._shard_len(b) if self._zero
                                 else b.padded_n, device=self._device)
                     for b in self._plan)

    def _comm_model(self):
        sharded = [(self._others[n].numel() * self._others[n].element_size(),
                    self._n) for n in self._perparam_names]
        return coll.comm_stats(self._plan, self._n, self._zero,
                               codec=self._codec, sharded_bytes=sharded)

    def comm_stats(self):
        """The static per-step per-device collective cost of this
        configuration (ring wire model) — what the
        ``mxnet_collective_*`` counters advance by each step."""
        return copy.deepcopy(self._comm)

    def plan_spec(self):
        """This trainer's plan as plain data, the JAX package's
        ``plan_spec`` vocabulary: mesh axes, per-parameter shapes, dtype
        sizes, partition specs and flags, the ZeRO stage, the optimizer's
        slot spec, the bucket plan and the codec."""
        from ..checkpoint._plan import normalize_pspec
        fused = set(self._fused_names)
        values = self._param_values()
        params = []
        for name in self._param_names:
            v = values[name]
            params.append({
                "name": name, "shape": [int(s) for s in v.shape],
                "dtype_size": int(v.element_size()),
                "trainable": bool(self._trainable[name]),
                "spec": normalize_pspec((None,) * v.dim(), v.dim()),
                "fused": name in fused})
        opt_spec = self._opt.slot_spec()
        # the sweep runs on the ZeRO shards only (zero=0 updates per
        # parameter, as the JAX package's tree_map path); every shard is
        # contiguous, so it is safe on any mesh width
        opt_spec["fused_sweep"] = self._zero >= 1 and _fused_sweep_on(
            True, self._device)
        mesh = self._mesh
        return {
            "mesh": [[a, int(mesh.shape[a])] for a in mesh.axis_names],
            "params": params,
            "zero": self._zero,
            "optimizer": opt_spec,
            "buckets": [b.to_dict() for b in self._plan],
            "codec": ({"name": self._codec.name}
                      if self._codec is not None else None),
            "batch": {"axes": ["dp", "fsdp"]},
            "tuned_config": {k: dict(v)
                             for k, v in sorted(self._tuned.items())},
        }

    def optimizer_state_bytes(self):
        """``{"total": logical bytes, "per_device": bytes resident on this
        rank}`` over every optimizer-state leaf and compression residual:
        the ZeRO memory claim, read off the tensors this rank holds."""
        total = per_device = 0
        sharded = []
        if self._zero:
            sharded = list(_leaves({k: v for k, v in
                                    self._opt_state["fused"].items()
                                    if isinstance(v, dict)}))
            sharded += list(self._resids)
        ids = {id(t) for t in sharded}
        for leaf in list(_leaves(self._opt_state)) + list(self._resids):
            local = leaf.numel() * leaf.element_size()
            per_device += local
            total += local * (self._n if id(leaf) in ids else 1)
        return {"total": int(total), "per_device": int(per_device)}

    def _export_state_gauges(self):
        from .. import telemetry
        sb = self.optimizer_state_bytes()
        g = telemetry.gauge(
            "mxnet_parallel_optimizer_state_bytes",
            "optimizer-state footprint of the newest ParallelTrainer "
            "(scope=total logical vs per_device resident)")
        g.labels(scope="total").set(sb["total"])
        g.labels(scope="per_device").set(sb["per_device"])

    @property
    def mesh(self):
        return self._mesh

    @property
    def zero(self):
        return self._zero

    @property
    def bucket_plan(self):
        return list(self._plan)

    # -- the step ------------------------------------------------------------
    def _bucket_hook(self, b):
        def hook(flat):
            self._launch_bucket(b, flat.grad)
        return hook

    def _perparam_hook(self, name):
        def hook(t):
            if self._group is not None:
                self._handles[name] = coll.all_reduce(t.grad, self._group,
                                                      async_op=True)
        return hook

    def _launch_bucket(self, b, grad):
        """The bucket's collective, issued as soon as its gradient is
        whole: reduce-scatter into this rank's shard (zero=2) or an
        all-reduce in place."""
        if self._group is None:
            return
        if self._zero >= 2:
            out = torch.empty(self._shard_len(b), dtype=grad.dtype,
                              device=grad.device)
            self._gshards[b.index] = out
            h = coll.reduce_scatter(out, grad, self._group, async_op=True)
        else:
            h = coll.all_reduce(grad, self._group, async_op=True)
        self._handles[b.index] = h

    def _param_values(self):
        """``{name: tensor}`` of every parameter's current value (views of
        the buckets for the fused ones)."""
        out = dict(self._others)
        for b, flat in zip(self._plan, self._flats):
            out.update(unflatten_bucket(flat.detach(), b))
        return out

    def _ctx(self):
        return Context("cpu" if self._device.type == "cpu" else "gpu",
                       self._device.index or 0)

    def _forward_inputs(self, x, params):
        if self._amp_dtype is not None:
            params = {k: v.to(self._amp_dtype)
                      if v.dtype == torch.float32 else v
                      for k, v in params.items()}
            x = x.to(self._amp_dtype) if x.dtype == torch.float32 else x
        return x, params

    def _local(self, data):
        t = _as_tensor(data)
        return batch_sharded(self._mesh).local(t).to(self._device)

    def step(self, data, label):
        """One training step on the global batch ``(data, label)``;
        returns the global mean loss as a scalar NDArray (None on a rank
        outside the mesh)."""
        if not self._mesh.is_member:
            return None
        x, y = self._local(data), self._local(label)
        for flat in self._flats:
            flat.grad = None
        for n in self._perparam_names:
            self._others[n].grad = None
        self._handles = {}
        self._gshards = [None] * len(self._plan)
        params = dict(self._others)
        for b, flat in zip(self._plan, self._flats):
            params.update(zip(b.names, _BucketViews.apply(flat, b)))
        with self._ctx(), coll.global_batch_stats(self._group, self._n):
            xin, pin = self._forward_inputs(x, params)
            nds = {n: NDArray(v) for n, v in pin.items()}
            with autograd.record(train_mode=True):
                out = _apply_with_params(self._block, nds, NDArray(xin))
                if isinstance(out, (list, tuple)):
                    out = out[0]
                out = NDArray(out._data.to(torch.float32))
                loss = self._loss(out, NDArray(y))._data.mean()
            gloss = loss.detach().clone()
            gl = None if self._group is None else coll.all_reduce(
                gloss, self._group, async_op=True)
            (loss / self._n).backward()
        # the moving statistics BatchNorm wrote back
        for n in self._param_names:
            if not self._trainable[n] and nds[n]._data is not pin[n]:
                with torch.no_grad():
                    self._others[n].copy_(nds[n]._data)
        for b, flat in zip(self._plan, self._flats):
            if flat.grad is None:
                # a bucket the loss never reached still reduces (zeros)
                flat.grad = torch.zeros_like(flat)
                self._launch_bucket(b, flat.grad)
        for n in self._perparam_names:
            t = self._others[n]
            if t.grad is None:
                t.grad = torch.zeros_like(t)
                self._perparam_hook(n)(t)
        for h in self._handles.values():
            h.wait()
        self._update()
        if gl is not None:
            gl.wait()
            gloss /= self._n
        coll.record_comm(self._comm)
        return NDArray(gloss)

    def _bucket_grad(self, b, flat):
        """This rank's reduced gradient of bucket ``b``: the whole bucket
        (zero=0) or its shard, decoded through the codec with the
        residual, which advances."""
        if self._zero == 0:
            g = flat.grad
        elif self._zero == 1 or self._group is None:
            g = self._shard(flat.grad, b)
        else:
            g = self._gshards[b.index]
        if self._codec is not None:
            res = self._resids[b.index]
            g, new_res = self._codec.roundtrip(g, res)
            res.copy_(new_res)
        return g

    def _update(self):
        grads = [self._bucket_grad(b, f)
                 for b, f in zip(self._plan, self._flats)]
        if self._zero == 0:
            ps, gs = {}, {}
            for b, flat, g in zip(self._plan, self._flats, grads):
                ps.update(unflatten_bucket(flat.detach(), b))
                gs.update(unflatten_bucket(g, b))
            for n in self._perparam_names:
                ps[n] = self._others[n].detach()
                gs[n] = self._others[n].grad
            ps = {n: ps[n] for n in self._param_names if n in ps}
            _, self._opt_state = self._opt.apply(ps, gs, self._opt_state)
            return
        p_shards, g_shards = {}, {}
        for b, flat, g in zip(self._plan, self._flats, grads):
            shard = self._shard(flat.detach(), b)
            # the update writes its own copy of the shard, gathered back
            # into the replicated parameters after
            p_shards["b%d" % b.index] = shard if self._group is None \
                else shard.clone()
            g_shards["b%d" % b.index] = g
        _, self._opt_state["fused"] = self._opt.apply(
            p_shards, g_shards, self._opt_state["fused"], flat=True)
        if self._group is not None:
            hs = [coll.all_gather(flat.detach(), p_shards["b%d" % b.index],
                                  self._group, async_op=True)
                  for b, flat in zip(self._plan, self._flats)]
            for h in hs:
                h.wait()
        if self._perparam_names:
            pp = {n: self._others[n].detach() for n in self._perparam_names}
            gp = {n: self._others[n].grad for n in self._perparam_names}
            _, self._opt_state["perparam"] = self._opt.apply(
                pp, gp, self._opt_state["perparam"])

    def forward(self, data):
        """Eval forward of the global batch: each rank computes its rows,
        and the ranks' outputs are gathered in order, so every rank
        returns the global output."""
        if not self._mesh.is_member:
            return None
        x = self._local(data)
        with self._ctx(), torch.no_grad():
            xin, pin = self._forward_inputs(x, self._param_values())
            with autograd.pause(train_mode=False):
                out = _apply_with_params(
                    self._block, {n: NDArray(v) for n, v in pin.items()},
                    NDArray(xin))
            out = out[0] if isinstance(out, (list, tuple)) else out
            out = out._data.to(torch.float32).contiguous()
            if self._group is not None:
                full = out.new_empty((out.shape[0] * self._n,)
                                     + tuple(out.shape[1:]))
                coll.all_gather(full, out, self._group)
                out = full
        return NDArray(out)

    def sync_to_block(self):
        """Write the trained values back into the Gluon parameters."""
        values = self._param_values()
        for name, p in zip(self._param_names, self._param_objs):
            p.set_data(values[name])

    @property
    def params(self):
        """``{name: tensor}``: this rank's copy of every parameter."""
        return self._param_values()

    @property
    def opt_state(self):
        return self._opt_state

    # -- checkpointing (mesh-independent logical state) ----------------------
    def _gather(self, shard, b):
        """The whole padded bucket from every rank's ``shard``."""
        if self._group is None:
            return shard
        full = shard.new_empty(b.padded_n)
        coll.all_gather(full, shard.contiguous(), self._group)
        return full

    def state_dict(self):
        """Host snapshot in MESH-INDEPENDENT form (the JAX package's):
        full logical arrays, slots PER PARAMETER (ZeRO shards gathered
        from every rank and sliced back apart), so a restore may land on
        another width, ZeRO stage or bucket plan bit for bit.  Collective:
        every rank of the mesh calls it."""
        if not self._mesh.is_member:
            raise MXNetError("state_dict: this rank is outside %r"
                             % self._mesh)
        params = {n: _host(v) for n, v in self._param_values().items()}
        slots, scalars = {}, {}

        def _take(subtree, plan=None):
            # scalar slots (Adam's t) only from a subtree that holds
            # parameters: the other one's never-advanced zero must not
            # shadow the real count
            has_params = any(isinstance(v, dict) and v
                             for v in subtree.values())
            for slot, leaf in subtree.items():
                if not isinstance(leaf, dict):
                    if has_params:
                        scalars[slot] = np.asarray(_host(leaf))
                    continue
                dst = slots.setdefault(slot, {})
                if plan is None:
                    for name, t in leaf.items():
                        dst[name] = _host(t)
                    continue
                for b in plan:
                    full = self._gather(leaf["b%d" % b.index], b)
                    dst.update({n: _host(v) for n, v in
                                unflatten_bucket(full, b).items()})

        if self._zero == 0:
            _take(self._opt_state)
        else:
            _take(self._opt_state["fused"], plan=self._plan)
            _take(self._opt_state["perparam"])
        residuals = {}
        for b, res in zip(self._plan, self._resids):
            full = self._gather(res, b) if self._zero else res
            residuals.update({n: _host(v) for n, v in
                              unflatten_bucket(full, b).items()})
        return {"params": params, "slots": slots, "scalars": scalars,
                "residuals": residuals,
                "meta": {"zero": self._zero,
                         "codec": (self._codec.name
                                   if self._codec else None),
                         "optimizer": type(self._opt).__name__}}

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` snapshot into THIS trainer's
        layout: parameters copied whole, per-parameter slots re-flattened
        into this plan's buckets and this rank's shards.  Values are the
        snapshot's bit for bit."""
        params, slots = state["params"], state.get("slots", {})
        values = self._param_values()
        for n in self._param_names:
            if n not in params:
                raise MXNetError("checkpoint is missing param %r" % n)
            have = tuple(params[n].shape)
            want = tuple(values[n].shape)
            if have != want:
                raise MXNetError(
                    "checkpoint param %r has shape %s, trainer expects %s"
                    % (n, have, want))

        def _slot_names(tree):
            return sorted(k for k, v in tree.items() if isinstance(v, dict))

        if self._zero == 0:
            want_slots = _slot_names(self._opt_state)
        else:
            want_slots = sorted(set(_slot_names(self._opt_state["fused"]))
                                | set(_slot_names(
                                    self._opt_state["perparam"])))
        if sorted(slots.keys()) != want_slots:
            raise MXNetError(
                "checkpoint optimizer slots %s do not match this "
                "trainer's optimizer (%s expects %s)"
                % (sorted(slots.keys()), type(self._opt).__name__,
                   want_slots))

        def _t(a, like):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a))
            return a.to(device=like.device, dtype=like.dtype)

        with torch.no_grad():
            for n, v in values.items():
                v.copy_(_t(params[n], v).reshape(v.shape))

        def _flat(per_param, b):
            flat = np.zeros((b.padded_n,), np.float32)
            for name, off, sz in zip(b.names, b.offsets, b.sizes):
                flat[off:off + sz] = np.asarray(
                    per_param[name], np.float32).reshape(-1)
            return flat

        def _local_flat(per_param, b, like):
            flat = _t(_flat(per_param, b), like)
            return self._shard(flat, b) if self._zero else flat

        scalars = state.get("scalars", {})

        def _restore(subtree, plan=None):
            for slot, leaf in subtree.items():
                if not isinstance(leaf, dict):
                    if slot in scalars:
                        # a store gives a 0-d array back with shape (1,)
                        subtree[slot] = _t(scalars[slot], leaf).reshape(
                            leaf.shape)
                    continue
                for key, t in leaf.items():
                    if plan is None:
                        src = _t(slots[slot][key], t).reshape(t.shape)
                    else:
                        src = _local_flat(slots[slot],
                                          plan[int(key[1:])], t)
                    t.copy_(src)

        if self._zero == 0:
            _restore(self._opt_state)
        else:
            _restore(self._opt_state["fused"],
                     plan={b.index: b for b in self._plan})
            _restore(self._opt_state["perparam"])
        residuals = state.get("residuals", {})
        for b, res in zip(self._plan, self._resids):
            per = {n: residuals.get(n, np.zeros(s, np.float32))
                   for n, s in zip(b.names, b.shapes)}
            res.copy_(_local_flat(per, b, res))

    def save_checkpoint(self, manager, step=None, block=True):
        """Persist this trainer through the checkpoint subsystem: every
        rank of the mesh gathers the state, its first rank writes it
        (``manager`` is a ``CheckpointManager`` or a directory) and the
        others wait for the commit.  Returns True when the save
        committed (False on a rank outside the mesh)."""
        from ..checkpoint import CheckpointManager
        from ..checkpoint.state import ParallelTrainerState
        if not self._mesh.is_member:
            return False
        if isinstance(manager, str):
            manager = CheckpointManager(directory=manager)
        state = ParallelTrainerState.capture(self)
        ok = True
        if self._r == 0:
            ok = bool(manager.save_state(state, step=step, block=block))
        if self._group is not None:
            flag = torch.tensor([int(ok)], device=self._device)
            coll.broadcast(flag, self._mesh.ranks[0], self._group)
            ok = bool(flag.item())
        return ok

    def restore_checkpoint(self, manager, step=None):
        """Restore the newest (or ``step``'s) trainer checkpoint that
        verifies into THIS trainer's layout; returns the restored step id
        or None.  Every rank reads the store."""
        from ..checkpoint import CheckpointManager
        from ..checkpoint.state import ParallelTrainerState
        if isinstance(manager, str):
            manager = CheckpointManager(directory=manager)
        return ParallelTrainerState.restore_latest(manager.store, self,
                                                   step=step)
