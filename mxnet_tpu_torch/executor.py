"""Executor — a symbol bound to tensors on one device.

Counterpart of ``mxnet_tpu/executor.py``.  ``simple_bind`` allocates
every argument, gradient (``grad_req`` write/add/null) and aux state
from the inferred shapes; the lowered graph runs eagerly (there is no
jit).  Inference forwards run under ``torch.inference_mode``.  A
training forward of a loss graph (``_LOSS_OPS`` heads) runs forward and
backward at once, as the JAX package's fused ``fb`` program does:
autograd seeds every head with ones and the loss layers discard the
seed, so ``backward()`` only commits the cached gradients.

The fused step (``install_fused_update``, what ``Module`` installs for
``kvstore="tpu"`` on one device) folds the optimizer into
``forward(is_train=True)``.  Where the JAX package runs forward,
backward and update as one donated XLA program, this port updates in
place: at install time each bucket's weights (one bucket per
``(lr_mult, wd_mult)`` group) move into one contiguous fp32 buffer and
every ``arg_dict`` entry becomes a view of it, and each step concatenates the gradients
per bucket and launches one sweep kernel per bucket
(``cuda_kernels.sgd_mom_sweep`` and friends), which writes the weights
and the bucket-major optimizer slots in place.  The hyperparameters
live in one small fp32 device tensor, rewritten only when their values
change, by a copy from pinned memory that does not block the host.  ``MXNET_PALLAS_FUSED_OPT=0`` keeps the per-array path
(``optimizer.fused_update_kernel``), which launches no kernel and is the
oracle; a ``set_lr_mult``/``set_wd_mult`` after install demotes to it
for good, carrying the slots over bit for bit.  ``optimizer_slots`` and
``load_optimizer_slots`` read and write the slots by weight name on
either path, which is how ``Module`` saves and resumes them.

Mixed precision (``compute_dtype="bfloat16"``, the JAX package's policy,
``mxnet_tpu/executor.py``): the bound fp32 arguments stay fp32 and are the
masters; each one not named in ``cast_exclude`` (labels) is cast to the
compute dtype inside the recorded graph, in the training forward and
backward and in the eval forward, so ``backward`` hands fp32 gradients to
the fused step, which sweeps fp32 buckets as before.  Aux states
(BatchNorm's moving stats) are not cast.

Monitoring (``set_monitor_callback``, what ``Monitor.install`` calls):
after each forward the callback gets every head output by name, or with
``monitor_all`` every op node's output, handed over by the eager graph
as it computes them (``build_graph_fn``'s ``tap``), with no second
program; the JAX package runs one built from ``get_internals()``.  With
no callback installed the graph runs as before.

Telemetry (``MXNET_TELEMETRY``): each bind counts in
``mxnet_executor_binds_total``, and each forward or backward passes
through ``_dispatch``, which counts the first dispatch of each (program,
argument shapes) pair in ``mxnet_xla_compiles_total`` and its wall time
in ``mxnet_xla_compile_seconds``: the JAX executor's signature-set
fallback, since there is no jit cache here.  A new pair is where cuDNN
picks its algorithms and the kernels are built and loaded.  Disabled,
the path costs one boolean check.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import telemetry
from .base import MXNetError, dtype_torch
from .context import resolve
from .ndarray import NDArray
from .symbol.symbol import _infer_graph, build_graph_fn

__all__ = ["Executor"]


# ops whose backward defines its own head gradient (label-based), so
# backward() with no out_grads is meaningful — the reference's loss-output
# contract (SoftmaxOutput ignores head grads)
_LOSS_OPS = frozenset({
    "SoftmaxOutput", "Softmax", "MakeLoss", "make_loss",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "SVMOutput",
})


def _grad_req_dict(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return {n: grad_req.get(n, "null") for n in arg_names}


def _as_tensor(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v))


class Executor:
    """A bound computation (reference: python/mxnet/executor.py:45)."""

    def __init__(self, symbol, device, arg_dict, aux_dict, grad_dict=None,
                 grad_req="null", compute_dtype=None, cast_exclude=()):
        self._symbol = symbol
        self._device = device
        self._compute_dtype = (dtype_torch(compute_dtype)
                               if compute_dtype is not None else None)
        self._cast_exclude = frozenset(cast_exclude)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = arg_dict
        self.aux_dict = aux_dict
        self.grad_dict = grad_dict or {}
        self._grad_req = _grad_req_dict(grad_req, self.arg_names)
        for n, r in self._grad_req.items():
            if r not in ("null", "write", "add"):
                raise MXNetError("grad_req of %r must be null, write or add, "
                                 "got %r" % (n, r))
        # only args that have a gradient buffer get gradients
        self._diff_idx = [i for i, n in enumerate(self.arg_names)
                          if self._grad_req[n] != "null"
                          and self.grad_dict.get(n) is not None]
        self._is_loss_graph = bool(symbol._flat_outputs()) and all(
            (not n.is_variable) and n.op.name in _LOSS_OPS
            for (n, _i) in symbol._flat_outputs())
        # arguments the mixed-precision policy casts at graph entry
        self._cast_idx = frozenset(
            i for i, n in enumerate(self.arg_names)
            if self._compute_dtype is not None
            and n not in self._cast_exclude)
        self._outputs = None
        self._cached_grads = None
        self._monitor_callback = None
        self._monitor_all = False
        self._fn = build_graph_fn(symbol, self.arg_names, self.aux_names,
                                  device)
        self._fn_train = None
        # fused optimizer step (install_fused_update)
        self._fused_update = None   # (optimizer, init_state, one)
        self._fused_codec = None    # gradient-compression codec, or None
        self._fused_resids = None   # its error-feedback residuals
        self._fused_state = None    # slots: per bucket, or per diff arg
        self._sweep = None          # bucket plan, or None (per-array)
        self._hyper = None          # (host values, device tensor)
        self._updates_applied = False
        # (program tag, argument shapes) pairs dispatched so far
        self._compile_seen = set()
        if telemetry.enabled():
            telemetry.counter(
                "mxnet_executor_binds_total",
                "executor binds (each bind's first dispatch per shape "
                "picks its cuDNN algorithms)").inc()

    @property
    def device(self):
        return self._device

    def _cast(self, args):
        """The graph's view of the arguments: each fp32 one in
        ``_cast_idx`` cast to the compute dtype (differentiably, so a
        gradient comes back fp32), the rest as bound."""
        if self._compute_dtype is None:
            return args
        return [a.to(self._compute_dtype)
                if i in self._cast_idx and a.dtype == torch.float32 else a
                for i, a in enumerate(args)]

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     compute_dtype=None, cast_exclude=(), shared_exec=None):
        device = resolve(ctx)
        known = {k: tuple(v) for k, v in shape_kwargs.items()}
        shapes, aux_shapes = _infer_graph(symbol, known)
        type_dict = type_dict or {}

        def alloc(name, shp, what, shared, dtype=None):
            if shp is None:
                raise MXNetError("simple_bind could not infer the %s shape "
                                 "of %r" % (what, name))
            if shared is not None and name in shared \
                    and shared[name].shape == tuple(shp):
                return shared[name]
            return NDArray(torch.zeros(
                shp, dtype=dtype_torch(dtype), device=device))

        shared_args = None if shared_exec is None else shared_exec.arg_dict
        shared_aux = None if shared_exec is None else shared_exec.aux_dict
        arg_names = symbol.list_arguments()
        arg_dict = {n: alloc(n, shapes.get(n), "argument", shared_args,
                             type_dict.get(n))
                    for n in arg_names}
        req = _grad_req_dict(grad_req, arg_names)
        grad_dict = {n: NDArray(torch.zeros_like(arg_dict[n]._data))
                     for n in arg_names if req.get(n, "null") != "null"}
        aux_dict = {n: alloc(n, aux_shapes.get(n), "aux", shared_aux)
                    for n in symbol.list_auxiliary_states()}
        return Executor(symbol, device, arg_dict, aux_dict, grad_dict,
                        grad_req, compute_dtype, cast_exclude)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states,
              compute_dtype=None, cast_exclude=()):
        """``Symbol.bind``: the given NDArrays (lists in argument order or
        dicts), used as they are; aux states not given start at zeros of
        their inferred shapes on ``ctx`` (default the current context)."""
        device = resolve(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def as_dict(v, names):
            if v is None:
                return {}
            return dict(v) if isinstance(v, dict) else dict(zip(names, v))

        arg_dict = as_dict(args, arg_names)
        missing = [n for n in arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        grad_dict = as_dict(args_grad, arg_names)
        aux_dict = as_dict(aux_states, aux_names)
        if any(n not in aux_dict for n in aux_names):
            _, aux_shapes = _infer_graph(
                symbol, {m: arg_dict[m].shape for m in arg_names})
            for a in aux_names:
                if a not in aux_dict:
                    aux_dict[a] = NDArray(torch.zeros(aux_shapes[a],
                                                      device=device))
        return Executor(symbol, device, arg_dict, aux_dict, grad_dict,
                        grad_req, compute_dtype, cast_exclude)

    # -- fused optimizer step ------------------------------------------------
    def install_fused_update(self, optimizer, param_names=None,
                             compression_params=None):
        """Fold ``optimizer`` into ``forward(is_train=True)`` (see the
        module docstring).  ``backward()`` then commits nothing and
        ``grad_dict`` is not filled; ``updates_applied`` tells
        ``Module.update`` to skip the kvstore.  Returns False, installing
        nothing, for an optimizer without a fused form, a graph that is
        not a loss graph, or when some differentiable argument is not in
        ``param_names`` (data inputs are never updated).

        ``compression_params`` (``Module(compression_params=...)``, the
        kvstore's ``set_gradient_compression`` dict) runs the shared codec
        on each gradient inside the step, with an error-feedback residual
        per weight, as the kvstore push path does."""
        from . import optimizer as opt_mod
        from .gradient_compression import make_codec
        kernel = opt_mod.fused_update_kernel(optimizer)
        if kernel is None or not self._diff_idx or not self._is_loss_graph:
            return False
        if param_names is not None:
            allowed = set(param_names)
            if any(self.arg_names[i] not in allowed for i in self._diff_idx):
                return False
        self._fused_update = (optimizer, kernel[0], kernel[1])
        self._fused_codec = make_codec(**dict(compression_params)) \
            if compression_params else None
        self._fused_resids = None
        self._fused_state = None
        self._hyper = None
        self._updates_applied = False
        self._sweep = self._plan_sweep(optimizer)
        if self._sweep is None:
            # own the weights: a kvstore pull may have aliased them
            for i in self._diff_idx:
                nd = self.arg_dict[self.arg_names[i]]
                nd._data = nd._data.clone()
            return True
        from .parallel.collectives import flatten_bucket, unflatten_bucket
        self._sweep["flats"] = []
        for b, _idxs in self._sweep["plan"]:
            flat = flatten_bucket([self.arg_dict[n]._data for n in b.names],
                                  b)
            for name, view in unflatten_bucket(flat, b).items():
                self.arg_dict[name]._data = view
            self._sweep["flats"].append(flat)
        return True

    def _plan_sweep(self, optimizer):
        """The bucket plan of the one-sweep step, or None for the
        per-array path: ``MXNET_PALLAS_FUSED_OPT`` off for this device,
        an optimizer other than SGD/Adam, or a weight that is not fp32.
        Weights are grouped by their static ``(lr_mult, wd_mult)`` so
        every member of a bucket shares one effective (lr, wd) at every
        step; MXNet's zero weight decay on biases and betas makes two
        groups the common case."""
        from .ops.cuda_kernels import family_enabled
        from .parallel.collectives import build_bucket_plan
        if not family_enabled("MXNET_PALLAS_FUSED_OPT", self._device):
            return None
        kind = type(optimizer).__name__
        if kind not in ("SGD", "Adam"):
            return None
        names = [self.arg_names[i] for i in self._diff_idx]
        if any(self.arg_dict[n]._data.dtype != torch.float32 for n in names):
            return None
        groups = {}
        for j, n in enumerate(names):
            key = (float(optimizer._param_mult(n, optimizer.lr_mult,
                                               "lr_mult")),
                   float(optimizer._param_mult(n, optimizer.wd_mult,
                                               "wd_mult")))
            groups.setdefault(key, []).append(j)
        plan = []
        for key in sorted(groups):
            idxs = groups[key]
            buckets = build_bucket_plan(
                [names[j] for j in idxs],
                [self.arg_dict[names[j]].shape for j in idxs],
                0, pad_multiple=1)
            pos = {names[j]: j for j in idxs}
            for b in buckets:
                plan.append((b, [pos[n] for n in b.names]))
        # optimizer_ops treats any NEGATIVE clip as "disabled"
        clip = optimizer.clip_gradient
        if clip is not None and clip < 0:
            clip = None
        info = {"kind": kind.lower(), "plan": plan,
                "rescale": float(optimizer.rescale_grad), "clip": clip}
        if kind == "SGD":
            info["momentum"] = float(optimizer.momentum)
            info["kernel"] = "sgd_mom_sweep" if info["momentum"] != 0.0 \
                else "sgd_sweep"
        else:
            info.update(beta1=float(optimizer.beta1),
                        beta2=float(optimizer.beta2),
                        epsilon=float(optimizer.epsilon),
                        kernel="adam_sweep")
        return info

    @property
    def updates_applied(self):
        return self._updates_applied

    def _sweep_hyper(self, lr, wd):
        """One bucket's hyperparameter vector, in the kernel's order, as
        Python floats (``1 - beta`` in double, as the JAX package)."""
        sw = self._sweep
        if sw["kernel"] == "sgd_sweep":
            h = [lr, wd, sw["rescale"]]
        elif sw["kernel"] == "sgd_mom_sweep":
            h = [lr, sw["momentum"], wd, sw["rescale"]]
        else:
            h = [lr, sw["beta1"], sw["beta2"], 1.0 - sw["beta1"],
                 1.0 - sw["beta2"], sw["epsilon"], wd, sw["rescale"]]
        return h + ([sw["clip"]] if sw["clip"] is not None else [])

    def _sweep_init_state(self):
        """Bucket-major optimizer slots (zeros)."""
        sw = self._sweep
        n_slots = {"sgd_sweep": 0, "sgd_mom_sweep": 1, "adam_sweep": 2}[
            sw["kernel"]]
        return [tuple(torch.zeros(b.n, dtype=torch.float32,
                                  device=self._device)
                      for _ in range(n_slots))
                for b, _idxs in sw["plan"]]

    def _sweep_update(self, grads, hyper):
        """One kernel launch per bucket: the bucket's gradients
        concatenated in its order, then the sweep writes the bucket's
        weights (which ``arg_dict`` views) and slots in place."""
        from .ops import cuda_kernels as ck
        sw = self._sweep
        fn = getattr(ck, sw["kernel"])
        use_clip = sw["clip"] is not None
        for bi, (_b, idxs) in enumerate(sw["plan"]):
            gf = torch.cat([grads[j].reshape(-1) for j in idxs])
            fn(sw["flats"][bi], gf, *self._fused_state[bi], hyper[bi],
               use_clip=use_clip)

    def _demote_sweep(self):
        """Fall back from the sweep to the per-array path for good (a
        multiplier changed after install, so a bucket's members no longer
        share one lr/wd): the bucket-major slots are sliced into
        per-weight views, values unchanged; the weights stay where they
        are until the per-array path replaces them."""
        if self._fused_state is not None:
            slots = self.optimizer_slots()
            self._fused_state = [slots[self.arg_names[i]]
                                 for i in self._diff_idx]
        self._sweep = None
        self._hyper = None

    def optimizer_slots(self):
        """``{weight name: tuple of slot tensors}`` of the fused step
        (views of the bucket-major slots on the sweep; SGD's momentum,
        Adam's mean and variance), ``{}`` before its first step."""
        from .parallel.collectives import unflatten_bucket
        if self._fused_state is None:
            return {}
        names = [self.arg_names[i] for i in self._diff_idx]
        if self._sweep is None:
            return dict(zip(names, self._fused_state))
        out = {}
        for bi, (b, _idxs) in enumerate(self._sweep["plan"]):
            views = [unflatten_bucket(s, b) for s in self._fused_state[bi]]
            out.update((n, tuple(v[n] for v in views)) for n in b.names)
        return out

    def load_optimizer_slots(self, slots):
        """Set the fused step's slots from ``{weight name: tuple of
        tensors}`` (any device): on the sweep they are copied into their
        buckets, on the per-array path they become its slots; a weight
        without an entry starts from zeros, as before a first step."""
        _, init_state, _ = self._fused_update
        names = [self.arg_names[i] for i in self._diff_idx]
        if self._sweep is not None:
            self._fused_state = self._sweep_init_state()
            zeros = self.optimizer_slots()
        else:
            zeros = {n: init_state(self.arg_dict[n]._data) for n in names}
        for n in names:
            given = slots.get(n)
            if given is not None and len(given) != len(zeros[n]):
                raise MXNetError(
                    "optimizer state of %r has %d slots; this optimizer "
                    "keeps %d" % (n, len(given), len(zeros[n])))
            for dst, src in zip(zeros[n], given or ()):
                dst.copy_(src.reshape(dst.shape))
        if self._sweep is None:
            self._fused_state = [zeros[n] for n in names]

    def _device_hyper(self, host):
        """The device copy of the hyperparameter table ``host`` (a float32
        numpy array), rewritten only when a value changed (Adam's bias
        correction changes it every step, a schedule on its steps).  On
        the GPU the new values go through pinned host memory and a
        non-blocking copy queued on the current stream behind the work
        already launched, so the host does not wait for the device; the
        caching host allocator keeps the pinned block until its copy has
        run."""
        if self._hyper is not None and self._hyper[0].shape == host.shape:
            if np.array_equal(self._hyper[0], host):
                return self._hyper[1]
            dev = self._hyper[1]
        else:
            dev = torch.empty(host.shape, dtype=torch.float32,
                              device=self._device)
        src = torch.from_numpy(host)
        if dev.is_cuda:
            src = src.pin_memory()
        dev.copy_(src, non_blocking=dev.is_cuda)
        self._hyper = (host, dev)
        return dev

    def _forward_fused(self, args, aux):
        from . import optimizer as opt_mod
        optimizer, init_state, one = self._fused_update
        lrs, wds = [], []
        for i in self._diff_idx:
            lr, wd = opt_mod.fused_lr_wd(optimizer, self.arg_names[i])
            lrs.append(lr)
            wds.append(wd)
        sweep = self._sweep
        if sweep is not None and any(
                lrs[j] != lrs[idxs[0]] or wds[j] != wds[idxs[0]]
                for _b, idxs in sweep["plan"] for j in idxs):
            self._demote_sweep()
            sweep = None
        if self._fused_state is None:
            self._fused_state = (
                self._sweep_init_state() if sweep is not None
                else [init_state(args[i]) for i in self._diff_idx])
        if sweep is not None:
            hyper = self._device_hyper(np.asarray(
                [self._sweep_hyper(lrs[idxs[0]], wds[idxs[0]])
                 for _b, idxs in sweep["plan"]], np.float32))
        else:
            hyper = self._device_hyper(np.asarray([lrs, wds], np.float32))
        outs, grads, new_aux = self._fb(args, aux, tap=self._tap())
        codec = self._fused_codec
        if codec is not None:
            if self._fused_resids is None:
                self._fused_resids = [torch.zeros(
                    g.shape, dtype=torch.float32, device=g.device)
                    for g in grads]
            decoded = []
            for g, res in zip(grads, self._fused_resids):
                d, nr = codec.roundtrip(g.to(torch.float32), res)
                res.copy_(nr)
                decoded.append(d.to(g.dtype))
            grads = decoded
        if sweep is not None:
            self._sweep_update(grads, hyper)
        else:
            new_states = []
            for j, i in enumerate(self._diff_idx):
                nw, nst = one(args[i], grads[j], self._fused_state[j],
                              hyper[0, j], hyper[1, j])
                self.arg_dict[self.arg_names[i]]._data = nw
                new_states.append(nst)
            self._fused_state = new_states
        self._cached_grads = None
        self._updates_applied = True
        return outs, new_aux

    # -- execution ----------------------------------------------------------
    def _dispatch(self, tag, args, run):
        """``run()``, counting the first dispatch of ``(tag, shapes of
        args)`` as a compile while telemetry is on."""
        if not telemetry.enabled():
            return run()
        sig = (tag, tuple(tuple(a.shape) for a in args))
        first = sig not in self._compile_seen
        t0 = time.perf_counter()
        out = run()
        if first:
            self._compile_seen.add(sig)
            telemetry.counter(
                "mxnet_xla_compiles_total",
                "first dispatches of an executor's (program, argument "
                "shapes) pair (the port has no jit: where the JAX "
                "package compiles, cuDNN picks algorithms and kernels "
                "load)").inc()
            telemetry.histogram(
                "mxnet_xla_compile_seconds",
                "host wall time of those first dispatches",
                buckets=telemetry.exponential_buckets(0.001, 4.0, 12)
            ).observe(time.perf_counter() - t0)
        return out

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("run forward() first")
        return self._outputs

    def _train_fn(self):
        if self._fn_train is None:
            self._fn_train = build_graph_fn(self._symbol, self.arg_names,
                                            self.aux_names, self._device,
                                            is_train=True)
        return self._fn_train

    def _fb(self, args, aux, seeds=None, tap=None):
        """Training forward and backward: the differentiable arguments as
        fresh autograd leaves, the heads seeded with ``seeds`` (ones by
        default), each node's output handed to ``tap`` if given.  An
        argument the graph does not use (a ``fix_gamma`` gamma) gets an
        exact zero gradient.  Returns ``(outputs,
        gradients in _diff_idx order, new aux)``."""
        leaves = [args[i].detach().requires_grad_() for i in self._diff_idx]
        full = list(args)
        for j, i in enumerate(self._diff_idx):
            full[i] = leaves[j]
        with torch.enable_grad():
            outs, new_aux = self._train_fn()(self._cast(full), aux,
                                             tap=tap)
            if seeds is None:
                seeds = [torch.ones_like(o) for o in outs]
            live = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
            if live:
                grads = torch.autograd.grad(
                    [o for o, _ in live], leaves,
                    grad_outputs=[s for _, s in live], allow_unused=True,
                    materialize_grads=True)
            else:
                grads = [torch.zeros_like(x) for x in leaves]
        return [o.detach() for o in outs], list(grads), new_aux

    def forward(self, is_train=False, **kwargs):
        """Run the graph (reference: executor.py:113).  Keyword feeds
        (NDArrays, tensors or host arrays) replace the named arguments;
        a host array is copied to the device here, once.  With
        ``is_train`` BatchNorm uses the batch's statistics and writes its
        moving stats back; a loss graph with gradients also runs its
        backward now (and, after ``install_fused_update``, the optimizer
        step)."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            tgt = self.arg_dict[k]
            v = _as_tensor(v)
            if tuple(v.shape) != tgt.shape:
                raise MXNetError("forward argument %r has shape %s, bound "
                                 "as %s" % (k, tuple(v.shape), tgt.shape))
            tgt._data = v.to(device=self._device, dtype=tgt._data.dtype)
        args = [self.arg_dict[n]._data for n in self.arg_names]
        aux = [self.aux_dict[n]._data for n in self.aux_names]
        new_aux = None
        if is_train and self._fused_update is not None:
            outs, new_aux = self._dispatch(
                "fbu", args, lambda: self._forward_fused(args, aux))
        elif is_train and self._diff_idx and self._is_loss_graph:
            outs, self._cached_grads, new_aux = self._dispatch(
                "fb", args, lambda: self._fb(args, aux, tap=self._tap()))
            self._updates_applied = False
        elif is_train:
            def fwd_train():
                with torch.no_grad():
                    return self._train_fn()(self._cast(args), aux,
                                            tap=self._tap())
            outs, new_aux = self._dispatch("fwd_train", args, fwd_train)
            self._cached_grads = None
        else:
            def fwd_eval():
                with torch.inference_mode():
                    return self._fn(self._cast(args), aux, tap=self._tap())
            outs = self._dispatch("fwd_eval", args, fwd_eval)
            self._cached_grads = None
        if new_aux is not None:
            for n, a in zip(self.aux_names, new_aux):
                self.aux_dict[n]._data = a
        self._outputs = [NDArray(o) for o in outs]
        if self._monitor_callback is not None and not self._monitor_all:
            for name, o in zip(self.output_names, self._outputs):
                self._monitor_callback(name, o)
        return self._outputs

    def set_monitor_callback(self, callback, monitor_all=False):
        """Hand ``callback(name, NDArray)`` the head outputs after each
        forward, or with ``monitor_all`` every op node's output as the
        graph computes it (reference: graph_executor.cc:121,1444).
        ``None`` removes it."""
        self._monitor_callback = callback
        self._monitor_all = bool(monitor_all)

    def _tap(self):
        """The graph's tap for ``monitor_all``, else None."""
        cb = self._monitor_callback
        if cb is None or not self._monitor_all:
            return None
        return lambda name, t: cb(name, NDArray(t))

    def backward(self, out_grads=None, is_train=True):
        """Reference: executor.py:154.  With no ``out_grads`` the
        gradients of the preceding training forward are committed
        (``grad_req`` write replaces, add accumulates); with
        ``out_grads`` the graph runs again from the current arguments,
        seeded with them."""
        if not self._diff_idx:
            return
        if out_grads is None and self._updates_applied:
            return      # the fused step consumed the gradients
        if out_grads is not None:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            seeds = [_as_tensor(g).to(self._device) for g in out_grads]
            args = [self.arg_dict[n]._data for n in self.arg_names]
            aux = [self.aux_dict[n]._data for n in self.aux_names]
            _, grads, _ = self._dispatch(
                "fb", args, lambda: self._fb(args, aux, seeds))
        else:
            if self._cached_grads is None:
                raise MXNetError(
                    "backward() without out_grads needs a loss-output "
                    "graph and a preceding forward(is_train=True)")
            grads = self._cached_grads
        for j, i in enumerate(self._diff_idx):
            n = self.arg_names[i]
            g = self.grad_dict[n]
            if self._grad_req[n] == "add":
                g._data = g._data + grads[j]
            else:
                g._data = grads[j].to(g._data.dtype)

    # -- reference API surface ----------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values in (reference: executor.py
        copy_params_from).  The copy writes into the bound tensors, so a
        weight that is a view of a fused-step bucket stays one."""
        for params, slots, what in ((arg_params, self.arg_dict, "parameter"),
                                    (aux_params or {}, self.aux_dict,
                                     "aux state")):
            for k, v in params.items():
                if k not in slots:
                    if not allow_extra_params:
                        raise MXNetError("unknown %s %r" % (what, k))
                    continue
                if tuple(v.shape) != slots[k].shape:
                    raise MXNetError("shape mismatch for %s %r: %s vs "
                                     "executor %s" % (what, k, v.shape,
                                                      slots[k].shape))
                slots[k]._data.copy_(_as_tensor(v))
