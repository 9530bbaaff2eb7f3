"""What of the JAX package's public API the port holds, module by module:
for each module below, the JAX package's public names minus the port's
equal ``DEFERRED``, the names left for later, keyed by the ROADMAP.md
queue that owns them (and the JAX package's internals that the port has
no counterpart of, by design).  Each later slice shrinks DEFERRED.  The
modules of the training-loop API import neither JAX nor the JAX package.
For every class both packages export from a module below, the JAX
class's public members (``dir()``) minus the port's equal
``DEFERRED_MEMBERS``, keyed the same way.  The port's public callables
(functions, classes' constructors and methods) take the JAX package's
parameter names, but for the gaps of ``DEFERRED_PARAMS``, keyed by the
queue that owns them.

A module's public names: its names without a leading underscore that it
defines, lists in ``__all__`` or holds as a submodule (for a package,
anything defined inside the package); at the top level, every name but
modules from outside the package.  A name that a module lists in
``__all__`` and resolves only through its module ``__getattr__`` (a
lazy export, such as ``fault``'s elastic runtime) counts too, in both
packages.
"""
import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import pytest

import mxnet_tpu  # noqa: F401
import mxnet_tpu_torch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ("", "optimizer", "metric", "initializer", "lr_scheduler",
           "callback", "engine", "config", "autograd", "random", "name",
           "io", "model", "kvstore", "module", "gluon", "gluon.nn",
           "gluon.loss", "gluon.utils", "gluon.data", "gluon.data.vision",
           "gluon.data.vision.transforms", "gluon.model_zoo",
           "gluon.model_zoo.vision", "gluon.model_zoo.model_store",
           "serving", "telemetry", "telemetry.tracing", "profiler",
           "gluon.rnn", "gluon.contrib", "gluon.contrib.rnn",
           "checkpoint", "fault", "compile_cache", "serving.generate",
           "gluon.contrib.transformer", "parallel", "base", "ndarray",
           "symbol", "executor", "predictor", "image", "recordio", "rnn",
           "ndarray.sparse")

DEFERRED = {
    # queue 1 item 8: the long tail (the detection, sampling and CTC ops)
    "queue 1 item 8": {
        "gluon.loss": {"CTCLoss"},
        "": {"CustomOp", "CustomOpProp", "operator", "contrib", "rtc",
             "test_utils", "th", "torch"},
        "ndarray": {"Custom", "BilinearSampler", "CTCLoss",
                    "ctc_loss", "Correlation", "GridGenerator",
                    "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
                    "Proposal", "ROIPooling", "SpatialTransformer"},
        "symbol": {"BilinearSampler", "CTCLoss", "ctc_loss", "Correlation",
                   "GridGenerator", "MultiBoxDetection", "MultiBoxPrior",
                   "MultiBoxTarget", "Proposal", "ROIPooling",
                   "SpatialTransformer"},
    },
    # queue 1 item 9: tuning and analysis
    "queue 1 item 9": {
        "config": {"tuned_info"},
        "": {"analysis"},
    },
    # the JAX package's own machinery, with no counterpart by design: its
    # tape of jax.vjp closures (the port records with torch's autograd)
    # and its threefry key chain (the port draws from torch generators)
    "JAX internals": {
        "autograd": {"record_entry"},
        "random": {"next_key", "next_key_data", "trace_key_scope"},
    },
}

# the public members of the classes both packages export that the port's
# class lacks, by the queue that owns them: {owner: {module: {class:
# members}}}.  A member is any public name of ``dir()`` (methods,
# properties, attributes of the class, inherited ones too)
DEFERRED_MEMBERS = {
    # queue 1 item 9: tuning and the analysis of compiled programs
    "queue 1 item 9": {
        "config": {"EnvVar": {"tunable"}},
        "serving": {"ModelServer": {"plan_spec"}},
        "": {"Executor": {"program_plan", "step_callable"}},
        "executor": {"Executor": {"program_plan", "step_callable"}},
        "parallel": {"ParallelTrainer": {"step_callable"}},
    },
    # the JAX package's own machinery
    "JAX internals": {
        "": {"Context": {"jax_device"}},
    },
}

# the names the last nine slices ported, none of which may be deferred:
# the training-loop API, the data pipeline and the module family,
# gluon's image path, telemetry, the profiler and gluon's recurrent
# layers, the train-to-serve loop, generative serving and the elastic
# fit, then data-parallel training across GPUs, then its asynchronous and
# multi-process rest, then sparse storage
PORTED = {
    "ndarray": {"CSRNDArray", "RowSparseNDArray", "sparse", "sparse_array",
                "cast_storage", "sparse_retain", "square_sum", "dot"},
    "ndarray.sparse": {"BaseSparseNDArray", "RowSparseNDArray",
                       "CSRNDArray", "cast_storage", "retain", "zeros",
                       "empty", "array", "sparse_array", "csr_matrix",
                       "row_sparse_array", "dot"},
    "symbol": {"cast_storage", "sparse_retain", "square_sum"},
    "parallel": {"InboxFull", "Message", "SpoolTransport", "transport",
                 "ring_attention", "ulysses_attention", "pipeline_apply",
                 "stack_stages", "switch_moe", "stack_experts", "pipeline",
                 "moe", "ParallelTrainer", "PureSGD", "PureAdam", "make_optimizer",
                 "pure_block_apply", "make_mesh", "current_mesh",
                 "mesh_scope", "replicated", "batch_sharded",
                 "init_distributed", "rank", "num_workers",
                 "is_initialized", "local_attention", "collectives",
                 "distributed", "mesh", "optimizer", "trainer",
                 "attention"},
    "kvstore": {"KVStoreDist", "KVStoreDistAsync", "is_worker_node",
                "is_server_node", "is_scheduler_node"},
    "serving.generate": {"DecodeScheduler", "DecodeState",
                         "GenerativeModel", "TokenStream", "kv_cache",
                         "model", "scheduler", "stream"},
    "gluon.contrib.transformer": {"cached_attention_step",
                                  "causal_attention", "TransformerLM",
                                  "MultiHeadAttention",
                                  "TransformerEncoderCell"},
    "checkpoint": {"AsyncCheckpointer", "CheckpointError",
                   "CheckpointManager", "CheckpointStore", "IntegrityError",
                   "RetentionPolicy", "TrainState", "capture_iter_state",
                   "default_manager", "restore_iter_state",
                   "sigterm_flag_scope", "write_checkpoint",
                   "ParallelTrainerState", "check_restore_compat",
                   "compat", "state_plan_spec"},
    "fault": {"BackoffPolicy", "FaultPlan", "FaultInjected", "Reorder",
              "install", "uninstall", "installed", "active_plan", "hooks",
              "elastic", "ElasticError", "ElasticSupervisor",
              "ProcessSupervisor", "run_elastic"},
    "compile_cache": {"ensure_initialized", "configure", "enabled",
                      "cache_dir", "stats", "sweep", "reset"},
    "serving": {"FleetFrontDoor", "ReplicaHandle", "decode_error",
                "encode_error", "fleet", "local_replica", "replica_loop",
                "spawn_replica",
                "CanaryState", "CheckpointWatcher", "WarmupManifest",
                "canary", "manifest", "DecodeScheduler", "DecodeState",
                "GenerativeModel", "TokenStream", "generate",
                "seq_buckets", "prefill_grid", "pick_grid_bucket"},
    "gluon": {"Constant", "SymbolBlock", "clip_global_norm", "data",
              "model_zoo", "split_and_load", "split_data", "utils", "rnn",
              "contrib"},
    "gluon.rnn": {"RNN", "LSTM", "GRU", "RecurrentCell",
                  "HybridRecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
                  "SequentialRNNCell", "DropoutCell", "ModifierCell",
                  "ZoneoutCell", "ResidualCell", "BidirectionalCell"},
    "gluon.contrib": {"rnn", "transformer"},
    "gluon.contrib.rnn": {"VariationalDropoutCell", "Conv2DLSTMCell"},
    "telemetry": {"Counter", "Gauge", "Histogram", "MetricFamily",
                  "MetricsRegistry", "StepLogger", "snapshot",
                  "prometheus_text", "write_prometheus",
                  "validate_exposition", "enabled", "enable", "disable",
                  "publish_to_profiler", "chrome_counter_events",
                  "tracing", "flight"},
    "telemetry.tracing": {"TraceContext", "Span", "span", "start_span",
                          "inject", "extract", "keep", "export_jsonl",
                          "chrome_events", "mark", "enable"},
    "profiler": {"set_config", "set_state", "pause", "resume", "dump",
                 "dumps", "Domain", "Task", "Frame", "Event", "Counter",
                 "Marker", "scope"},
    "gluon.nn": {"AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
                 "Conv1D", "Conv1DTranspose", "Conv2D", "Conv2DTranspose",
                 "Conv3D", "Conv3DTranspose", "ELU", "Flatten",
                 "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
                 "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
                 "HybridLambda", "InstanceNorm", "Lambda", "LeakyReLU",
                 "MaxPool1D", "MaxPool2D", "MaxPool3D", "PReLU",
                 "ReflectionPad2D", "SELU", "Swish", "conv_layers"},
    "gluon.loss": {"HingeLoss", "HuberLoss", "KLDivLoss", "LogisticLoss",
                   "SigmoidBCELoss", "SigmoidBinaryCrossEntropyLoss",
                   "SquaredHingeLoss", "TripletLoss"},
    "gluon.data": {"Dataset", "SimpleDataset", "ArrayDataset",
                   "RecordFileDataset", "Sampler", "SequentialSampler",
                   "RandomSampler", "BatchSampler", "DataLoader", "vision"},
    "gluon.model_zoo.vision": {"get_model", "resnet50_v1", "ResNetV1",
                               "mobilenet_v2_0_25", "inception_v3"},
    "io": {"LibSVMIter", "ResizeIter", "PrefetchingIter", "MNISTIter",
           "CSVIter",
           "ImageRecordIter", "ImageDetRecordIter", "MXDataIter"},
    "model": {"FeedForward"},
    "module": {"BucketingModule", "SequentialModule", "PythonModule",
               "PythonLossModule", "DataParallelExecutorGroup",
               "bucketing_module", "sequential_module", "python_module"},
    "optimizer": {"ccSGD", "Signum", "FTML", "LBSGD", "DCASGD", "NAG",
                  "SGLD", "Test", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
                  "Adamax", "Nadam"},
    "metric": {"F1", "Perplexity", "MAE", "MSE", "RMSE",
               "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
               "Torch", "Caffe", "CustomMetric", "np"},
    "initializer": {"Constant", "Orthogonal", "MSRAPrelu", "Bilinear",
                    "LSTMBias", "FusedRNN", "Load", "Mixed"},
    "lr_scheduler": {"PolyScheduler"},
    "callback": {"log_train_metric", "ProgressBar",
                 "LogValidationMetricsCallback"},
    "engine": {"naive", "naive_scope_active", "bulk", "set_bulk_size",
               "record_exception", "check_raise", "clear_exception",
               "consume_exception"},
    "config": {"list_env", "check_unknown"},
    "autograd": {"get_symbol"},
    "random": {"get_state", "set_state"},
    "name": {"Prefix"},
    "": {"kvstore_server",
         "Symbol", "Optimizer", "NameManager", "Prefix", "num_tpus",
         "__version__", "Monitor", "monitor", "viz", "visualization",
         "misc", "registry", "log", "libinfo", "recordio", "image", "rnn",
         "executor_manager", "telemetry", "profiler", "checkpoint",
         "fault", "compile_cache", "gradient_compression"},
}

# parameters of the JAX package's public callables that the port's lack,
# by the queue that owns them: {queue: {(module, callable): missing
# names}}; "order" marks parameters both take in another order
DEFERRED_PARAMS = {
    # queue 1 item 9: the tuning database
    "queue 1 item 9": {
        ("config", "register_env"): {"tunable"},
        ("config", "EnvVar.__init__"): {"tunable"},
        ("config", "tuned"): {"program", "mesh_shape", "backend"},
    },
    # an Executor is built only by bind and simple_bind, in both packages:
    # its constructor takes a device where the JAX one takes ctx, and its
    # dicts in another order
    "built only by bind": {
        ("", "Executor.__init__"): {"ctx", "order"},
        ("executor", "Executor.__init__"): {"ctx", "order"},
    },
}

# the port's modules that the last nine slices added or extended
NEW_MODULES = ("mxnet_tpu_torch.optimizer", "mxnet_tpu_torch.metric",
               "mxnet_tpu_torch.initializer", "mxnet_tpu_torch.lr_scheduler",
               "mxnet_tpu_torch.callback", "mxnet_tpu_torch.engine",
               "mxnet_tpu_torch.config", "mxnet_tpu_torch.autograd",
               "mxnet_tpu_torch.random", "mxnet_tpu_torch.name",
               "mxnet_tpu_torch.monitor", "mxnet_tpu_torch.visualization",
               "mxnet_tpu_torch.misc", "mxnet_tpu_torch.registry",
               "mxnet_tpu_torch.log", "mxnet_tpu_torch.libinfo",
               "mxnet_tpu_torch.executor", "mxnet_tpu_torch.module",
               "mxnet_tpu_torch.io", "mxnet_tpu_torch.recordio",
               "mxnet_tpu_torch.image", "mxnet_tpu_torch.rnn",
               "mxnet_tpu_torch.model", "mxnet_tpu_torch.executor_manager",
               "mxnet_tpu_torch.module.bucketing_module",
               "mxnet_tpu_torch.module.sequential_module",
               "mxnet_tpu_torch.module.python_module",
               "mxnet_tpu_torch.gluon", "mxnet_tpu_torch.gluon.block",
               "mxnet_tpu_torch.gluon.parameter", "mxnet_tpu_torch.gluon.loss",
               "mxnet_tpu_torch.gluon.utils", "mxnet_tpu_torch.gluon.nn",
               "mxnet_tpu_torch.gluon.nn.conv_layers",
               "mxnet_tpu_torch.gluon.data",
               "mxnet_tpu_torch.gluon.data.dataloader",
               "mxnet_tpu_torch.gluon.data.vision.datasets",
               "mxnet_tpu_torch.gluon.data.vision.transforms",
               "mxnet_tpu_torch.gluon.model_zoo",
               "mxnet_tpu_torch.gluon.model_zoo.model_store",
               "mxnet_tpu_torch.gluon.model_zoo.vision",
               "mxnet_tpu_torch.symbol", "mxnet_tpu_torch.ops.misc",
               "mxnet_tpu_torch.telemetry",
               "mxnet_tpu_torch.telemetry.registry",
               "mxnet_tpu_torch.telemetry.step_logger",
               "mxnet_tpu_torch.telemetry.tracing",
               "mxnet_tpu_torch.telemetry.flight", "mxnet_tpu_torch.profiler",
               "mxnet_tpu_torch.gluon.rnn", "mxnet_tpu_torch.gluon.rnn.rnn_cell",
               "mxnet_tpu_torch.gluon.rnn.rnn_layer",
               "mxnet_tpu_torch.gluon.contrib",
               "mxnet_tpu_torch.gluon.contrib.rnn",
               "mxnet_tpu_torch.serving.server", "mxnet_tpu_torch.kvstore",
               "mxnet_tpu_torch.ops.cuda_kernels", "mxnet_tpu_torch._atomic_io",
               "mxnet_tpu_torch.checkpoint", "mxnet_tpu_torch.fault",
               "mxnet_tpu_torch.compile_cache",
               "mxnet_tpu_torch.serving.canary",
               "mxnet_tpu_torch.serving.manifest",
               "mxnet_tpu_torch.serving.registry",
               "mxnet_tpu_torch.serving.cache", "mxnet_tpu_torch.ops._build",
               "mxnet_tpu_torch.serving.bucketing",
               "mxnet_tpu_torch.serving.generate",
               "mxnet_tpu_torch.serving.generate.kv_cache",
               "mxnet_tpu_torch.serving.generate.model",
               "mxnet_tpu_torch.serving.generate.scheduler",
               "mxnet_tpu_torch.serving.generate.stream",
               "mxnet_tpu_torch.gluon.contrib.transformer",
               "mxnet_tpu_torch.convert", "mxnet_tpu_torch.fault.elastic",
               "mxnet_tpu_torch.parallel",
               "mxnet_tpu_torch.parallel.distributed",
               "mxnet_tpu_torch.parallel.mesh",
               "mxnet_tpu_torch.parallel.collectives",
               "mxnet_tpu_torch.parallel.optimizer",
               "mxnet_tpu_torch.parallel.trainer",
               "mxnet_tpu_torch.parallel.attention",
               "mxnet_tpu_torch.parallel.pipeline",
               "mxnet_tpu_torch.parallel.moe",
               "mxnet_tpu_torch.gradient_compression",
               "mxnet_tpu_torch.checkpoint.compat",
               "mxnet_tpu_torch.parallel.transport",
               "mxnet_tpu_torch.kvstore_server",
               "mxnet_tpu_torch.serving.fleet",
               "mxnet_tpu_torch.fault.drill",
               "mxnet_tpu_torch.ndarray", "mxnet_tpu_torch.ndarray.sparse",
               "mxnet_tpu_torch.ndarray.ndarray",
               "mxnet_tpu_torch.ops.reduce",
               "mxnet_tpu_torch.ops.optimizer_ops",
               "mxnet_tpu_torch.gluon.trainer",
               "mxnet_tpu_torch.gluon.nn.basic_layers",
               "mxnet_tpu_torch.symbol.symbol")


def _module(root, sub):
    return importlib.import_module(root + ("." + sub if sub else ""))


def lazy_names(mod):
    """The names of ``__all__`` that ``mod`` resolves only through its
    module ``__getattr__``: absent from ``dir(mod)`` until asked for."""
    listed = [n for n in getattr(mod, "__all__", ())
              if not n.startswith("_") and n not in dir(mod)]
    out = set()
    for name in listed:
        try:
            getattr(mod, name)
        except AttributeError:
            continue
        out.add(name)
    return out


def public_names(mod):
    is_package = hasattr(mod, "__path__")
    listed = set(getattr(mod, "__all__", ()))
    out = set()
    for name in sorted(set(dir(mod)) | lazy_names(mod)):
        if name.startswith("_"):
            continue
        obj = getattr(mod, name)
        if isinstance(obj, types.ModuleType):
            if obj.__name__.startswith(mod.__name__ + "."):
                out.add(name)
            continue
        where = getattr(obj, "__module__", None) or ""
        if (name in listed or where == mod.__name__
                or mod.__name__ in ("mxnet_tpu", "mxnet_tpu_torch")
                or (is_package and where.startswith(mod.__name__ + "."))):
            out.add(name)
    return out


def _deferred(sub):
    return set().union(*(by_mod.get(sub, set())
                         for by_mod in DEFERRED.values()))


def names_after_import():
    """``{module: (the JAX package's public names, the port's names)}``
    right after importing both packages."""
    out = {}
    for sub in MODULES:
        port = _module("mxnet_tpu_torch", sub)
        out[sub] = (sorted(public_names(_module("mxnet_tpu", sub))),
                    sorted((set(dir(port)) | lazy_names(port))
                           - {n for n in dir(port) if n.startswith("_")}))
    return out


@pytest.fixture(scope="module")
def fresh_names():
    """``names_after_import`` in a new interpreter: other tests in this
    process import more submodules, which then show as attributes of
    their package."""
    code = ("import json, sys\n"
            "sys.path[:0] = [%r, %r]\n"
            "import test_torch_api_coverage as t\n"
            "print(json.dumps(t.names_after_import()))"
            % (REPO, os.path.join(REPO, "tests")))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sub", MODULES, ids=[m or "top" for m in MODULES])
def test_the_port_holds_every_public_name_but_the_deferred_ones(
        sub, fresh_names):
    jax_names, port_names = fresh_names[sub]
    assert set(jax_names) - set(port_names) == _deferred(sub)


@pytest.mark.parametrize("sub", sorted(PORTED), ids=[m or "top" for m in
                                                     sorted(PORTED)])
def test_the_slice_names_are_ported_and_not_deferred(sub):
    port = _module("mxnet_tpu_torch", sub)
    assert not PORTED[sub] & _deferred(sub)
    missing = {n for n in PORTED[sub] if not hasattr(port, n)}
    assert not missing


def test_deferred_names_are_each_owned_once():
    seen = {}
    for owner, by_mod in DEFERRED.items():
        for sub, names in by_mod.items():
            assert sub in MODULES
            for n in names:
                assert (sub, n) not in seen, (sub, n, seen.get((sub, n)))
                seen[(sub, n)] = owner


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, importlib\n"
            "sys.path.insert(0, %r)\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')))" % (REPO, NEW_MODULES))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _params(fn):
    try:
        return [n for n, p in inspect.signature(fn).parameters.items()
                if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    except (TypeError, ValueError):
        return None


def callables_of(sub):
    """``{"name" or "Class.method": (JAX callable, port callable)}`` of a
    module's public callables that both packages hold."""
    jm, pm = _module("mxnet_tpu", sub), _module("mxnet_tpu_torch", sub)
    out = {}
    for name in sorted(public_names(jm)):
        jo, po = getattr(jm, name), getattr(pm, name, None)
        if isinstance(jo, types.ModuleType) or not callable(jo) \
                or not callable(po):
            continue
        if not (inspect.isclass(jo) and inspect.isclass(po)):
            out[name] = (jo, po)
            continue
        out[name + ".__init__"] = (jo.__init__, po.__init__)
        for m, v in vars(jo).items():
            if not m.startswith("_") and callable(v) \
                    and callable(getattr(po, m, None)):
                out[name + "." + m] = (getattr(jo, m), getattr(po, m))
    return out


def param_gaps(jfn, pfn):
    """The JAX callable's parameter names the port's lacks, plus "order"
    when the names both take come in another order."""
    jp, pp = _params(jfn), _params(pfn)
    if jp is None or pp is None:
        return set()
    gaps = set(jp) - set(pp)
    if [n for n in jp if n in pp] != [n for n in pp if n in jp]:
        gaps.add("order")
    return gaps


@pytest.mark.parametrize("sub", MODULES, ids=[m or "top" for m in MODULES])
def test_public_callables_take_the_jax_packages_parameter_names(sub):
    deferred = {}
    for by_callable in DEFERRED_PARAMS.values():
        for (mod, name), gaps in by_callable.items():
            if mod == sub:
                deferred[name] = gaps
    found = {}
    for name, (jfn, pfn) in callables_of(sub).items():
        gaps = param_gaps(jfn, pfn)
        if gaps:
            found[name] = gaps
    assert found == deferred


def _public_members(cls):
    return {m for m in dir(cls) if not m.startswith("_")}


def members_after_import():
    """``{module: {class: the JAX class's public members the port's class
    lacks}}`` over every class both packages export from a module of
    ``MODULES`` (only the classes with a gap)."""
    out = {}
    for sub in MODULES:
        jm, pm = _module("mxnet_tpu", sub), _module("mxnet_tpu_torch", sub)
        for name in sorted(public_names(jm)):
            jo, po = getattr(jm, name), getattr(pm, name, None)
            if not (inspect.isclass(jo) and inspect.isclass(po)):
                continue
            gap = _public_members(jo) - _public_members(po)
            if gap:
                out.setdefault(sub, {})[name] = gap
    return out


def _deferred_members():
    out = {}
    for by_mod in DEFERRED_MEMBERS.values():
        for sub, by_cls in by_mod.items():
            for cls, members in by_cls.items():
                out.setdefault(sub, {}).setdefault(cls, set()).update(
                    members)
    return out


def test_every_class_holds_the_jax_classes_members_but_the_deferred():
    """A class of the port lacks none of the public members of the JAX
    package's class of its name, but those ``DEFERRED_MEMBERS`` owns."""
    assert members_after_import() == _deferred_members()


def test_deferred_members_are_each_owned_once():
    seen = set()
    for by_mod in DEFERRED_MEMBERS.values():
        for sub, by_cls in by_mod.items():
            assert sub in MODULES
            for cls, members in by_cls.items():
                for m in members:
                    assert (sub, cls, m) not in seen, (sub, cls, m)
                    seen.add((sub, cls, m))


def test_deferred_params_are_each_owned_once():
    seen = set()
    for by_callable in DEFERRED_PARAMS.values():
        for key in by_callable:
            assert key[0] in MODULES and key not in seen, key
            seen.add(key)
