"""The port's elastic training runtime (``fault/elastic.py``,
``Module.fit(elastic=True)``) against the JAX package's, on the CPU.

The supervisor's classification and budget are the JAX package's cases
(``tests/test_fault.py``); the elastic fit after a mid-epoch fault and
after a real SIGTERM ends bitwise where an uninterrupted port fit does,
and within 1e-6 of the JAX package's elastic fit from the same weights
and the same (unshuffled) batches; ``ProcessSupervisor`` relaunches a
child process that exits 143.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import fault as jfault
from mxnet_tpu.checkpoint import CheckpointManager as JManager
from mxnet_tpu_torch import fault, telemetry
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.fault import (BackoffPolicy, ElasticError,
                                   ElasticSupervisor, ProcessSupervisor)

torch.set_num_threads(1)

TOL = 1e-6      # fp32 against the JAX package, of each tensor's largest
EPOCHS = 3
BATCH = 16


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.uninstall()
    jfault.uninstall()


def _fast_backoff():
    return BackoffPolicy(retries=8, base_s=0.001, max_s=0.002, jitter=0.0,
                         sleep=lambda s: None)


def _counter(name):
    fam = telemetry.snapshot().get(name)
    return sum(v["value"] for v in fam["values"]) if fam else 0


# ---------------------------------------------------------------------------
# the supervisors
# ---------------------------------------------------------------------------
def test_supervisor_budget_exhaustion_is_loud():
    sup = ElasticSupervisor(retries=2, backoff=_fast_backoff())
    calls = []
    gave_up = _counter("mxnet_fault_gave_up_total")

    def always_dies(restart):
        calls.append(restart)
        raise OSError("infra")

    with pytest.raises(ElasticError) as exc_info:
        sup.run(always_dies)
    assert calls == [0, 1, 2]                   # 1 + 2 retries
    assert isinstance(exc_info.value.__cause__, OSError)
    assert isinstance(exc_info.value, tmx.MXNetError)
    assert _counter("mxnet_fault_gave_up_total") == gave_up + 1


def test_supervisor_classification():
    sup = ElasticSupervisor(retries=3, backoff=_fast_backoff())

    def bug(restart):
        raise TypeError("programming error")

    with pytest.raises(TypeError):
        sup.run(bug)                            # not recoverable: no retry

    seen = []
    retries = _counter("mxnet_fault_retries_total")
    recoveries = _counter("mxnet_fault_recoveries_total")

    def preempted_once(restart):
        seen.append(restart)
        if not restart:
            raise SystemExit(143)               # the preemption exit
        return "done"

    assert sup.run(preempted_once) == "done"
    assert seen == [0, 1]
    assert _counter("mxnet_fault_retries_total") == retries + 1
    assert _counter("mxnet_fault_recoveries_total") == recoveries + 1

    def real_exit(restart):
        raise SystemExit(2)                     # an operator exit: not ours

    with pytest.raises(SystemExit):
        sup.run(real_exit)

    def nested(restart):
        raise ElasticError("inner budget spent")

    with pytest.raises(ElasticError, match="inner budget"):
        sup.run(nested)                         # never feeds an outer one


@pytest.mark.parametrize("exc", [OSError("disk"), ConnectionError("peer"),
                                 TimeoutError("slow"), RuntimeError("nccl"),
                                 tmx.MXNetError("op"),
                                 fault.FaultInjected("drill"),
                                 SystemExit(143), TypeError("bug"),
                                 AssertionError("bug"), SystemExit(1)],
                         ids=lambda e: "%s(%s)" % (type(e).__name__, e))
def test_classification_matches_the_jax_package(exc):
    jexc = exc
    if isinstance(exc, tmx.MXNetError):
        jexc = jmx.base.MXNetError(str(exc))
    elif isinstance(exc, fault.FaultInjected):
        jexc = jfault.FaultInjected(str(exc))
    from mxnet_tpu.fault.elastic import ElasticSupervisor as JSupervisor
    assert ElasticSupervisor(retries=1).is_recoverable(exc) == \
        JSupervisor(retries=1).is_recoverable(jexc)


def test_process_supervisor_relaunches_a_preempted_child():
    launched = []

    def launch(restart):
        launched.append(restart)
        code = "import sys; sys.exit(%d)" % (143 if restart == 0 else 0)
        return subprocess.run([sys.executable, "-c", code],
                              timeout=60).returncode

    sup = ProcessSupervisor(retries=2, backoff=_fast_backoff())
    assert sup.run(launch) == [143, 0]
    assert launched == [0, 1]
    assert ProcessSupervisor.is_recoverable(-9)
    assert not ProcessSupervisor.is_recoverable(1)

    def buggy(restart):
        return subprocess.run([sys.executable, "-c", "raise SystemExit(3)"],
                              timeout=60).returncode

    with pytest.raises(ElasticError, match="deterministically"):
        ProcessSupervisor(retries=2, backoff=_fast_backoff()).run(buggy)

    with pytest.raises(ElasticError, match="gave up"):
        ProcessSupervisor(retries=1, backoff=_fast_backoff()).run(
            lambda restart: 143)


def test_lazy_exports_match_the_jax_package():
    import mxnet_tpu_torch.fault.elastic as elastic
    assert fault.elastic is elastic
    assert fault.ElasticSupervisor is elastic.ElasticSupervisor
    assert elastic.PREEMPTION_EXIT == 143
    assert {t.__name__ for t in elastic.RECOVERABLE} == \
        {t.__name__ for t in jfault.elastic.RECOVERABLE}
    # the data-parallel trainer's loop, lazily exported like the rest
    assert fault.run_elastic is elastic.run_elastic
    # the package stays importable without torch (it loads before
    # everything, from _atomic_io)
    code = ("import sys; sys.modules['torch'] = None; "
            "sys.path.insert(0, %r); "
            "import importlib.util as u; "
            "spec = u.spec_from_file_location('f', %r, "
            "submodule_search_locations=[%r]); "
            "m = u.module_from_spec(spec); sys.modules['f'] = m; "
            "spec.loader.exec_module(m); print(sorted(m.__all__)[:2])"
            % (tmx.__path__[0], fault.__file__,
               fault.__path__[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# fit(elastic=True)
# ---------------------------------------------------------------------------
def _build(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    init = {"fc1_weight": rng.randn(8, 8).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(2, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(2, np.float32)}
    return X, y, init


def _fit_kwargs(mgr):
    return dict(num_epoch=EPOCHS, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                eval_metric="acc", checkpoint_manager=mgr)


def _port_fit(plan=None, ckpt=None):
    """The port's fit from ``_data``'s weights, uninterrupted or elastic
    under ``plan``; returns (weights, momentum) as numpy."""
    X, y, init = _data()
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False)
        args = {k: tmx.nd.array(v) for k, v in init.items()}
    mod = tmx.mod.Module(_build(tmx), context=tmx.cpu())
    mgr = None
    if ckpt:
        mgr = CheckpointManager(directory=ckpt, async_save=False,
                                period_steps=1, keep_last=50)
    kw = _fit_kwargs(mgr)
    if plan is not None:
        with fault.active_plan(plan) as armed:
            mod.fit(it, elastic=True, arg_params=args, **kw)
        injected = armed.injected_count()
    else:
        mod.fit(it, arg_params=args, **kw)
        injected = 0
    weights, _ = mod.get_params()
    states = mod._updater.states if mod._updater is not None else {}
    mom = {k: v.asnumpy() for k, v in sorted(
        (str(k), s) for k, s in states.items() if s is not None)}
    return ({k: v.asnumpy() for k, v in weights.items()}, mom, injected)


def _jax_fit(plan, ckpt):
    X, y, init = _data()
    it = jmx.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False)
    mod = jmx.mod.Module(_build(jmx), context=jmx.cpu())
    mgr = JManager(directory=ckpt, async_save=False, period_steps=1,
                   keep_last=50)
    args = {k: jmx.nd.array(v) for k, v in init.items()}
    with jfault.active_plan(plan):
        mod.fit(it, elastic=True, arg_params=args, **_fit_kwargs(mgr))
    weights, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in weights.items()}


PLANS = {
    "mid_epoch_fault": {"rules": [{"site": "fit.step", "kind": "raise",
                                   "exc": "RuntimeError", "step": 6,
                                   "times": 1}]},
    "sigterm": {"rules": [{"site": "fit.step", "kind": "sigterm",
                           "step": 6, "times": 1}]},
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_fit_elastic_resumes_bitwise_and_matches_the_jax_package(
        case, tmp_path, monkeypatch):
    for pkg in ("MXNET_FAULT_BACKOFF_BASE_S", "MXNET_FAULT_BACKOFF_MAX_S"):
        monkeypatch.setenv(pkg, "0.01")
    oracle_w, oracle_m, _ = _port_fit()
    retries = _counter("mxnet_fault_retries_total")
    recoveries = _counter("mxnet_fault_recoveries_total")
    got_w, got_m, injected = _port_fit(PLANS[case], str(tmp_path / "port"))
    assert injected == 1
    assert _counter("mxnet_fault_retries_total") == retries + 1
    assert _counter("mxnet_fault_recoveries_total") == recoveries + 1
    assert sorted(got_w) == sorted(oracle_w) and got_m.keys() == \
        oracle_m.keys() and oracle_m
    for k in oracle_w:
        np.testing.assert_array_equal(got_w[k], oracle_w[k], err_msg=k)
    for k in oracle_m:
        np.testing.assert_array_equal(got_m[k], oracle_m[k], err_msg=k)
    jax_w = _jax_fit(PLANS[case], str(tmp_path / "jax"))
    for k in oracle_w:
        scale = max(1.0, float(np.abs(jax_w[k]).max()))
        assert np.abs(got_w[k] - jax_w[k]).max() <= TOL * scale, k


def test_fit_elastic_without_checkpointing_raises(monkeypatch):
    monkeypatch.delenv("MXNET_CKPT_DIR", raising=False)
    X, y, _ = _data()
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, y, batch_size=BATCH)
    mod = tmx.mod.Module(_build(tmx), context=tmx.cpu())
    with pytest.raises(ValueError, match="checkpoint manager"):
        mod.fit(it, num_epoch=1, elastic=True)


def test_fit_elastic_gives_up_after_its_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_BACKOFF_BASE_S", "0.001")
    monkeypatch.setenv("MXNET_FAULT_BACKOFF_MAX_S", "0.001")
    monkeypatch.setenv("MXNET_FAULT_RETRIES", "1")
    X, y, init = _data()
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, y, batch_size=BATCH)
    mod = tmx.mod.Module(_build(tmx), context=tmx.cpu())
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False,
                            period_steps=1)
    plan = {"rules": [{"site": "fit.step", "kind": "io_error", "times": 0}]}
    with fault.active_plan(plan):
        with pytest.raises(ElasticError, match="gave up after 1"):
            mod.fit(it, elastic=True, **_fit_kwargs(mgr))


def test_chip_smoke_elastic_phase_rehearses_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """chip_smoke's phase 21 (c) with ctx=cpu() at ResNet-8 size (3x32x32,
    batch 4, 10 classes, 2 epochs of 8 steps): the uninterrupted fit, then
    the same under fit(elastic=True) with the SIGTERM at the first
    attempt's step 5 and the error at the second's step 8, checked by the
    phase itself: state bitwise, 2 faults injected and retried, one
    recovery, the sweep once a bucket for every step run, replays
    included (the counting wrappers stand in for the kernels' counts)."""
    import os
    import chip_smoke
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "example", "image-classification",
        "symbols"))
    import resnet as jax_resnet
    for knob in ("MXNET_PALLAS_FUSED_OPT", "MXNET_PALLAS_SOFTMAX",
                 "MXNET_PALLAS_BN_RELU"):
        monkeypatch.setenv(knob, "1")
    seen = {}

    def counting(name, fn):
        def wrapper(*a, **kw):
            if a[0].device.type != "meta":
                seen[name] = seen.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("sgd_mom_sweep", "softmax_lastaxis"):
        monkeypatch.setattr(ck, name, counting(name, getattr(ck, name)))

    def counts(reset=False):
        if reset:
            seen.clear()
        return dict(seen)

    sym = tmx.sym.load_json(jax_resnet.get_symbol(10, 8, "3,32,32").tojson())
    res = chip_smoke.elastic_phase(tmx, ck, tmx.cpu(), sym, (3, 32, 32), 4,
                                   str(tmp_path), counts=counts, classes=10)
    assert res["bitwise"] and res["injected"] == 2
    assert res["steps_run"] >= res["uninterrupted_steps"] == 16
    assert res["buckets"] >= 1
    assert res["launches"]["sgd_mom_sweep"] == \
        res["buckets"] * res["steps_run"]
    assert len(res["recover_s"]) == 2 and all(
        v is not None and v > 0 for v in res["recover_s"])
