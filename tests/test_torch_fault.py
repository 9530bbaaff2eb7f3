"""The port's fault-plan runtime (``fault/``) against the JAX package's, on
the CPU.

Host logic is held bitwise: the same plan over the same site hits makes
the same decisions (injected log, hit counts, exception types) in both
packages, ``BackoffPolicy`` draws the same delays from the same seed and
the same plan-armed seed chain, and driving the same scenario through
both packages (kvstore push/pull, ``nd.save``, the checkpoint store, the
async writer, ``Module.fit``'s steps, a prefetching iterator) hits the
same sites in the same order.  Then the JAX package's own cases
(``tests/test_fault.py``; the elastic runtime's are
``tests/test_torch_elastic.py``) on the port: the one-boolean fast path, torn writes
and ENOSPC over ``atomic_write``, the checkpoint store's fault sites,
the shared backoff's consumers (the checkpoint watcher, serving's
retry hints and submit retries), the kvstore and prefetch sites, and a
plan armed from ``MXNET_FAULT_PLAN`` in a fresh interpreter.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import fault as jfault
from mxnet_tpu_torch import fault
from mxnet_tpu_torch.fault import (BackoffPolicy, FaultInjected, FaultPlan,
                                   hooks)

torch.set_num_threads(1)

CPU = tmx.cpu()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.uninstall()
    jfault.uninstall()


# ---------------------------------------------------------------------------
# the plan's decisions, against the JAX package's
# ---------------------------------------------------------------------------
PLANS = {
    "after-every-times": ({"rules": [{"site": "a", "kind": "raise",
                                      "after": 2, "every": 3, "times": 2}]},
                          [("a", -1, {})] * 11),
    "glob-and-step": ({"rules": [
        {"site": "kvstore.*", "kind": "raise", "times": 1},
        {"site": "fit.step", "kind": "io_error", "step": 5, "times": 1}]},
        [("kvstore.push", -1, {}), ("kvstore.pull", -1, {}),
         ("fit.step", 4, {}), ("fit.step", 5, {}), ("fit.step", 5, {})]),
    "where": ({"rules": [
        {"site": "serving.*", "kind": "raise", "times": 0,
         "where": {"model": "ten*"}},
        {"site": "other", "kind": "raise", "times": 0,
         "where": {"never_published": "*"}}]},
        [("serving.cache.get", -1, {"model": "tenantA"}),
         ("serving.cache.get", -1, {"model": "B"}),
         ("serving.cache.get", -1, {}), ("other", -1, {"model": "x"}),
         ("serving.worker", -1, {"model": "tenantZ", "bucket": 4})]),
    "seeded-p": ({"seed": 3, "rules": [{"site": "s", "kind": "raise",
                                        "p": 0.3, "times": 0},
                                       {"site": "s", "kind": "enospc",
                                        "p": 0.1, "times": 0}]},
                 [("s", -1, {})] * 200),
    "exc-kinds": ({"rules": [
        {"site": "e", "kind": "raise", "exc": exc, "after": i, "times": 1}
        for i, exc in enumerate(["OSError", "RuntimeError", "ValueError",
                                 "TimeoutError", "ConnectionError",
                                 "MXNetError", "IntegrityError"])]},
        [("e", -1, {})] * 8),
    "network-kinds": ({"rules": [
        {"site": "t", "kind": k, "after": i, "times": 1}
        for i, k in enumerate(["partition", "lost_ack", "reorder",
                               "torn_write", "io_error"])]},
        [("t", -1, {"peer": 1})] * 6),
}


def _drive(pkg, spec, hits):
    """Fire ``hits`` through a fresh plan of ``pkg``; per hit the raised
    exception's class name (or None), then the plan's stats."""
    plan = pkg.FaultPlan(spec)
    out = []
    for site, step, ctx in hits:
        pkg.hooks.STEP[0] = step
        try:
            plan.fire(site, **ctx)
            out.append(None)
        except Exception as exc:    # noqa: BLE001 — the decision under test
            out.append(type(exc).__name__)
    pkg.hooks.STEP[0] = -1
    return out, plan.stats()


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_decisions_equal_the_jax_packages(case):
    spec, hits = PLANS[case]
    got = _drive(fault, spec, hits)
    assert got == _drive(jfault, spec, hits)
    assert any(got[0])


def test_plan_trace_replays_and_nan_kind_corrupts_floats_only():
    spec = {"seed": 5, "rules": [{"site": "out", "kind": "nan", "times": 0,
                                  "p": 0.5}]}
    logs = []
    for pkg in (fault, jfault):
        plan = pkg.FaultPlan(spec, trace=True)
        f = np.ones((2, 3), np.float32)
        i = np.ones((2,), np.int64)
        for _ in range(6):
            plan.fire("out", arrays=[f, i])
        assert (i == 1).all()
        assert plan.replay() == plan.stats()["injected"]
        logs.append((plan.stats(), np.isnan(f).all()))
    assert logs[0] == logs[1] and logs[0][1]


def test_plan_validation_is_loud():
    with pytest.raises(ValueError, match="unknown key"):
        FaultPlan({"rules": [{"site": "x", "knid": "raise"}]})
    with pytest.raises(ValueError, match="kind"):
        FaultPlan({"rules": [{"site": "x", "kind": "explode"}]})
    with pytest.raises(ValueError, match="exc"):
        FaultPlan({"rules": [{"site": "x", "exc": "Nope"}]})
    with pytest.raises(ValueError, match="site"):
        FaultPlan({"rules": [{"kind": "raise"}]})
    with pytest.raises(ValueError, match="unknown key"):
        FaultPlan({"rules": [], "sedd": 1})
    with pytest.raises(ValueError, match="where"):
        FaultPlan({"rules": [{"site": "s", "where": "tenantA"}]})


# ---------------------------------------------------------------------------
# BackoffPolicy, against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(retries=5, base_s=0.1, max_s=0.4, jitter=0.25, seed=1),
    dict(retries=3, base_s=0.5, max_s=30.0, jitter=0.0, seed=0),
    dict(retries=2, base_s=0.01, max_s=1.0, multiplier=3.0, jitter=0.9,
         seed="x:backoff:4")], ids=["jitter", "exact", "string-seed"])
def test_backoff_delays_equal_the_jax_packages(kw):
    def delays(pkg):
        p = pkg.BackoffPolicy(sleep=lambda s: None, **kw)
        return [p.delay(a) for a in range(12)]

    got = delays(fault)
    assert got == delays(jfault)
    for a, d in enumerate(got):
        raw = min(kw["base_s"] * kw.get("multiplier", 2.0) ** a, kw["max_s"])
        assert raw * (1 - kw["jitter"]) - 1e-12 <= d \
            <= raw * (1 + kw["jitter"]) + 1e-12


def test_backoff_seed_chain_under_an_armed_plan_equals_the_jax_packages():
    import random as _random

    def timeline(pkg):
        with pkg.active_plan({"seed": 21, "rules": []}):
            pols = [pkg.BackoffPolicy(retries=2, base_s=0.5, max_s=4.0,
                                      jitter=0.9, sleep=lambda s: None)
                    for _ in range(3)]
            return [[p.delay(a) for a in range(4)] for p in pols]

    _random.seed(123)
    first = timeline(fault)
    _random.seed(456)               # the global generator is never read
    assert timeline(fault) == first == timeline(jfault)
    assert first[0] != first[1]


def test_backoff_call_budget_abort_on_and_floor():
    slept = []
    p = BackoffPolicy(retries=2, base_s=0.01, max_s=0.02, jitter=0.0,
                      sleep=slept.append)
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("transient")

    with pytest.raises(OSError):
        p.call(flaky, retry_on=(OSError,))
    assert len(calls) == 3 and len(slept) == 2

    class Permanent(OSError):
        pass

    calls.clear()

    def broken():
        calls.append(1)
        raise Permanent("bit rot")

    with pytest.raises(Permanent):
        p.call(broken, retry_on=(OSError,), abort_on=(Permanent,))
    assert len(calls) == 1
    with pytest.raises(KeyError):
        p.call(lambda: {}["bug"], retry_on=(OSError,))
    slept.clear()
    p.sleep_for(0, floor_s=0.5)
    assert slept == [0.5]


def test_knob_defaults_flow_into_policy(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_RETRIES", "7")
    monkeypatch.setenv("MXNET_FAULT_BACKOFF_BASE_S", "0.125")
    monkeypatch.setenv("MXNET_FAULT_BACKOFF_JITTER", "0")
    p = BackoffPolicy(sleep=lambda s: None)
    assert p.retries == 7 and p.delay(0) == 0.125


# ---------------------------------------------------------------------------
# the same sites, in the same order, in both packages
# ---------------------------------------------------------------------------
def _scenario(mx, workdir):
    """kvstore push/pull, nd.save, a checkpoint store write and read, an
    async save, a 4-step fit and a prefetching iterator, in ``mx``."""
    port = mx is tmx
    ctx = CPU if port else mx.cpu()
    kv = mx.kv.create("local")
    kv.init("w", mx.nd.ones((2, 2), ctx=ctx))
    kv.push("w", mx.nd.ones((2, 2), ctx=ctx))
    kv.pull("w", out=mx.nd.zeros((2, 2), ctx=ctx))
    mx.nd.save(os.path.join(workdir, "a.params"),
               {"a": mx.nd.ones((3,), ctx=ctx)})
    store = mx.checkpoint.CheckpointStore(os.path.join(workdir, "ck"))
    store.write(1, {"arg/w": np.ones((2,), np.float32),
                    "arg/b": np.zeros((1,), np.float32)})
    store.read(1)
    ack = mx.checkpoint.AsyncCheckpointer(store)
    ack.save(2, {"arg/w": np.ones((2,), np.float32)}, block=True)
    rng = np.random.RandomState(0)
    X = rng.rand(16, 4).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.float32)
    data = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data, num_hidden=2, name="fc"), name="softmax")
    if port:
        with tmx.cpu():
            it = tmx.io.NDArrayIter(X, y, batch_size=8)
            pf_src = tmx.io.NDArrayIter(X, y, batch_size=8)
    else:
        it = mx.io.NDArrayIter(X, y, batch_size=8)
        pf_src = mx.io.NDArrayIter(X, y, batch_size=8)
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.1})
    pf = mx.io.PrefetchingIter(pf_src)
    for _ in pf:
        pass


def test_the_same_sites_fire_in_the_same_order(tmp_path):
    traces = []
    for pkg, mx in ((fault, tmx), (jfault, jmx)):
        workdir = tmp_path / mx.__name__
        workdir.mkdir()
        with pkg.active_plan(pkg.FaultPlan({"rules": []},
                                           trace=True)) as plan:
            _scenario(mx, str(workdir))
        # the prefetch thread's hits race the consumer: compare their
        # count, and the order of everything else
        seq = [(s, step) for s, step, _ctx in plan.trace()]
        traces.append(([x for x in seq if x[0] != "io.prefetch"],
                       sum(1 for x in seq if x[0] == "io.prefetch")))
    assert traces[0] == traces[1]
    sites = {s for s, _ in traces[0][0]}
    assert {"kvstore.push", "kvstore.pull", "atomic_io.commit",
            "checkpoint.store.shard_write", "checkpoint.store.commit",
            "checkpoint.store.manifest_read", "checkpoint.async.worker",
            "fit.step"} <= sites
    assert [step for s, step in traces[0][0] if s == "fit.step"] == \
        [0, 1, 2, 3]
    assert traces[0][1] >= 2


# ---------------------------------------------------------------------------
# the fast path and arming
# ---------------------------------------------------------------------------
def test_disabled_fast_path_is_one_boolean(tmp_path, monkeypatch):
    """With no plan armed the sites never call ``fire``: a ``fire`` that
    raises goes unnoticed by every instrumented path."""
    assert not hooks.ACTIVE[0]
    hooks.fire("anything")              # the default is a no-op

    def boom(site, **ctx):
        raise AssertionError("fire() reached with no plan: %s" % site)

    monkeypatch.setattr(hooks, "fire", boom)
    _scenario(tmx, str(tmp_path))
    plan = fault.install(FaultPlan({"rules": []}))
    assert hooks.ACTIVE[0] and fault.installed() is plan
    fault.uninstall()
    assert not hooks.ACTIVE[0] and fault.installed() is None


def test_active_plan_restores_outer_plan():
    outer = fault.install(FaultPlan({"rules": [
        {"site": "o", "kind": "raise", "times": 0}]}))
    with fault.active_plan({"rules": []}):
        hooks.fire("o")
    assert fault.installed() is outer
    with pytest.raises(FaultInjected):
        hooks.fire("o")


def test_env_armed_plan_kills_a_fresh_interpreter(tmp_path):
    """``MXNET_FAULT_PLAN`` arms at import (inline JSON or ``@file``):
    an ``exit`` rule ends the process with its code."""
    code = ("import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch.fault import hooks\n"
            "assert mx.fault.installed() is not None\n"
            "hooks.fire('die')\n"
            "print('SURVIVED')\n")
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps(
        {"rules": [{"site": "die", "kind": "exit", "code": 41}]}))
    env = dict(os.environ, MXNET_FAULT_PLAN="@" + str(plan_file),
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 41, proc.stderr
    assert "SURVIVED" not in proc.stdout


def test_injection_telemetry_counter_and_delay():
    from mxnet_tpu_torch import telemetry
    plan = FaultPlan({"rules": [{"site": "t", "kind": "raise", "times": 1},
                                {"site": "d", "kind": "delay",
                                 "delay_s": 0.05, "times": 1}]})
    with pytest.raises(FaultInjected):
        plan.fire("t")
    t0 = time.perf_counter()
    plan.fire("d")
    assert time.perf_counter() - t0 >= 0.04
    values = telemetry.snapshot()["mxnet_fault_injected_total"]["values"]
    assert any(v["labels"].get("site") == "t"
               and v["labels"].get("kind") == "raise" and v["value"] >= 1
               for v in values)


# ---------------------------------------------------------------------------
# atomic_write and the checkpoint store under injected faults
# ---------------------------------------------------------------------------
def _no_temps(dirpath):
    return [n for n in os.listdir(dirpath) if ".tmp-" in n]


@pytest.mark.parametrize("kind", ["torn_write", "enospc"])
def test_nd_save_injected_fault_never_exposes_partial(tmp_path, kind):
    path = str(tmp_path / "w.params")
    tmx.nd.save(path, {"a": tmx.nd.ones((4,), ctx=CPU)})
    before = open(path, "rb").read()
    with fault.active_plan({"rules": [{"site": "atomic_io.commit",
                                       "kind": kind, "times": 1}]}):
        with pytest.raises(OSError):
            tmx.nd.save(path, {"a": tmx.nd.zeros((16,), ctx=CPU)})
    assert open(path, "rb").read() == before
    assert _no_temps(str(tmp_path)) == []


def test_symbol_save_and_fresh_target_torn_write(tmp_path):
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                                 name="fc")
    path = str(tmp_path / "net.json")
    net.save(path)
    before = open(path).read()
    with fault.active_plan({"rules": [{"site": "atomic_io.commit",
                                       "kind": "torn_write", "times": 2}]}):
        with pytest.raises(OSError):
            tmx.sym.Variable("other").save(path)
        with pytest.raises(OSError):
            tmx.nd.save(str(tmp_path / "fresh.params"),
                        {"x": tmx.nd.ones((8,), ctx=CPU)})
    assert open(path).read() == before
    assert not os.path.exists(str(tmp_path / "fresh.params"))
    assert _no_temps(str(tmp_path)) == []


def test_store_commit_and_shard_faults(tmp_path):
    store = tmx.checkpoint.CheckpointStore(str(tmp_path))
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    with fault.active_plan({"rules": [{"site": "checkpoint.store.commit",
                                       "kind": "io_error", "times": 1}]}):
        with pytest.raises(OSError):
            store.write(1, arrays)
    assert store.steps() == [] and len(store.gc_orphans()) == 1
    store.write(1, arrays)
    assert store.steps() == [1]
    with fault.active_plan({"rules": [
            {"site": "checkpoint.store.shard_write", "kind": "torn_write",
             "times": 1}]}):
        with pytest.raises(OSError):
            store.write(3, {"w": np.ones((64,), np.float32)})
    assert store.latest() == 1
    orphans = store.gc_orphans()
    assert len(orphans) == 1 and ".tmp-" in orphans[0]


def test_async_worker_fault_contained(tmp_path):
    from mxnet_tpu_torch import engine
    store = tmx.checkpoint.CheckpointStore(str(tmp_path))
    ck = tmx.checkpoint.AsyncCheckpointer(store)
    with fault.active_plan({"rules": [{"site": "checkpoint.async.worker",
                                       "kind": "io_error", "times": 1}]}):
        assert ck.save(1, {"w": np.ones((4,), np.float32)})
        assert ck.wait(10.0)
    assert isinstance(ck.last_error(), OSError) and store.steps() == []
    engine.check_raise()
    assert ck.save(2, {"w": np.ones((4,), np.float32)}, block=True)
    assert store.steps() == [2]


def test_manager_restore_walks_past_manifest_fault(tmp_path):
    """A transient manifest-read fault on the newest checkpoint lands the
    restore on the older one.  (The JAX package's ``restore_latest`` lets
    that ``CheckpointError`` escape; its own test walks the steps by
    hand.)"""
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path), async_save=False)
    for v in (1.0, 2.0):
        mgr.save_state(tmx.checkpoint.TrainState(
            {"w": np.full((2,), v, np.float32)}, {}, {"epoch": int(v)}))
    with fault.active_plan({"rules": [
            {"site": "checkpoint.store.manifest_read", "kind": "io_error",
             "times": 1}]}):
        state = mgr.restore_latest()
    assert state.epoch == 1 and state.arg_params["w"][0] == 1.0


# ---------------------------------------------------------------------------
# the shared backoff's consumers
# ---------------------------------------------------------------------------
def _tiny_module(X, y):
    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        data, num_hidden=4, name="fc1"), name="softmax")
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, y, batch_size=16)
    mod = tmx.mod.Module(net, context=CPU)
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1},
            initializer=tmx.init.Xavier())
    return mod


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.RandomState(0)
    X = rng.randn(32, 8).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    return _tiny_module(X, y), X


def _checkpointed(tiny, tmp_path):
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path / "ck"),
                                           async_save=False)
    mgr.save_module(tiny[0], epoch=1, block=True)
    return mgr


def test_watcher_transient_read_retries_within_one_poll(tiny, tmp_path):
    mgr = _checkpointed(tiny, tmp_path)
    reg = tmx.serving.ModelRegistry()
    watcher = reg.watch_checkpoints(str(tmp_path / "ck"), "m",
                                    poll_interval=60.0, start=False,
                                    ctx=CPU)
    with fault.active_plan({"rules": [
            {"site": "checkpoint.store.manifest_read", "kind": "io_error",
             "times": 2}]}) as plan:
        served = watcher.poll_once()
    assert served == mgr.latest_step() == reg.get("m").version
    assert plan.injected_count() == 2
    assert plan.stats()["hits"]["checkpoint.watcher.poll"] == 1


def test_watcher_integrity_error_not_retried(tiny, tmp_path):
    import glob
    mgr = _checkpointed(tiny, tmp_path)
    step = mgr.latest_step()
    shard = sorted(glob.glob(os.path.join(
        str(tmp_path / "ck"), "ckpt-%08d" % step, "*.bin")))[0]
    with open(shard, "r+b") as f:
        f.write(b"\xff" * 8)
    watcher = tmx.serving.ModelRegistry().watch_checkpoints(
        str(tmp_path / "ck"), "m", poll_interval=60.0, start=False, ctx=CPU)
    t0 = time.perf_counter()
    assert watcher.poll_once() is None
    assert time.perf_counter() - t0 < 2.0 and watcher.last_step == step


def test_queue_full_carries_live_retry_hint_and_submit_retry(tiny):
    mod, X = tiny
    srv = tmx.serving.ModelServer(max_batch=4, queue_depth=1,
                                  batch_wait_ms=1.0, ctx=CPU)
    mod.export_serving("m", srv)
    blocker = srv.infer_async("m", X[:1])
    with pytest.raises(tmx.serving.QueueFull) as exc_info:
        srv.infer_async("m", X[:1])
    assert 0.0 < exc_info.value.retry_after_s <= 60.0

    def drain_later():
        time.sleep(0.15)
        srv.start()

    t = threading.Thread(target=drain_later, daemon=True)
    t.start()
    out = srv.infer("m", X[:1], retries=8)
    assert out[0].shape == (1, 4) and blocker.result()[0].shape == (1, 4)
    assert srv.stats()["requests"]["retried"] >= 1
    t.join()
    srv.stop(drain=False)


def test_future_expiry_hint_cannot_deadlock_delivery():
    from mxnet_tpu_torch.serving.server import InferenceFuture, _now_ms
    server_lock = threading.Lock()
    in_hint, release_hint = threading.Event(), threading.Event()

    def hint():
        in_hint.set()
        release_hint.wait(5.0)
        with server_lock:
            return 0.5

    fut = InferenceFuture(_now_ms() - 1.0, hint=hint)
    delivered, out = [], {}

    def deliver():
        in_hint.wait(5.0)
        with server_lock:
            delivered.append(fut._set_exception(RuntimeError("boom")))
        release_hint.set()

    def client():
        try:
            fut.result()
        except Exception as exc:   # noqa: BLE001 — either outcome is fine
            out["exc"] = exc

    threads = [threading.Thread(target=f, daemon=True)
               for f in (deliver, client)]
    for t in threads:
        t.start()
    threads[1].join(5.0)
    assert not threads[1].is_alive(), "result() deadlocked against delivery"
    threads[0].join(5.0)
    assert delivered == [True] and "exc" in out


# ---------------------------------------------------------------------------
# kvstore, prefetch and fit sites
# ---------------------------------------------------------------------------
def test_kvstore_push_pull_sites_fire():
    kv = tmx.kv.create("local")
    kv.init("w", tmx.nd.ones((2, 2), ctx=CPU))
    with fault.active_plan({"rules": [
            {"site": "kvstore.push", "kind": "raise", "times": 1}]}) as plan:
        with pytest.raises(FaultInjected):
            kv.push("w", tmx.nd.ones((2, 2), ctx=CPU))
        kv.pull("w", out=tmx.nd.zeros((2, 2), ctx=CPU))
        assert plan.stats()["hits"].get("kvstore.pull") == 1
    assert plan.injected_count(site="kvstore.push") == 1


def test_io_prefetch_fault_surfaces_at_sync_point():
    from mxnet_tpu_torch import engine
    engine.clear_exception()
    X = np.random.RandomState(1).randn(64, 4).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, np.zeros(64, np.float32), batch_size=16)
    with fault.active_plan({"rules": [
            {"site": "io.prefetch", "kind": "raise", "exc": "MXNetError",
             "after": 1, "times": 1}]}):
        pf = tmx.io.PrefetchingIter(it)
        batches = 0
        with pytest.raises(tmx.MXNetError):
            for _ in range(16):
                next(pf)
                batches += 1
        assert batches >= 1
    engine.clear_exception()


def test_fit_step_fault_at_an_addressed_step(tiny):
    """A step-addressed rule fails ``fit`` at that global batch, in both
    packages, after the same number of completed steps."""
    _mod, X = tiny
    y = (X[:, 0] > 0).astype(np.float32)
    done = {}
    for pkg, mx in ((fault, tmx), (jfault, jmx)):
        steps = []
        data = mx.sym.Variable("data")
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            data, num_hidden=4, name="fc1"), name="softmax")
        if mx is tmx:
            with tmx.cpu():
                it = tmx.io.NDArrayIter(X, y, batch_size=8)
            mod = tmx.mod.Module(net, context=CPU)
        else:
            it = mx.io.NDArrayIter(X, y, batch_size=8)
            mod = mx.mod.Module(net, context=mx.cpu())
        with pkg.active_plan({"rules": [{"site": "fit.step",
                                         "kind": "raise", "step": 5}]}):
            with pytest.raises(Exception) as exc_info:
                mod.fit(it, num_epoch=3,
                        optimizer_params={"learning_rate": 0.1},
                        batch_end_callback=lambda p: steps.append(
                            (p.epoch, p.nbatch)))
        done[mx.__name__] = (steps, type(exc_info.value).__name__)
    assert done["mxnet_tpu_torch"] == done["mxnet_tpu"]
    assert done["mxnet_tpu"][0][-1] == (1, 0)
