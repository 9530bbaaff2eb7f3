"""The port's multi-tenant serving against the JAX package's, on the CPU.

Each case of the JAX package's ``tests/test_serving_multitenant.py``
(but its chaos soak, which needs the fault drills the port does not have
yet) runs here through both packages on the same inputs, and what is
host logic is held equal: per-model quota rejections and their messages,
the round-robin scheduler's dispatch sequence over the same queue, the
executor cache's quota decisions, brownout entry and its sheds, the
doomed-request shed, the request ledger, the retry hints from the same
latency history, the canary gate's verdicts on the same evidence, and
the seeded canary routing (the same requests routed, the same verdicts,
the same counts).  Answers are held within 1e-6 (fp32; a one-layer
model).  Timing-dependent counts (latencies, the decision's latency) are
not compared.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import fault as jfault
from mxnet_tpu_torch import fault

torch.set_num_threads(1)

CPU = tmx.cpu()
IN_DIM = 6
HID = 4
ATOL = 1e-6
PKGS = (tmx, jmx)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.uninstall()
    jfault.uninstall()


def _make_model(mx, seed=0):
    data = mx.sym.Variable("data")
    out = mx.sym.softmax(mx.sym.FullyConnected(data, num_hidden=HID,
                                               name="fc"), name="prob")
    rng = np.random.RandomState(seed)
    w = rng.randn(HID, IN_DIM).astype(np.float32)
    b = rng.randn(HID).astype(np.float32)
    kw = {"ctx": CPU} if mx is tmx else {}
    return out, {"fc_weight": mx.nd.array(w, **kw),
                 "fc_bias": mx.nd.array(b, **kw)}


def _server(mx, **kwargs):
    kwargs.setdefault("max_batch", 8)
    kwargs.setdefault("batch_wait_ms", 1.0)
    kwargs.setdefault("queue_depth", 64)
    kwargs.setdefault("default_timeout_ms", 30000.0)
    if mx is tmx:
        kwargs["ctx"] = CPU
    srv = mx.serving.ModelServer(**kwargs)
    for name, seed in (("A", 0), ("B", 42)):
        sym, arg = _make_model(mx, seed)
        srv.add_model(name, sym, arg, {}, {"data": (1, IN_DIM)})
    return srv


def _x(rows=1, seed=0):
    return np.random.RandomState(seed).rand(rows, IN_DIM).astype(np.float32)


def _both(scenario, **kw):
    """Run ``scenario(mx, **kw)`` through both packages; (port, JAX)."""
    return tuple(scenario(mx, **kw) for mx in PKGS)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _ledger_balances(req):
    return req["submitted"] == req["served"] + req["failed"] \
        + req["expired"] + req["shed"]


# -- admission control --------------------------------------------------------
def _quota_scenario(mx):
    srv = _server(mx)
    q = srv.set_quota("A", queue_depth=2)
    futs = [srv.infer_async("A", _x()) for _ in range(2)]
    with pytest.raises(mx.serving.QueueFull) as exc:
        srv.infer_async("A", _x())
    fb = srv.infer_async("B", _x(2))
    srv.start()
    outs = [f.result()[0] for f in futs] + [fb.result()[0],
                                            srv.infer("A", _x())[0]]
    pm = srv.stats()["per_model"]
    srv.stop(drain=False)
    return (q, str(exc.value), pm["A"]["requests"], pm["B"]["requests"],
            pm["A"]["quota"], outs)


def test_model_queue_quota_isolates_tenants():
    port, jax = _both(_quota_scenario)
    assert port[:5] == jax[:5]
    assert "model 'A' queue quota" in port[1]
    assert port[2]["rejected_queue_full"] == 1
    assert port[3]["rejected_queue_full"] == 0
    for a, b in zip(port[5], jax[5]):
        _close(a, b)


def _inflight_scenario(mx):
    srv = _server(mx)
    srv.set_quota("A", inflight=3)
    futs = [srv.infer_async("A", _x()) for _ in range(3)]
    with pytest.raises(mx.serving.QueueFull) as exc:
        srv.infer_async("A", _x())
    srv.start()
    for f in futs:
        f.result()
    srv.infer("A", _x())
    warm_srv = _server(mx)
    warm_srv.set_quota("A", queue_depth=1, inflight=1)
    parked = warm_srv.infer_async("A", _x())
    warm_srv.start()
    warmed = warm_srv.warmup("A")          # solo dummies bypass quotas
    parked.result()
    out = (str(exc.value), srv.stats()["per_model"]["A"]["requests"],
           [b for _n, _v, b in warmed])
    srv.stop(drain=False)
    warm_srv.stop(drain=False)
    return out


def test_model_inflight_quota_and_warmup_bypass():
    port, jax = _both(_inflight_scenario)
    assert port == jax
    assert "in-flight quota" in port[0] and port[2] == [1, 2, 4, 8]


def _hint_scenario(mx):
    srv = _server(mx)
    with srv._mlock:
        srv._latencies["slow"] = [2000.0] * 40
        srv._latencies["fast"] = [4.0] * 40
        srv._latencies["A"] = [1000.0] * 40
        srv._latencies["B"] = [2.0] * 40
    hints = [srv._retry_after_s(m, depth=d) for m in ("slow", "fast")
             for d in (0, 8, 40)]
    srv.set_quota("A", queue_depth=1)
    srv.infer_async("A", _x())
    with pytest.raises(mx.serving.QueueFull) as exc:
        srv.infer_async("A", _x())
    srv.stop(drain=False)
    return hints, exc.value.retry_after_s


def test_per_model_retry_hints_equal_the_jax_packages():
    port, jax = _both(_hint_scenario)
    assert port == jax
    assert port[0][1] > 50 * port[0][4] and port[1] >= 1.0


def _rr_scenario(mx):
    """The scheduler's decisions over one queue: a deep backlog of A, one
    B request, mixed priorities; popped batch by batch."""
    srv = _server(mx, batch_wait_ms=0.0)
    for i in range(6):
        srv.infer_async("A", _x(8 if i % 2 else 3), priority=i % 3)
    srv.infer_async("B", _x(1), priority=2)
    srv.infer_async("A", _x(2), priority=0)
    seq = []
    with srv._cv:
        while srv._queue:
            head = srv._next_head_locked()
            reqs, entry, bucket = srv._pop_batch_locked(
                head, srv._rows_cap_locked(head))
            seq.append((entry.name, bucket, [(r.rows, r.priority)
                                             for r in reqs]))
            for r in reqs:
                r.future._set_exception(RuntimeError("popped"))
    srv.stop(drain=False)
    return seq


def test_round_robin_dispatch_sequence_equals_the_jax_packages():
    port, jax = _both(_rr_scenario)
    assert port == jax
    assert [name for name, _b, _r in port].index("B") < len(port) - 1


# -- executor-cache isolation -------------------------------------------------
def _cache_scenario(mx):
    reg = mx.serving.ModelRegistry()
    for name, seed in (("A", 0), ("B", 1)):
        sym, arg = _make_model(mx, seed)
        reg.add(name, sym, arg, {}, {"data": (1, IN_DIM)})
    ea, eb = reg.get("A"), reg.get("B")
    cache = mx.serving.ExecutorCache(4, ctx=CPU) if mx is tmx \
        else mx.serving.ExecutorCache(4)
    cache.set_quota("A", 2)
    cache.get(ea, 1)
    cache.get(ea, 2)
    for bucket in (1, 2, 4, 8):
        cache.get(eb, bucket)
    first = cache.stats()
    cache.get(ea, 1)
    cache.get(ea, 4)
    second = cache.stats()
    cache.set_quota("A", None)
    return first, second, cache.quotas()


def test_cache_quota_decisions_equal_the_jax_packages():
    port, jax = _both(_cache_scenario)
    assert port == jax
    first, second, _q = port
    assert first["per_model"]["A"]["evictions"] == 0
    assert first["per_model"]["A"]["size"] == 2
    assert first["per_model"]["B"]["evictions"] >= 1
    assert second["per_model"]["A"]["misses"] == 3
    assert second["per_model"]["A"]["evictions"] == 1


def test_cache_quota_oversubscription_warns(caplog):
    import logging
    cache = tmx.serving.ExecutorCache(2, ctx=CPU)
    with caplog.at_level(logging.WARNING):
        cache.set_quota("A", 2)
        cache.set_quota("B", 2)
    assert any("reserve" in r.message for r in caplog.records)
    cache.set_quota("A", None)
    assert cache.quotas() == {"B": 2}


# -- priority shedding / brownout ---------------------------------------------
def test_priority_validation_and_inverted_watermarks(monkeypatch):
    srv = _server(tmx)
    for p in (99, -1):
        with pytest.raises(tmx.serving.BadRequest, match="priority class"):
            srv.infer_async("A", _x(), priority=p)
    srv.stop(drain=False)
    monkeypatch.setenv("MXNET_SERVING_BROWNOUT_LOW", "0.8")
    with pytest.raises(ValueError, match="hysteresis"):
        _server(tmx)


def _brownout_scenario(mx):
    srv = _server(mx, queue_depth=8, batch_wait_ms=1.0)
    futs = [srv.infer_async("A", _x(seed=i), priority=2) for i in range(6)]
    entered = srv.stats()["brownout"]
    with pytest.raises(mx.serving.QueueFull) as exc:
        srv.infer_async("A", _x(), priority=2)
    hi = srv.infer_async("A", _x(), priority=0)
    queued = srv.stats()["per_model"]["A"]
    srv.start()
    hi_out = hi.result()[0]
    outcomes = []
    for f in futs:
        try:
            outcomes.append(f.result()[0])
        except mx.serving.DeadlineExceeded as err:
            assert err.retry_after_s is not None
            outcomes.append("shed")
    deadline = time.time() + 10
    while srv.stats()["brownout"]["active"] and time.time() < deadline:
        time.sleep(0.02)
    st = srv.stats()
    srv.stop(drain=False)
    return (entered, str(exc.value), queued["sheds"], queued["requests"],
            st["brownout"], st["per_model"]["A"]["sheds"],
            st["per_model"]["A"]["requests"], hi_out, outcomes)


def test_brownout_rejects_and_sheds_lowest_class():
    port, jax = _both(_brownout_scenario)
    assert port[:7] == jax[:7]
    assert port[0]["active"] and not port[4]["active"]
    assert port[4]["entered"] == 1
    assert {s["reason"] for s in port[5]} == {"brownout_reject",
                                              "brownout_queue"}
    assert _ledger_balances(port[6])
    _close(port[7], jax[7])
    assert [isinstance(o, str) for o in port[8]] == \
        [isinstance(o, str) for o in jax[8]]
    for a, b in zip(port[8], jax[8]):
        if not isinstance(a, str):
            _close(a, b)


def _shrink_scenario(mx):
    srv = _server(mx, queue_depth=8)
    futs = [srv.infer_async("A", _x(seed=i), priority=0) for i in range(8)]
    bo = srv.stats()["brownout"]
    srv.start()
    outs = [f.result()[0] for f in futs]
    occ = srv.stats()["batches"]["occupancy"]
    srv.stop(drain=False)
    return bo, max(occ), outs


def test_brownout_shrinks_dispatch_size(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_BROWNOUT_MAX_BATCH", "2")
    port, jax = _both(_shrink_scenario)
    assert port[:2] == jax[:2]
    assert port[0]["active"] and port[0]["max_batch"] == 2 and port[1] <= 2
    for a, b in zip(port[2], jax[2]):
        _close(a, b)


def _doomed_scenario(mx):
    srv = _server(mx, queue_depth=8)
    # a 60 s execute estimate: a request with 30 s left is doomed, one
    # with 120 s is not, and no client deadline passes while the batcher
    # decides, however loaded the machine
    with srv._mlock:
        srv._exec_ms["A"] = [60000.0] * 10
        srv._exec_est["A"] = 60000.0
    lone = srv.infer_async("A", _x(), timeout_ms=120000.0)
    futs = [srv.infer_async("A", _x(), priority=1, timeout_ms=120000.0)
            for _ in range(5)]
    active = srv.stats()["brownout"]["active"]
    doomed = srv.infer_async("A", _x(), timeout_ms=30000.0, priority=1)
    srv.start()
    with pytest.raises(mx.serving.DeadlineExceeded, match="shed") as exc:
        doomed.result()
    lone.result()
    for f in futs:
        f.result()
    ok = srv.infer("B", _x(), timeout_ms=20000.0)[0]
    pm = srv.stats()["per_model"]
    srv.stop(drain=False)
    return (active, exc.value.retry_after_s is not None, pm["A"]["sheds"],
            pm["A"]["requests"], pm["B"]["sheds"], ok)


def test_doomed_requests_shed_before_dispatch():
    port, jax = _both(_doomed_scenario)
    assert port[:5] == jax[:5]
    assert port[0] and port[1] and port[3]["shed"] == 1
    assert [s["reason"] for s in port[2]] == ["doomed"]
    _close(port[5], jax[5])


def _stop_scenario(mx):
    srv = _server(mx)
    srv.set_quota("A", inflight=3)
    futs = [srv.infer_async("A", _x()) for _ in range(3)]  # noqa: F841
    srv.stop(drain=False)
    before = srv.stats()["per_model"]["A"]
    srv.start()
    out = srv.infer("A", _x())[0]
    srv.stop(drain=False)
    return before["requests"], before["inflight"], out


def test_stop_without_drain_balances_ledger_and_releases_inflight():
    port, jax = _both(_stop_scenario)
    assert port[:2] == jax[:2]
    assert _ledger_balances(port[0]) and port[1] == 0
    _close(port[2], jax[2])


# -- canary staged promotion --------------------------------------------------
EVIDENCE = [
    # (ctor args, [record kwargs...], evaluate now_s offset or None)
    (dict(min_requests=4, max_error_rate=0.1, p99_factor=2.0,
          timeout_s=600.0, baseline_seed_lat=[10.0] * 20),
     [dict(version=2, served=4, latencies=[11.0] * 4)]),
    (dict(min_requests=4, max_error_rate=0.1, p99_factor=2.0,
          timeout_s=600.0, baseline_seed_lat=[10.0] * 20),
     [dict(version=2, served=4, latencies=[11.0] * 4),
      dict(version=2, nonfinite=True)]),
    (dict(min_requests=4, max_error_rate=0.1, p99_factor=2.0,
          timeout_s=600.0),
     [dict(version=2, served=2, failed=2, latencies=[1.0, 1.0])]),
    (dict(min_requests=4, max_error_rate=0.5, p99_factor=2.0,
          timeout_s=600.0, baseline_seed_lat=[10.0] * 20),
     [dict(version=2, served=4, latencies=[100.0] * 4)]),
    (dict(min_requests=4, max_error_rate=0.5, p99_factor=2.0,
          timeout_s=600.0, baseline_seed_lat=[1.0] * 20),
     [dict(version=1, latencies=[50.0] * 9),
      dict(version=2, served=4, latencies=[60.0] * 4)]),
    (dict(min_requests=100, max_error_rate=0.1, p99_factor=2.0,
          timeout_s=0.0),
     [dict(version=2, served=1, latencies=[1.0])]),
    (dict(min_requests=100, max_error_rate=0.1, p99_factor=2.0,
          timeout_s=0.0), []),
    (dict(min_requests=10, max_error_rate=0.1, p99_factor=2.0,
          timeout_s=600.0), [dict(version=2, served=3)]),
]


@pytest.mark.parametrize("case", range(len(EVIDENCE)))
def test_canary_verdicts_equal_the_jax_packages(case):
    kw, records = EVIDENCE[case]
    out = []
    for mx in PKGS:
        st = mx.serving.CanaryState("m", 1, 2, 0.5, **kw)
        verdicts = [st.evaluate()]
        for rec in records:
            st.record(**rec)
            verdicts.append(st.evaluate())
        desc = st.describe()
        desc.pop("decision_latency_s")
        out.append((verdicts, desc))
    assert out[0] == out[1]


def _staged(mx, fraction, **gates):
    srv = _server(mx, canary_fraction=fraction)
    srv.start()
    srv.warmup("A")
    sym, arg = _make_model(mx, 7)
    v2 = srv.add_model("A", sym, arg, {}, {"data": (1, IN_DIM)})
    srv.warmup_version("A", v2)
    srv.begin_canary("A", v2, fraction=fraction, **gates)
    return srv, v2


def _settle(srv, send, limit=400):
    """Serial requests until the canary decides; the answers."""
    outs = []
    for i in range(limit):
        if srv.canary_status("A")["live"] is None:
            break
        outs.append(send(i))
    return outs


def _verdict(srv):
    """The canary's verdict.  ``routed`` can count one request more than
    the gate saw: a serial client has its answer before the batcher
    records the batch, and may submit (and be routed) in between."""
    hist = srv.canary_status("A")["history"][-1]
    out = {k: hist[k] for k in ("baseline_version", "canary_version",
                                "fraction", "served", "failed",
                                "nonfinite_batches", "decision", "reason")}
    seen = hist["served"] + hist["failed"]
    assert seen <= hist["routed"] <= seen + 1, hist
    return out


def _same_answers(a, b):
    """Serial answers of two runs that may end one request apart (see
    ``_verdict``)."""
    assert abs(len(a) - len(b)) <= 1
    for x, y in zip(a, b):
        _close(x, y)


def _routing_scenario(mx):
    """The seeded routing draws alone: 300 unversioned lookups against a
    0.3 canary, the batcher never started."""
    srv = _server(mx, canary_fraction=0.3)
    sym, arg = _make_model(mx, 7)
    v2 = srv.add_model("A", sym, arg, {}, {"data": (1, IN_DIM)})
    srv.begin_canary("A", v2)
    base = srv.registry.get("A")
    seq = [srv._canary_route("A", base).version for _ in range(300)]
    routed = srv.canary_status("A")["live"]["routed"]
    srv.stop(drain=False)
    return seq, routed


def test_canary_routing_draws_equal_the_jax_packages():
    port, jax = _both(_routing_scenario)
    assert port == jax
    assert port[1] == port[0].count(2) and 60 < port[1] < 120


def _healthy_scenario(mx):
    srv, v2 = _staged(mx, 0.5, min_requests=8)
    outs = _settle(srv, lambda i: srv.infer("A", _x(seed=i))[0])
    out = (_verdict(srv), srv.registry.get("A").version == v2, outs)
    srv.stop(drain=False)
    return out


def test_canary_healthy_promotion_routes_the_same_requests():
    port, jax = _both(_healthy_scenario)
    assert port[:2] == jax[:2]
    assert port[0]["decision"] == "promoted" and port[1]
    assert port[0]["served"] == 8
    _same_answers(port[2], jax[2])


def _poison_scenario(mx):
    pkg = fault if mx is tmx else jfault
    srv, v2 = _staged(mx, 1.0, min_requests=50)
    with pkg.active_plan({"rules": [
            {"site": "serving.canary.execute", "kind": "nan",
             "times": 0, "where": {"model": "A"}}]}):
        poisoned = srv.infer("A", _x())[0]
    deadline = time.time() + 10
    while srv.canary_status("A")["live"] is not None \
            and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(mx.serving.ModelNotFound):
        srv.registry.get("A", v2)
    after = [srv.infer("A", _x(seed=s))[0] for s in range(3)]
    out = (_verdict(srv), srv.registry.get("A").version,
           bool(np.isnan(poisoned).all()), after)
    srv.stop(drain=False)
    return out


def test_canary_nan_poison_rolls_back_and_unloads():
    port, jax = _both(_poison_scenario)
    assert port[:3] == jax[:3]
    assert port[0]["reason"] == "nonfinite_outputs" and port[1] == 1
    for a, b in zip(port[3], jax[3]):
        assert np.isfinite(a).all()
        _close(a, b)


def _error_rate_scenario(mx):
    pkg = fault if mx is tmx else jfault
    srv, _v2 = _staged(mx, 1.0, min_requests=4, max_error_rate=0.25)
    errors = []

    def send(i):
        try:
            return srv.infer("A", _x(seed=i))[0]
        except Exception as exc:   # noqa: BLE001 — poisoned batches fail
            errors.append(type(exc).__name__)
            return None

    with pkg.active_plan({"rules": [
            {"site": "serving.canary.execute", "kind": "raise",
             "exc": "RuntimeError", "times": 0, "where": {"model": "A"}}]}):
        _settle(srv, send)
    out = (_verdict(srv), srv.registry.get("A").version, errors)
    srv.stop(drain=False)
    return out


def test_canary_error_rate_rolls_back():
    port, jax = _both(_error_rate_scenario)
    assert port == jax
    assert port[0]["reason"] == "error_rate" and port[1] == 1


def _promote_fault_scenario(mx):
    pkg = fault if mx is tmx else jfault
    srv, v2 = _staged(mx, 1.0, min_requests=2)
    with pkg.active_plan({"rules": [
            {"site": "serving.canary.promote", "kind": "io_error",
             "times": 1}]}) as plan:
        outs = _settle(srv, lambda i: srv.infer("A", _x(seed=i))[0])
    out = (_verdict(srv), srv.registry.get("A").version == v2,
           plan.injected_count(), {o.shape for o in outs})
    srv.stop(drain=False)
    return out


def test_canary_promote_fault_is_contained_and_retried():
    port, jax = _both(_promote_fault_scenario)
    assert port == jax
    assert port[0]["decision"] == "promoted" and port[1] and port[2] == 1
    assert port[3] == {(1, HID)}


def _superseded_scenario(mx):
    srv, v2 = _staged(mx, 0.25, min_requests=1000)
    sym, arg = _make_model(mx, 9)
    v3 = srv.add_model("A", sym, arg, {}, {"data": (1, IN_DIM)})
    st3 = srv.promote_version("A", v3)
    gone = False
    try:
        srv.registry.get("A", v2)
    except mx.serving.ModelNotFound:
        gone = True
    out = (st3.canary_version, _verdict(srv),
           srv.canary_status("A")["live"]["canary_version"], gone)
    srv.stop(drain=False)
    return out


def test_canary_superseded_by_newer_version():
    port, jax = _both(_superseded_scenario)
    assert port == jax
    assert port[1]["reason"] == "superseded" and port[3]


def _watcher_scenario(mx, tmp_path):
    pkg = tmx.checkpoint if mx is tmx else jmx.checkpoint
    root = str(tmp_path / mx.__name__)
    X = np.random.RandomState(0).randn(32, IN_DIM).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=HID, name="fc"), name="softmax")
    if mx is tmx:
        with tmx.cpu():
            it = tmx.io.NDArrayIter(X, y, batch_size=8)
        mod = tmx.mod.Module(net, context=CPU)
        kw = {"ctx": CPU}
    else:
        it = mx.io.NDArrayIter(X, y, batch_size=8)
        mod = mx.mod.Module(net, context=mx.cpu())
        kw = {}
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Xavier())
    mgr = pkg.CheckpointManager(directory=root, async_save=False)
    mgr.save_module(mod, epoch=1, block=True)
    srv = mx.serving.ModelServer(max_batch=4, batch_wait_ms=1.0,
                                 canary_fraction=0.5, **kw)
    watcher = srv.watch_checkpoints(root, "W", start=False)
    first = (watcher.poll_once(), srv.registry.get("W").version)
    mgr.save_module(mod, epoch=2, block=True)
    srv.start()
    second = (watcher.poll_once(), srv.registry.get("W").version,
              srv.canary_status("W")["live"]["canary_version"])
    srv.stop(drain=False)
    srv2 = mx.serving.ModelServer(max_batch=4, batch_wait_ms=1.0,
                                  canary_fraction=0, **kw)
    w2 = srv2.watch_checkpoints(root, "W2", start=False)
    third = (w2.poll_once(), srv2.registry.get("W2").version,
             srv2.canary_status("W2")["live"])
    return first, second, third


def test_watcher_stages_canary_and_direct_without_fraction(tmp_path):
    port, jax = _both(_watcher_scenario, tmp_path=tmp_path)
    assert port == jax
    assert port == ((1, 1), (2, 1, 2), (2, 2, None))


# -- telemetry and stats ------------------------------------------------------
def test_per_model_telemetry_round_trips_exposition():
    from mxnet_tpu_torch import telemetry
    srv = _server(tmx, queue_depth=8)
    srv.set_quota("A", queue_depth=2)
    futs = [srv.infer_async("A", _x()) for _ in range(2)]
    with pytest.raises(tmx.serving.QueueFull):
        srv.infer_async("A", _x())
    srv.start()
    for f in futs:
        f.result()
    srv.infer("A", _x())
    srv.infer("B", _x(2))
    srv.stop(drain=True)
    telemetry.validate_exposition(telemetry.prometheus_text())
    snap = telemetry.snapshot()
    req = snap["mxnet_serving_requests_total"]["values"]
    assert {"A", "B"} <= {v["labels"].get("model") for v in req}
    assert any(v["labels"].get("model") == "A"
               for v in snap["mxnet_serving_queue_depth"]["values"])
    assert all("model" in v["labels"]
               for v in snap["mxnet_serving_cache_events_total"]["values"])


def _stats_scenario(mx):
    srv = _server(mx)
    srv.set_quota("A", queue_depth=4, inflight=8, cache_entries=4)
    srv.start()
    srv.infer("A", _x())
    srv.infer("B", _x())
    snap = srv.stats()
    srv.stop(drain=False)
    rows = {n: sorted(r) for n, r in snap["per_model"].items()}
    return (sorted(set(snap) - {"device", "tuned_config"}), rows,
            snap["per_model"]["A"]["quota"],
            snap["executor_cache"]["per_model"]["A"]["quota"],
            {n: (r["requests"], r["inflight"])
             for n, r in snap["per_model"].items()},
            sorted(snap["compile_cache"]))


def test_stats_sections_equal_the_jax_packages():
    port, jax = _both(_stats_scenario)
    assert port == jax
    assert port[2]["queue_depth"] == 4 and port[3] == 4
