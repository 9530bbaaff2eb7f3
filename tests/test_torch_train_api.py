"""The port's training-loop API against the JAX package, on the CPU:
metrics, initializers, callbacks, ``Monitor`` and the executor's taps,
``viz``, ``engine`` (deferred worker exceptions, ``naive``, ``bulk``),
``random``'s state, ``config``, ``name.Prefix``, ``misc``, ``registry``,
``log`` and the top-level names.

Metrics and the deterministic initializers are held exactly on the same
numpy inputs; the random initializers by property, since the two
packages' random streams differ; the monitor by the names it collects
over the same ``Module.fit``.
"""
import logging
import math
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _nd(mx, a):
    return mx.nd.array(a) if mx is jmx else mx.nd.array(a, ctx=CPU)


def _zeros(mx, shape):
    return mx.nd.zeros(shape) if mx is jmx else mx.nd.zeros(shape, ctx=CPU)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _batches(seed=0, n=6, k=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        p = rng.rand(n, k).astype(np.float32) + 0.05
        out.append((rng.randint(0, k, n).astype(np.float32),
                    p / p.sum(axis=1, keepdims=True)))
    return out


def _regression(seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(6).astype(np.float32),
             rng.randn(6).astype(np.float32)),
            (rng.randn(4, 1).astype(np.float32),
             rng.randn(4, 1).astype(np.float32))]


def _binary(seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        p = rng.rand(8, 2).astype(np.float32)
        out.append((rng.randint(0, 2, 8).astype(np.float32), p))
    return out


def _squared_error(label, pred):
    return float(((label.ravel() - pred.ravel()) ** 2).sum()), label.size


METRIC_CASES = [
    ("f1", {}, _binary),
    ("f1", {"average": "micro"}, _binary),
    ("perplexity", {"ignore_label": None}, _batches),
    ("perplexity", {"ignore_label": 1}, _batches),
    ("mae", {}, _regression),
    ("mse", {}, _regression),
    ("rmse", {}, _regression),
    ("nll_loss", {}, _batches),
    ("negativeloglikelihood", {"eps": 1e-3}, _batches),
    ("pearsonr", {}, _regression),
    ("pearsoncorrelation", {}, _regression),
    ("loss", {}, _regression),
    ("torch", {}, _regression),
    ("caffe", {}, _regression),
]


def _metric_values(mx, name, kw, data):
    m = mx.metric.create(name, **kw)
    seen = []
    for label, pred in data():
        m.update([_nd(mx, label)], [_nd(mx, pred)])
        seen.append(m.get())
    conf = m.get_config()
    m.reset()
    seen.append(m.get())
    return seen, conf


@pytest.mark.parametrize("name,kw,data", METRIC_CASES,
                         ids=["%s-%s" % (c[0], "-".join(c[1])) for c in
                              METRIC_CASES])
def test_metric_matches_the_jax_package(name, kw, data):
    """``update``/``get`` after each batch, ``get_config`` and the nan of
    ``get`` after ``reset``, equal to the JAX package's."""
    got, gconf = _metric_values(tmx, name, kw, data)
    want, wconf = _metric_values(jmx, name, kw, data)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_array_equal([g[1] for g in got],
                                  [w[1] for w in want])
    assert gconf == wconf
    assert math.isnan(got[-1][1])


def test_f1_edge_cases_match_the_jax_package():
    """No predicted positive (precision 0, F1 0), one-dimensional
    probabilities thresholded at 0.5, and more than two classes (both
    raise ValueError)."""
    cases = [
        (np.array([1, 0, 1, 0], np.float32),
         np.array([[0.9, 0.1]] * 4, np.float32)),
        (np.array([1, 0, 1, 1], np.float32),
         np.array([0.7, 0.2, 0.4, 0.51], np.float32)),
        (np.array([0, 0, 0, 0], np.float32),
         np.array([[0.2, 0.8]] * 4, np.float32)),
    ]
    for average in ("macro", "micro"):
        vals = []
        for mx in (tmx, jmx):
            m = mx.metric.F1(average=average)
            row = []
            for label, pred in cases:
                m.update([_nd(mx, label)], [_nd(mx, pred)])
                row.append(m.get()[1])
            vals.append(row)
        assert vals[0] == vals[1]
    for mx in (tmx, jmx):
        with pytest.raises(ValueError, match="binary"):
            mx.metric.F1().update(
                [_nd(mx, np.array([0, 1, 2], np.float32))],
                [_nd(mx, np.eye(3, dtype=np.float32))])


def test_custom_metrics_match_the_jax_package():
    """``CustomMetric`` (value and ``(sum, count)`` returns,
    ``allow_extra_outputs``), ``metric.np``, ``create`` of a function and
    its generated name."""
    data = _regression()
    out = []
    for mx in (tmx, jmx):
        ms = [mx.metric.np(_squared_error),
              mx.metric.CustomMetric(lambda l, p: float(np.abs(l - p).max()),
                                     allow_extra_outputs=True),
              mx.metric.create(_squared_error, name="sq")]
        for label, pred in data:
            ms[0].update([_nd(mx, label)], [_nd(mx, pred)])
            ms[1].update([_nd(mx, label)], [_nd(mx, pred), _nd(mx, pred)])
            ms[2].update([_nd(mx, label)], [_nd(mx, pred)])
        out.append([m.get() for m in ms])
        with pytest.raises(ValueError):
            ms[0].update([_nd(mx, data[0][0])],
                         [_nd(mx, data[0][1])] * 2)
        with pytest.raises(NotImplementedError):
            ms[0].get_config()
    assert out[0] == out[1]
    assert out[0][0][0] == "_squared_error"
    assert out[0][1][0].startswith("custom(")


def test_metric_registry_names_equal_the_jax_package():
    """Every name and alias ``metric.create`` takes in the JAX package
    makes the same class here."""
    from mxnet_tpu.metric import _METRIC_REGISTRY as jreg
    from mxnet_tpu_torch.metric import _METRIC_REGISTRY as treg
    assert set(treg) == set(jreg)
    assert all(treg[k].__name__ == jreg[k].__name__ for k in jreg)


def test_composite_of_new_metrics_matches_the_jax_package():
    data = _batches()
    out = []
    for mx in (tmx, jmx):
        comp = mx.metric.create(["nll_loss", "loss"])
        comp.add(mx.metric.Perplexity(ignore_label=None))
        for label, pred in data:
            comp.update([_nd(mx, label)], [_nd(mx, pred)])
        out.append((comp.get(), comp.get_config()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _init(mx, init, name, shape):
    arr = _zeros(mx, shape)
    init(name, arr)
    return arr.asnumpy()


def _init_attr(mx, init, name, shape):
    """``init`` as a variable's ``__init__`` attr (its ``dumps()``), the
    way a fused RNN's parameters get it, under a global Uniform."""
    arr = _zeros(mx, shape)
    mx.init.Uniform()(mx.init.InitDesc(name, {"__init__": init.dumps()}),
                      arr)
    return arr.asnumpy()


def _rnn_blob(mode, layers, bidir, hidden=3, inputs=5):
    gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
    d = 2 if bidir else 1
    w = d * (gates * hidden * inputs + gates * hidden * hidden)
    w += (layers - 1) * d * (gates * hidden * hidden * d
                             + gates * hidden * hidden)
    return (w + layers * d * 2 * gates * hidden,)


DETERMINISTIC = [
    (lambda mx: mx.init.Constant(0.25), "fc_weight", (3, 4)),
    (lambda mx: mx.init.Constant(-2.0), "fc_bias", (5,)),
    (lambda mx: mx.init.Constant(1.5), "foo_state", (2, 2)),
    (lambda mx: mx.init.Bilinear(), "up_weight", (2, 3, 4, 4)),
    (lambda mx: mx.init.Bilinear(), "up_weight", (1, 1, 3, 5)),
    (lambda mx: mx.init.LSTMBias(forget_bias=2.0), "lstm_bias", (12,)),
    (lambda mx: mx.init.LSTMBias(), "lstm_i2h_weight", (8,)),
] + [
    (lambda mx, m=mode, l=layers, b=bidir: mx.init.FusedRNN(
        mx.init.Constant(0.5), num_hidden=3, num_layers=l, mode=m,
        bidirectional=b, forget_bias=1.5), "rnn_parameters",
     _rnn_blob(mode, layers, bidir))
    for mode in ("lstm", "gru", "rnn_tanh")
    for layers, bidir in ((1, False), (2, True))
]


@pytest.mark.parametrize("make,name,shape", DETERMINISTIC,
                         ids=["%d-%s" % (i, c[1]) for i, c in
                              enumerate(DETERMINISTIC)])
def test_deterministic_initializers_equal_the_jax_package(make, name, shape):
    run = _init_attr if name == "rnn_parameters" else _init
    got = run(tmx, make(tmx), name, shape)
    want = run(jmx, make(jmx), name, shape)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_fused_rnn_from_a_dumped_initializer_equals_the_jax_package():
    """``FusedRNN`` takes its inner initializer as ``dumps()`` JSON too;
    ``dumps`` of each package's FusedRNN is the same string."""
    shape = _rnn_blob("lstm", 2, True)
    outs = []
    for mx in (tmx, jmx):
        init = mx.init.FusedRNN(mx.init.Constant(0.1).dumps(), 3, 2, "lstm",
                                bidirectional=True)
        outs.append((_init_attr(mx, init, "rnn_parameters", shape),
                     init.dumps()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


def test_load_and_mixed_equal_the_jax_package():
    rng = np.random.RandomState(4)
    params = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
              "aux:bn_moving_var": rng.rand(4).astype(np.float32)}
    for mx in (tmx, jmx):
        load = mx.init.Load({k: _nd(mx, v) for k, v in params.items()},
                            default_init=mx.init.Constant(3.0))
        np.testing.assert_array_equal(_init(mx, load, "fc_weight", (3, 4)),
                                      params["arg:fc_weight"])
        np.testing.assert_array_equal(
            _init(mx, load, "bn_moving_var", (4,)),
            params["aux:bn_moving_var"])
        np.testing.assert_array_equal(_init(mx, load, "fc_bias", (3,)),
                                      np.zeros(3, np.float32))
        with pytest.raises(AssertionError, match="Shape mismatch"):
            _init(mx, load, "fc_weight", (4, 3))
        with pytest.raises(AssertionError, match="Not found"):
            _init(mx, mx.init.Load({}), "x_weight", (2,))
        mixed = mx.init.Mixed([".*weight", ".*"],
                              [mx.init.Constant(1.0), mx.init.Constant(7.0)])
        np.testing.assert_array_equal(_init(mx, mixed, "fc_weight", (2,)),
                                      np.ones(2, np.float32))
        np.testing.assert_array_equal(_init(mx, mixed, "x_state", (2,)),
                                      np.full(2, 7.0, np.float32))
        np.testing.assert_array_equal(_init(mx, mixed, "fc_bias", (2,)),
                                      np.zeros(2, np.float32))
        with pytest.raises(ValueError, match="did not match"):
            _init(mx, mx.init.Mixed(["a.*"], [mx.init.Zero()]), "b", (1,))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(4, 3, 2, 2), (12, 4)])
def test_orthogonal_is_orthogonal(shape, rand_type):
    """Q's rows (more columns than rows) or columns are orthogonal, of
    norm ``scale``: Q Q^T or Q^T Q = scale^2 I within 1e-5, in both
    packages."""
    scale = 1.3
    for mx in (tmx, jmx):
        q = _init(mx, mx.init.Orthogonal(scale=scale, rand_type=rand_type),
                  "w_weight", shape).reshape(shape[0], -1).astype(np.float64)
        gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)),
                                   atol=1e-5)


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_msra_prelu_variance(factor_type):
    """MSRAPrelu is Gaussian Xavier of magnitude 2 / (1 + slope^2): over
    589,824 values the sample variance lies within 3 standard errors of
    magnitude / fan, and the mean within 3 of 0, in both packages."""
    shape, slope = (64, 96, 3, 32), 0.25
    fan = {"avg": (96 + 64) * 96 / 2.0, "in": 96 * 96.0,
           "out": 64 * 96.0}[factor_type]
    var = 2.0 / (1 + slope ** 2) / fan
    n = int(np.prod(shape))
    for mx in (tmx, jmx):
        a = _init(mx, mx.init.MSRAPrelu(factor_type, slope), "c_weight",
                  shape).astype(np.float64)
        assert abs(a.var() - var) <= 3 * var * math.sqrt(2.0 / (n - 1))
        assert abs(a.mean()) <= 3 * math.sqrt(var / n)
    assert tmx.init.MSRAPrelu(factor_type, slope).dumps() == \
        jmx.init.MSRAPrelu(factor_type, slope).dumps()


def test_initializer_registry_and_verbosity(caplog):
    names = {"zero", "one", "constant", "uniform", "normal", "orthogonal",
             "xavier", "msraprelu", "bilinear", "lstmbias", "fusedrnn"}
    from mxnet_tpu.initializer import _INITIALIZER_REGISTRY as jreg
    from mxnet_tpu_torch.initializer import _INITIALIZER_REGISTRY as treg
    assert set(treg) == set(jreg) == names
    init = tmx.init.create('["constant", {"value": 2.0}]')
    assert isinstance(init, tmx.init.Constant) and init.value == 2.0
    with caplog.at_level(logging.INFO):
        init.set_verbosity(True)("fc_weight", _zeros(tmx, (2,)))
    assert "Initialized fc_weight as weight" in caplog.text


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------
def _callback_lines(mx, caplog, make):
    metric = mx.metric.create("mse")
    label, pred = _regression()[0]
    metric.update([_nd(mx, label)], [_nd(mx, pred)])
    caplog.clear()
    cb = make(mx)
    with caplog.at_level(logging.INFO):
        for nbatch in range(4):
            cb(mx.model.BatchEndParam(epoch=2, nbatch=nbatch,
                                      eval_metric=metric, locals=None))
    return [r.getMessage() for r in caplog.records], metric.get()


@pytest.mark.parametrize("make", [
    lambda mx: mx.callback.log_train_metric(2),
    lambda mx: mx.callback.log_train_metric(1, auto_reset=True),
    lambda mx: mx.callback.ProgressBar(4, length=20),
    lambda mx: mx.callback.LogValidationMetricsCallback()],
    ids=["log_train_metric", "log_train_metric-reset", "ProgressBar",
         "LogValidationMetricsCallback"])
def test_callbacks_log_what_the_jax_package_logs(make, caplog):
    got = _callback_lines(tmx, caplog, make)
    want = _callback_lines(jmx, caplog, make)
    assert got[0] == want[0] and got[0]
    assert got[1][0] == want[1][0]
    assert got[1][1] == want[1][1] or (math.isnan(got[1][1])
                                       and math.isnan(want[1][1]))


# ---------------------------------------------------------------------------
# Monitor and the executor's taps
# ---------------------------------------------------------------------------
def _monitor_net(mx, bn=False):
    d = mx.sym.Variable("data")
    c = mx.sym.Convolution(d, num_filter=4, kernel=(3, 3), pad=(1, 1),
                           name="conv0")
    if bn:
        c = mx.sym.BatchNorm(c, fix_gamma=False, name="bn0")
    a = mx.sym.Activation(c, act_type="relu", name="relu0")
    p = mx.sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="pool0")
    f = mx.sym.FullyConnected(mx.sym.Flatten(p, name="flat0"),
                              num_hidden=3, name="fc1")
    return mx.sym.SoftmaxOutput(f, name="softmax")


def _monitored_fit(mx, pattern, monitor_all):
    rng = np.random.RandomState(0)
    x = rng.randn(8, 2, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    mon = mx.Monitor(1, pattern=pattern, monitor_all=monitor_all)
    windows = []
    mon.toc_print = lambda: windows.append(mon.toc())
    kw = {} if mx is jmx else {"context": CPU}
    mod = mx.mod.Module(_monitor_net(mx), **kw)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            monitor=mon, optimizer_params={"learning_rate": 0.1})
    return windows


@pytest.mark.parametrize("monitor_all", [False, True])
@pytest.mark.parametrize("pattern", [".*", ".*(conv0|fc1).*"])
def test_monitor_collects_the_jax_package_names(pattern, monitor_all):
    """Over a two-batch ``Module.fit(monitor=...)`` both packages collect
    the same names in the same order each batch, every stat finite."""
    got = _monitored_fit(tmx, pattern, monitor_all)
    want = _monitored_fit(jmx, pattern, monitor_all)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert [r[:2] for r in g] == [r[:2] for r in w]
        for _, _, stat in g:
            assert np.isfinite(float(stat.strip("[]")))
    names = {r[1] for r in got[0]}
    assert ("relu0_output" in names) == (monitor_all and pattern == ".*")


def _step(mon=None, monitor_all=False, is_train=True, knob="0",
          monkeypatch=None):
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", knob)
    rng = np.random.RandomState(3)
    sym = _monitor_net(tmx, bn=True)
    exe = sym.simple_bind(ctx=CPU, data=(4, 2, 6, 6), softmax_label=(4,))
    for name, arr in exe.arg_dict.items():
        arr[:] = rng.randn(*arr.shape).astype(np.float32)
    exe.arg_dict["softmax_label"][:] = np.array([0, 1, 2, 1], np.float32)
    for name, arr in exe.aux_dict.items():
        arr[:] = rng.rand(*arr.shape).astype(np.float32) + 0.5
    seen = []
    if mon:
        exe.set_monitor_callback(lambda n, a: seen.append(
            (n, a.asnumpy().copy())), monitor_all=monitor_all)
    out = exe.forward(is_train=is_train)[0].asnumpy()
    grads = {}
    if is_train:
        exe.backward()
        grads = {n: g.asnumpy() for n, g in exe.grad_dict.items()}
    return out, grads, exe.aux_dict["bn0_moving_mean"].asnumpy(), seen


@pytest.mark.parametrize("knob,is_train", [("0", True), ("0", False),
                                           ("1", False)])
def test_taps_leave_results_bitwise(knob, is_train, monkeypatch):
    """With a callback installed (heads, or every node) the outputs,
    gradients and moving stats equal an unmonitored run's bitwise; every
    op node is tapped once, and an eval BatchNorm that the peephole folds
    into its ReLU (knob 1) is still reported with its own output."""
    plain = _step(is_train=is_train, knob=knob, monkeypatch=monkeypatch)
    for monitor_all in (False, True):
        got = _step(True, monitor_all, is_train, knob, monkeypatch)
        np.testing.assert_array_equal(got[0], plain[0])
        np.testing.assert_array_equal(got[2], plain[2])
        for n in plain[1]:
            np.testing.assert_array_equal(got[1][n], plain[1][n])
        names = [n for n, _ in got[3]]
        if monitor_all:
            sym = _monitor_net(tmx, bn=True)
            variables = set(sym.list_inputs())
            assert names == [n for n in sym.get_internals().list_outputs()
                             if n not in variables]
            assert names[:4] == ["conv0_output", "bn0_output0",
                                 "bn0_output1", "bn0_output2"]
            np.testing.assert_array_equal(got[3][-1][1], plain[0])
        else:
            assert names == ["softmax_output"]


def test_install_monitor_needs_a_bound_module():
    mod = tmx.mod.Module(_monitor_net(tmx), context=CPU)
    with pytest.raises(RuntimeError):
        mod.install_monitor(tmx.Monitor(1))


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------
def test_print_summary_text_equals_the_jax_package(capsys):
    outs = []
    for mx in (tmx, jmx):
        sym = _monitor_net(mx, bn=True)
        total = mx.viz.print_summary(sym, shape={"data": (1, 2, 6, 6)})
        total_no_shape = mx.viz.print_summary(sym)
        outs.append((capsys.readouterr().out, total, total_no_shape))
    assert outs[0] == outs[1]
    assert outs[0][1] == 4 * 2 * 9 + 4 + 4 + 4 + 3 * 36 + 3


def test_plot_network_follows_the_jax_package():
    """With graphviz installed both give the same dot source; without it
    both raise ImportError."""
    res = []
    for mx in (tmx, jmx):
        try:
            res.append(mx.viz.plot_network(_monitor_net(mx, bn=True)).source)
        except ImportError as e:
            res.append(("ImportError", str(e)))
    assert res[0] == res[1]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _orphan(mx, deliver, exc):
    def work():
        with mx.engine.worker_scope(deliver):
            raise exc
    t = threading.Thread(target=work)
    t.start()
    t.join()


@pytest.mark.parametrize("deliver", [None, lambda e: False,
                                     lambda e: 1 / 0],
                         ids=["none", "no-receiver", "deliver-raises"])
@pytest.mark.parametrize("mx", [tmx, jmx], ids=["port", "jax"])
def test_orphaned_worker_exception_raises_at_the_next_sync(mx, deliver):
    """A worker exception nobody received raises once, at the next
    ``nd.waitall()``, and never again after it."""
    mx.engine.clear_exception()
    exc = ValueError("orphaned")
    _orphan(mx, deliver, exc)
    with pytest.raises(ValueError, match="orphaned") as info:
        mx.nd.waitall()
    assert info.value is exc
    mx.nd.waitall()


@pytest.mark.parametrize("mx", [tmx, jmx], ids=["port", "jax"])
def test_each_sync_point_rethrows(mx):
    """``asnumpy`` and ``wait_to_read`` rethrow too; a delivered exception
    raises nowhere; ``consume_exception`` drops only its own exception."""
    mx.engine.clear_exception()
    a = _nd(mx, np.ones(3, np.float32))
    for sync in (a.asnumpy, a.wait_to_read):
        _orphan(mx, None, KeyError("k"))
        with pytest.raises(KeyError):
            sync()
        sync()
    _orphan(mx, lambda e: True, KeyError("delivered"))
    mx.nd.waitall()
    first, second = RuntimeError("first"), RuntimeError("second")
    mx.engine.record_exception(first)
    mx.engine.record_exception(second)
    mx.engine.consume_exception(second)
    with pytest.raises(RuntimeError, match="first"):
        mx.engine.check_raise()
    mx.engine.record_exception(first)
    mx.engine.consume_exception(first)
    mx.engine.check_raise()


@pytest.mark.parametrize("mx", [tmx, jmx], ids=["port", "jax"])
def test_naive_and_bulk_scopes(mx):
    assert not mx.engine.naive_scope_active()
    with mx.engine.naive():
        with mx.engine.naive():
            assert mx.engine.naive_scope_active()
        assert mx.engine.naive_scope_active()
        b = (_nd(mx, np.arange(4, dtype=np.float32)) * 2).asnumpy()
    assert not mx.engine.naive_scope_active()
    np.testing.assert_array_equal(b, [0, 2, 4, 6])
    prev = mx.engine.set_bulk_size(7)
    with mx.engine.bulk(3):
        assert mx.engine.set_bulk_size(3) == 3
    assert mx.engine.set_bulk_size(prev) == 7


# ---------------------------------------------------------------------------
# random, config, names
# ---------------------------------------------------------------------------
def test_random_state_round_trips():
    """The draws after ``set_state`` equal the uninterrupted run's (the
    JAX package's contract), on the CPU generator and on a generator
    created after the snapshot."""
    tmx.random.seed(11)
    tmx.nd.random.normal(shape=(3,), ctx=CPU)
    state = tmx.random.get_state()
    first = [tmx.nd.random.uniform(shape=(5,), ctx=CPU).asnumpy()
             for _ in range(3)]
    tmx.random.set_state(state)
    again = [tmx.nd.random.uniform(shape=(5,), ctx=CPU).asnumpy()
             for _ in range(3)]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert state["seed"] == 11
    for mx in (jmx,):
        mx.random.seed(11)
        st = mx.random.get_state()
        x = mx.nd.random.uniform(shape=(5,)).asnumpy()
        mx.random.set_state(st)
        np.testing.assert_array_equal(
            mx.nd.random.uniform(shape=(5,)).asnumpy(), x)


def test_config_list_env_and_check_unknown(monkeypatch):
    monkeypatch.setenv("MXNET_NO_SUCH_KNOB_X", "1")
    for mx in (tmx, jmx):
        table = mx.config.list_env().splitlines()
        assert table[0] == "| variable | type | default | description |"
        assert any(r.startswith("| MXNET_PALLAS_BN_RELU |") for r in table)
        assert "MXNET_NO_SUCH_KNOB_X" in mx.config.check_unknown()
        assert "MXNET_PALLAS_BN_RELU" not in mx.config.check_unknown()
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "0")
    assert "MXNET_PALLAS_BN_RELU" not in tmx.config.check_unknown()


def test_top_level_names_and_prefix():
    assert tmx.__version__ == jmx.__version__
    assert tmx.num_tpus() == tmx.num_gpus()
    assert tmx.Symbol is tmx.sym.Symbol
    assert tmx.Optimizer is tmx.optimizer.Optimizer
    assert tmx.Monitor is tmx.monitor.Monitor
    assert tmx.viz is tmx.visualization
    args = []
    for mx in (tmx, jmx):
        with mx.Prefix("p_"):
            net = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                        num_hidden=2)
        with mx.NameManager():
            other = mx.sym.FullyConnected(mx.sym.Variable("x"),
                                          num_hidden=2)
        args.append((net.list_arguments(), other.list_arguments()))
    assert args[0] == args[1]
    for mx in (tmx, jmx):
        with pytest.raises(mx.base.MXNetError):
            mx.autograd.get_symbol(_nd(mx, np.ones(2, np.float32)))


def test_misc_registry_and_log():
    with pytest.warns(DeprecationWarning):
        got = tmx.misc.FactorScheduler(step=2, factor=0.5)
    with pytest.warns(DeprecationWarning):
        want = jmx.misc.FactorScheduler(step=2, factor=0.5)
    got._impl.base_lr = want._impl.base_lr = 1.0
    assert [got(n) for n in range(7)] == [want(n) for n in range(7)]
    sched = tmx.misc.multi_factor_scheduler(1, 10, step=(2, 4))
    assert sched.step == jmx.misc.multi_factor_scheduler(1, 10,
                                                         step=(2, 4)).step
    assert tmx.misc.multi_factor_scheduler(5, 10, step=(2,)) is None

    class Base:
        pass

    register = tmx.registry.get_register_func(Base, "thing")
    create = tmx.registry.get_create_func(Base, "thing")

    @register
    class Widget(Base):
        def __init__(self, size=1):
            self.size = size

    assert create("widget", size=3).size == 3
    assert create('{"thing": "Widget", "size": 4}').size == 4
    with pytest.raises(MXNetError):
        create("gadget")
    logger = tmx.log.get_logger("mxnet_tpu_torch.test", level=tmx.log.INFO)
    assert logger.level == logging.INFO and logger.handlers


# ---------------------------------------------------------------------------
# chip_smoke.py phase 16, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_training_loop_phase_rehearses_on_the_cpu(monkeypatch):
    """``loop_optimizers``, ``loop_fit``, ``loop_monitor_bitwise`` and
    ``loop_engine`` on a ResNet-20 at 3x28x28, batch 4, with the kernel
    knobs at 1 and counting wrappers: every optimizer's CPU replay equals
    the update itself bitwise (the same device), K2 once a step and no
    sweep; the fit's metrics within the band of numpy's, a monitor window
    each batch, the callbacks' lines; the monitored steps bitwise."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    for knob in ("MXNET_PALLAS_SOFTMAX", "MXNET_PALLAS_BN_RELU"):
        monkeypatch.setenv(knob, "1")
    seen = {}

    def counting(name, fn):
        def wrapper(*a, **kw):
            if a[0].device.type != "meta":
                seen[name] = seen.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ck.kernel_calls():
        monkeypatch.setattr(ck, name, counting(name, getattr(ck, name)))
    monkeypatch.setattr(ck, "reset_kernel_calls", seen.clear)
    monkeypatch.setattr(ck, "kernel_calls", lambda: dict(seen))
    image, batch = (3, 28, 28), 4
    with tmx.NameManager():     # leave the thread's node counts alone
        sym = chip_smoke.resnet_symbol(20, image)
    res = chip_smoke.loop_optimizers(tmx, ck, CPU, sym, image, batch=batch,
                                     timed=1)
    assert len(res) == 14 and chip_smoke.loop_failures(res) == []
    assert all(r["weights"] == 0.0 and r["states_max_rel"] == 0.0
               for r in res.values())
    assert res["ftml"]["states"] == 3 * res["nag"]["states"] > 0
    mod, fit = chip_smoke.loop_fit(tmx, ck, CPU, sym, image, batch=batch)
    sites = len(chip_smoke.k3_sites(tmx, sym, batch, image))
    n = chip_smoke.LOOP_FIT_EPOCHS * chip_smoke.LOOP_FIT_BATCHES
    assert fit["calls"] == {"softmax_lastaxis": n + 2,
                            "scale_bias_relu": 2 * sites}
    assert fit["metric_max_rel"] <= chip_smoke.LOOP_METRIC_TOL
    assert fit["metric_names"] == ["perplexity", "nll-loss", "loss",
                                   "_top_prob"]
    assert fit["monitor_windows"] == n and fit["monitor_finite"]
    assert all(w == ["conv0_weight", "fc1_bias", "fc1_weight"]
               for w in fit["monitor_names"])
    assert (fit["log_speed"], fit["log_train"], fit["log_progress"],
            fit["log_validation"]) == (2, 4 * n, n, 16)
    mon = chip_smoke.loop_monitor_bitwise(tmx, mod, CPU, image, batch=batch,
                                          steps=2)
    assert mon["bitwise_on_vs_off"] and mon["bitwise_off_vs_off"]
    assert mon["records_a_step_on"] > 100
    eng = chip_smoke.loop_engine(tmx, CPU, n=1000)
    assert eng["raised_at_waitall"] is True and eng["raised_again"] is False
