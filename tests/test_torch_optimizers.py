"""The port's optimizers against the JAX package's, on the CPU.

Every optimizer class of the JAX package but SGD and Adam (held in
tests/test_torch_train.py and tests/test_torch_mixed_precision.py) runs
three updates through an ``Updater`` in both packages from the same numpy
weights and gradients: a ``*_weight`` (weight decay), a ``*_bias`` (no
weight decay by MXNet's rule) and a weight with lr and wd multipliers,
plain and with ``rescale_grad``, ``clip_gradient`` and a
``PolyScheduler``; an fp16 weight with ``multi_precision`` apart.  The
weights and the states agree within 1e-6 of each array's largest
magnitude: the same fp32 expressions in the same order, rounded by XLA
and by PyTorch.  ``SGLD``
draws noise from each package's own generator, so its noise is replaced
by zeros in both and held apart by its moments.  Each class's ``.states``
bytes, read with the other package's NDArray class, resume there as that
package's own bytes do.
"""
import io
import math
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
REL = 1e-6

NAMES = {0: "fc_weight", 1: "fc_bias", 2: "conv_weight"}
SHAPES = {0: (6, 5), 1: (6,), 2: (4, 3, 2, 2)}

# (registered name, keyword arguments); a scheduler is built per run
CASES = [
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("signum", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3,
                "wd_lh": 1e-2}),
    ("signum", {"learning_rate": 0.05, "momentum": 0.0, "wd": 1e-3}),
    ("ftml", {"learning_rate": 0.05, "wd": 1e-3}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
               "warmup_strategy": "linear", "warmup_epochs": 1,
               "batch_scale": 4, "updates_per_epoch": 4}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.0,
               "warmup_strategy": "power2", "warmup_epochs": 1,
               "batch_scale": 4, "updates_per_epoch": 4}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9,
               "warmup_strategy": "sqrt", "warmup_epochs": 1,
               "batch_scale": 4, "updates_per_epoch": 4, "begin_epoch": 1}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
               "warmup_strategy": "lars"}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.0, "lamda": 0.1}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.1}),
    ("sgld", {"learning_rate": 0.05, "wd": 1e-3}),
    ("test", {}),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "wd": 1e-3,
                 "clip_weights": 0.9}),
    ("adadelta", {"wd": 1e-3}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01, "wd": 1e-3}),
    ("adamax", {"wd": 1e-3}),
    ("nadam", {"learning_rate": 0.01, "wd": 1e-3}),
]

# gradient conditioning and scheduling shared by the cases, by variant
VARIANTS = {
    "plain": {},
    "conditioned": {"rescale_grad": 0.5, "clip_gradient": 0.8,
                    "poly": (10, 2)},
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _case_id(case):
    name, kw = case
    extra = [k for k in ("momentum", "warmup_strategy", "centered")
             if k in kw]
    return "-".join([name] + ["%s=%s" % (k, kw[k]) for k in extra])


def _inputs(steps=3, seed=5):
    rng = np.random.RandomState(seed)
    w = {i: rng.randn(*s).astype(np.float32) for i, s in SHAPES.items()}
    g = [{i: (rng.randn(*s) * 1.5).astype(np.float32)
          for i, s in SHAPES.items()} for _ in range(steps)]
    return w, g


def _optimizer(mx, name, kw, variant):
    kw = dict(kw)
    v = dict(VARIANTS[variant])
    poly = v.pop("poly", None)
    kw.update(v)
    if poly is not None:
        kw["lr_scheduler"] = mx.lr_scheduler.PolyScheduler(
            max_update=poly[0], base_lr=kw.get("learning_rate", 0.01),
            pwr=poly[1])
    opt = mx.optimizer.create(name, param_idx2name=NAMES, **kw)
    opt.set_lr_mult({"conv_weight": 0.5})
    opt.set_wd_mult({"conv_weight": 2.0})
    return opt


def _nd(mx, a, dtype=None):
    if mx is jmx:
        return mx.nd.array(a, dtype=dtype) if dtype else mx.nd.array(a)
    return mx.nd.array(a, ctx=CPU, dtype=dtype) if dtype \
        else mx.nd.array(a, ctx=CPU)


def _flat_state(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat_state(s)]
    return [state.asnumpy()]


def _run(mx, name, kw, variant="plain", steps=3, states=None, skip=0):
    """``steps`` updates through an Updater (its states first set from
    ``states`` bytes, then the first ``skip`` gradients left out); returns
    (weights, flattened states, the updater's pickled states)."""
    w0, grads = _inputs()
    upd = mx.optimizer.get_updater(_optimizer(mx, name, kw, variant))
    ws = {i: _nd(mx, a) for i, a in w0.items()}
    if states is not None:
        upd.set_states(states)
    for g in grads[skip:skip + steps]:
        for i in sorted(ws):
            upd(i, _nd(mx, g[i]), ws[i])
    return ({i: w.asnumpy() for i, w in ws.items()},
            {i: _flat_state(upd.states[i]) for i in sorted(upd.states)},
            upd.get_states())


class _Across(pickle.Unpickler):
    """Unpickles one package's ``.states`` bytes with the other package's
    NDArray class (the files differ in nothing but its module path)."""

    def __init__(self, data, src, dst):
        super().__init__(io.BytesIO(data))
        self.src, self.dst = src, dst

    def find_class(self, module, name):
        if module.startswith(self.src + "."):
            module = self.dst + module[len(self.src):]
        return super().find_class(module, name)


@pytest.fixture
def no_sgld_noise(monkeypatch):
    """SGLD's noise set to zeros in both packages."""
    import mxnet_tpu.ndarray.random as jrandom
    import mxnet_tpu_torch.optimizer as topt

    def jzeros(loc, scale, shape=None, dtype=None, **kw):
        return jmx.nd.zeros(shape, dtype=dtype or "float32")

    monkeypatch.setattr(jrandom, "normal", jzeros)
    monkeypatch.setattr(topt, "_sgld_noise", lambda weight, lr:
                        weight._data.new_zeros(weight._data.shape))


def _assert_close(got, want):
    for i in want[0]:
        assert _rel(got[0][i], want[0][i]) <= REL, (i, "weight")
        assert len(got[1][i]) == len(want[1][i])
        for a, b in zip(got[1][i], want[1][i]):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert _rel(a, b) <= REL, (i, "state")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_updates_match_the_jax_package(case, variant, no_sgld_noise):
    """Three updates of three arrays: weights and states within 1e-6 of
    each one's largest magnitude, and the weights moved."""
    name, kw = case
    got = _run(tmx, name, kw, variant)
    want = _run(jmx, name, kw, variant)
    _assert_close(got, want)
    w0, _ = _inputs()
    assert _rel(got[0][0], w0[0]) > 1e-4


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_states_load_in_the_other_package(case, writer, no_sgld_noise):
    """The ``.states`` bytes after two updates, read with the other
    package's NDArray class, resume there: one more update gives what
    that package gives resumed from its own bytes, within the band."""
    name, kw = case
    pkgs = {"port": (tmx, "mxnet_tpu_torch"), "jax": (jmx, "mxnet_tpu")}
    reader = "jax" if writer == "port" else "port"
    wmx, wname = pkgs[writer]
    rmx, rname = pkgs[reader]
    blob = _run(wmx, name, kw, steps=2)[2]
    moved = pickle.dumps(_Across(blob, wname, rname).load())
    resumed = _run(rmx, name, kw, steps=1, states=moved, skip=2)
    own = _run(rmx, name, kw, steps=1,
               states=_run(rmx, name, kw, steps=2)[2],
               skip=2)
    _assert_close(resumed, own)


@pytest.mark.parametrize("name,kw", [
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True})])
def test_multi_precision_fp16_matches_the_jax_package(name, kw):
    """An fp16 weight under ``multi_precision=True`` keeps an fp32 master
    in its state, ``(state, master)``: after three updates the masters
    and states agree within the band and the fp16 weights within one
    fp16 rounding of the largest."""
    rng = np.random.RandomState(11)
    w0 = rng.randn(5, 3).astype(np.float16)
    grads = [rng.randn(5, 3).astype(np.float16) for _ in range(3)]
    out = []
    for mx in (tmx, jmx):
        upd = mx.optimizer.get_updater(mx.optimizer.create(
            name, multi_precision=True, **kw))
        w = _nd(mx, w0, "float16")
        for g in grads:
            upd(0, _nd(mx, g, "float16"), w)
        inner, master = upd.states[0]
        out.append((w.asnumpy(), master.asnumpy(), _flat_state(inner)))
    (w, m, st), (jw, jm, jst) = out
    assert w.dtype == np.float16 and m.dtype == np.float32
    assert _rel(w, jw) <= 2.0 ** -10
    assert _rel(m, jm) <= REL
    for a, b in zip(st, jst):
        assert _rel(a, b) <= REL


def test_sgld_noise_moments():
    """The port's SGLD adds N(0, sqrt(lr)) noise: over 200,000 values the
    update minus its noise-free part has mean within 5 standard errors of
    0 and standard deviation within 2% of sqrt(lr)."""
    lr, n = 0.04, 200_000
    rng = np.random.RandomState(3)
    w0 = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    opt = tmx.optimizer.SGLD(learning_rate=lr)
    w = _nd(tmx, w0)
    opt.update(0, w, _nd(tmx, g), None)
    noise = w.asnumpy().astype(np.float64) - (w0 - lr / 2 * g)
    sd = math.sqrt(lr)
    assert abs(noise.mean()) <= 5 * sd / math.sqrt(n)
    assert abs(noise.std() / sd - 1) <= 0.02


def test_registry_names_and_fused_step_eligibility():
    """Every class is reachable by the JAX package's registered name, and
    the executor's fused step takes SGD and Adam only (``ccSGD`` is not
    SGD there, as in the JAX package)."""
    assert set(jmx.optimizer.Optimizer.opt_registry) == \
        set(tmx.optimizer.Optimizer.opt_registry)
    for name in tmx.optimizer.Optimizer.opt_registry:
        klass = tmx.optimizer.Optimizer.opt_registry[name]
        assert klass.__name__ == \
            jmx.optimizer.Optimizer.opt_registry[name].__name__
        fused = tmx.optimizer.fused_update_kernel(klass())
        jfused = jmx.optimizer.fused_update_kernel(
            jmx.optimizer.Optimizer.opt_registry[name]())
        assert (fused is None) == (jfused is None), name
    assert tmx.optimizer.fused_update_kernel(tmx.optimizer.ccSGD()) is None


def test_poly_scheduler_matches_the_jax_package():
    for kw in ({"max_update": 10}, {"max_update": 7, "base_lr": 0.3,
                                    "pwr": 1}):
        got = tmx.lr_scheduler.PolyScheduler(**kw)
        want = jmx.lr_scheduler.PolyScheduler(**kw)
        for n in (0, 1, 3, 6, 7, 10, 12):
            assert got(n) == want(n)
    for bad in (0, 2.5):
        with pytest.raises(ValueError):
            tmx.lr_scheduler.PolyScheduler(bad)


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=5))
        net.add(mx.gluon.nn.Dense(3, in_units=8))
    return net


@pytest.mark.parametrize("name,kw", [
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adagrad", {"learning_rate": 0.1})])
def test_gluon_trainer_matches_the_jax_package(name, kw):
    """``gluon.Trainer`` with the optimizer by name on a two-layer MLP:
    three steps of an L2 loss from the same weights and data, every
    parameter within the band."""
    rng = np.random.RandomState(21)
    x = rng.randn(4, 5).astype(np.float32)
    y = rng.randn(4, 3).astype(np.float32)
    init = None
    out = []
    for mx in (jmx, tmx):
        net = _mlp(mx)
        if mx is jmx:
            net.initialize(mx.init.Xavier())
        else:
            net.initialize(mx.init.Xavier(), ctx=CPU)
        params = net.collect_params()
        keys = sorted(params.keys())
        if init is None:
            init = [rng.randn(*params[k].shape).astype(np.float32) * 0.5
                    for k in keys]
        for k, v in zip(keys, init):
            params[k].set_data(_nd(mx, v))
        trainer = mx.gluon.Trainer(params, name, dict(kw))
        loss_fn = mx.gluon.loss.L2Loss()
        for _ in range(3):
            with mx.autograd.record():
                loss = loss_fn(net(_nd(mx, x)), _nd(mx, y))
            loss.backward()
            trainer.step(4)
        out.append([params[k].data().asnumpy() for k in keys])
    for a, b, w0 in zip(out[1], out[0], init):
        assert _rel(a, b) <= REL
    assert _rel(out[1][0], init[0]) > 1e-4


def test_set_learning_rate_refuses_with_a_scheduler():
    for mx in (jmx, tmx):
        opt = mx.optimizer.NAG(lr_scheduler=mx.lr_scheduler.PolyScheduler(5))
        with pytest.raises(UserWarning):
            opt.set_learning_rate(0.1)
        plain = mx.optimizer.NAG()
        plain.set_learning_rate(0.2)
        assert plain.lr == 0.2


def test_updater_states_roundtrip_within_the_port():
    """``get_states(dump_optimizer=True)`` carries the optimizer with the
    states; ``set_states`` takes both back."""
    upd = tmx.optimizer.get_updater(tmx.optimizer.Nadam(learning_rate=0.1))
    w = _nd(tmx, np.ones((3,), np.float32))
    upd(0, _nd(tmx, np.full((3,), 0.5, np.float32)), w)
    other = tmx.optimizer.get_updater(tmx.optimizer.SGD())
    other.set_states(upd.get_states(dump_optimizer=True))
    assert type(other.optimizer).__name__ == "Nadam"
    assert other.optimizer.m_schedule == upd.optimizer.m_schedule
    buf = io.BytesIO(upd.get_states())
    assert set(pickle.load(buf)) == {0}
