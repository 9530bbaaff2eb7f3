"""The port's samplers on the CPU: moments, shapes and dtypes against the
JAX package's, determinism under ``mx.random.seed``, per-device
generators, and the samplers inside graphs (``Dropout``, ``rrelu``,
``sym.random``).

The two packages draw from different streams (threefry and Philox), so
values are never compared: each sampler's mean and variance over
RANDOM_DRAWS draws lie within 5 standard errors of the distribution's
(``chip_smoke.random_sweep``, which phase 14 runs on the card with 10^6
draws); shapes and dtypes equal the JAX package's for every sampler
name.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.ops.registry import _OP_REGISTRY

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

CPU = tmx.cpu()
RANDOM_DRAWS = 200000
# Dropout, LeakyReLU (rrelu) and RNN (between its layers) draw masks;
# they are not samplers
SAMPLERS = sorted(n for n, op in _OP_REGISTRY.items()
                  if op.needs_rng and op.name not in ("Dropout",
                                                      "LeakyReLU", "RNN"))


def test_the_sweep_holds_every_samplers_moments():
    res = chip_smoke.random_sweep(tmx, CPU, n=RANDOM_DRAWS)
    assert res["failed"] == [] and res["checks"] > 60


def _call(mx, name, ctx):
    op = _OP_REGISTRY[name]
    if not op.sig.required:
        kw = {"shape": (4, 3)}
        if ctx is not None:
            kw["ctx"] = ctx
        return getattr(mx.nd, name)(**kw)
    if name in ("_sample_multinomial", "sample_multinomial"):
        p = np.array([[0.2, 0.8], [0.5, 0.5]], np.float32)
        return getattr(mx.nd, name)(mx.nd.array(p, ctx=ctx) if ctx else
                                    mx.nd.array(p), shape=(3,),
                                    get_prob=True)
    args = [np.full((2,), v, np.float32) for v in (1.0, 0.5)][
        :len(op.sig.required)]
    nds = [mx.nd.array(a, ctx=ctx) if ctx else mx.nd.array(a)
           for a in args]
    if op.name.startswith("_sample_"):
        return getattr(mx.nd, name)(*nds, shape=(5,))
    return getattr(mx.nd, name)(*nds)


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_shape_and_dtype_match_the_jax_package(name):
    got, want = _call(tmx, name, CPU), _call(jmx, name, None)
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [str(g.dtype) for g in got] == [str(np.dtype(w.dtype))
                                           for w in want]
    assert all(g.context == CPU for g in got)


def test_seed_replays_and_generators_are_per_device():
    tmx.random.seed(7)
    a = tmx.nd.random.normal(0, 1, shape=(64,), ctx=CPU).asnumpy()
    b = tmx.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    tmx.random.seed(7)
    np.testing.assert_array_equal(
        tmx.nd.random.normal(0, 1, shape=(64,), ctx=CPU).asnumpy(), a)
    np.testing.assert_array_equal(
        tmx.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy(), b)
    tmx.random.seed(8)
    assert not np.array_equal(
        tmx.nd.random.normal(0, 1, shape=(64,), ctx=CPU).asnumpy(), a)
    # seeding the CPU's generator alone replays the CPU's draws
    tmx.random.seed(7, ctx=CPU)
    np.testing.assert_array_equal(
        tmx.nd.random.normal(0, 1, shape=(64,), ctx=CPU).asnumpy(), a)
    gen = trandom.generator(torch.device("cpu"))
    state = gen.get_state()
    x = tmx.nd.random.gamma(2.0, 1.5, shape=(16,), ctx=CPU)
    assert not torch.equal(gen.get_state(), state)  # drew from this one
    assert x.dtype == "float32"
    # NDArray parameters: one distribution per element, on their device
    lo = tmx.nd.array([0.0, 10.0], ctx=CPU)
    s = tmx.nd.random.uniform(lo, 11.0, shape=(1000,))
    assert s.shape == (2, 1000) and s.context == CPU
    h = s.asnumpy()
    assert h[0].min() >= 0 and h[0].max() < 11 and h[1].min() >= 10
    r = tmx.nd.random.randint(-3, 3, shape=(500,), ctx=CPU).asnumpy()
    assert r.dtype == np.int32 and r.min() >= -3 and r.max() < 3
    e = tmx.nd.random.exponential(scale=4.0, shape=(50000,), ctx=CPU)
    assert abs(e.asnumpy().mean() - 4.0) < 5 * 4.0 / np.sqrt(50000)
    m = tmx.nd.random.multinomial(tmx.nd.array([[0.0, 1.0]], ctx=CPU),
                                  shape=(4,))
    assert m.asnumpy().tolist() == [[1, 1, 1, 1]]
    sh = tmx.nd.random.shuffle(tmx.nd.arange(10, ctx=CPU)).asnumpy()
    assert sorted(sh.tolist()) == list(range(10))


def test_samplers_in_graphs_draw_from_the_executors_device():
    tmx.random.seed(3)
    s = tmx.sym.random.uniform(low=-1, high=1, shape=(2, 3))
    out = s.eval(ctx=CPU)[0]
    assert out.shape == (2, 3) and out.context == CPU
    tmx.random.seed(3)
    np.testing.assert_array_equal(s.eval(ctx=CPU)[0].asnumpy(),
                                  out.asnumpy())
    data = tmx.sym.var("data")
    net = tmx.sym.LeakyReLU(tmx.sym.Dropout(data, p=0.5),
                            act_type="rrelu")
    exe = net.simple_bind(CPU, data=(64, 32))
    x = -np.ones((64, 32), np.float32)
    ev = exe.forward(is_train=False, data=x)[0].asnumpy()
    np.testing.assert_allclose(ev, -(0.125 + 0.334) / 2, rtol=1e-6)
    tr = exe.forward(is_train=True, data=x)[0].asnumpy()
    kept = tr != 0
    assert 0.4 < kept.mean() < 0.6
    slopes = -tr[kept] / 2.0
    assert slopes.min() >= 0.125 - 1e-6 and slopes.max() <= 0.334 + 1e-6
    assert slopes.std() > 0.03
    with tmx.autograd.record(train_mode=True):
        y = tmx.nd.LeakyReLU(tmx.nd.array(x, ctx=CPU), act_type="rrelu")
    assert len(np.unique(y.asnumpy())) > 100
