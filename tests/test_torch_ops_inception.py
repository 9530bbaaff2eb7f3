"""Inception-BN on the port against the JAX package, on the CPU, and the
CPU rehearsal of ``chip_smoke.py``'s phase 14.

Small size: 10 classes at 3x13x13, the smallest image whose shapes hold
through the network's five stride-2 stages and its global pool, batch 4.
Weights from a seed with every BatchNorm's gamma near 0.2 and beta near
+1 or -1 by channel (as ``tests/test_torch_train.py`` does, so no ReLU
input sits within rounding of zero).  Two ``Module.fit`` steps
(``kvstore="tpu"``, the fused step, SGD momentum): each tensor's change
(weights, moving stats) within UPDATE_TOL of its largest change in the
JAX package.  The packages sum convolutions in other orders, and
BatchNorm in training normalises the deepest layers over 4 values (1x1
maps at batch 4), which amplifies those fp32 differences down the
backward: after one step the first layer's gradient differs by ~5e-4
of its largest, the last layers' by ~1e-6, and after two the largest
difference is 2.2e-3 of a tensor's change (bn_2_gamma; measured);
changes that are 0 up to rounding within UPDATE_FLOOR.
Serving with
``MXNET_PALLAS_BN_RELU=1`` calls the K3 wrapper at all 69 BatchNorm->ReLU
sites; the port's ``symbols/inception_bn.py`` writes the example's JSON.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.symbols import inception_bn as tinc

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "example", "image-classification",
                                "symbols"))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import inception_bn as jinc  # noqa: E402

IMAGE = (3, 13, 13)
BATCH = 4
CLASSES = 10
SITES = 69
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
UPDATE_TOL = 5e-3
# a conv bias ahead of a BatchNorm, and the beta of a BatchNorm whose
# output reaches the next BatchNorm through a conv, have a gradient of 0
# up to rounding (~1e-7): their change is held to this absolute bound
UPDATE_FLOOR = 1e-6


@pytest.fixture(scope="module")
def small():
    with jmx.name.NameManager():
        jsym = jinc.get_symbol(CLASSES)
    with tmx.name.NameManager():
        tsym = tinc.get_symbol(CLASSES)
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=(BATCH,) + IMAGE)
    rng = np.random.RandomState(9)
    sign = rng.choice([-1.0, 1.0], 1024)
    arg = {}
    for n, shp in zip(jsym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        std = np.sqrt(2.0 / np.prod(shp[1:])) if len(shp) > 1 else 0.1
        arg[n] = (rng.randn(*shp) * std).astype(np.float32)
        if n.endswith("_gamma"):
            arg[n] = (0.2 + 0.05 * rng.rand(*shp)).astype(np.float32)
        elif n.endswith("_beta"):
            arg[n] = (sign[:shp[0]] + 0.05 * rng.randn(*shp)).astype(
                np.float32)
    aux = {n: ((rng.rand(*shp) + 0.5) if n.endswith("_var")
               else rng.randn(*shp) * 0.1).astype(np.float32)
           for n, shp in zip(jsym.list_auxiliary_states(), aux_shapes)}
    x = rng.randn(2 * BATCH, *IMAGE).astype(np.float32)
    y = rng.randint(0, CLASSES, 2 * BATCH).astype(np.float32)
    return jsym, tsym, arg, aux, x, y


def test_symbol_json_equals_the_example(small):
    jsym, tsym = small[:2]
    assert tsym.tojson() == jsym.tojson()
    with jmx.name.NameManager():
        j1000 = jinc.get_symbol(1000)
    with tmx.name.NameManager():
        t1000 = tinc.get_symbol(1000)
    assert t1000.tojson() == j1000.tojson()
    arg_shapes, out_shapes, aux_shapes = t1000.infer_shape(
        data=(32, 3, 224, 224))
    assert out_shapes == [(32, 1000)]
    n = sum(int(np.prod(s)) for s, nm in zip(arg_shapes,
                                             t1000.list_arguments())
            if nm not in ("data", "softmax_label"))
    assert n == 11295240
    assert sum(int(np.prod(s)) for s in aux_shapes) == 20032
    assert [tuple(s) for s in t1000.infer_shape(data=(2,) + IMAGE)[1]] == \
        [(2, 1000)]
    with pytest.raises(tmx.MXNetError):
        t1000.infer_shape(data=(2, 3, 12, 12))


def test_two_fit_steps_match_the_jax_package(small, monkeypatch):
    jsym, tsym, arg, aux, x, y = small
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    jmod = jmx.mod.Module(jsym, context=jmx.cpu())
    jmod.fit(jmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
             kvstore="tpu", optimizer="sgd", optimizer_params=SGD,
             arg_params={k: jmx.nd.array(v) for k, v in arg.items()},
             aux_params={k: jmx.nd.array(v) for k, v in aux.items()})
    args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu())
    tmod = tmx.mod.Module(tsym, context=tmx.cpu())
    tmod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
             kvstore="tpu", optimizer="sgd", optimizer_params=SGD,
             arg_params=args, aux_params=auxs)
    assert tmod._fused_exec_update
    assert tmod._exec_group.execs[0]._sweep is not None
    worst = {}
    for want, got in zip(jmod.get_params(), tmod.get_params()):
        assert sorted(want) == sorted(got)
        for k in want:
            start = arg.get(k, aux.get(k))
            dw = want[k].asnumpy() - start
            dt = got[k].asnumpy() - start
            err = np.abs(dt - dw).max()
            if err > UPDATE_TOL * np.abs(dw).max() + UPDATE_FLOOR:
                worst[k] = (err, np.abs(dw).max())
    assert worst == {}


def _counting(monkeypatch, names):
    seen = {}

    def counting(name, fn):
        def wrapper(*a, **kw):
            if a[0].device.type != "meta":
                seen[name] = seen.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in names:
        monkeypatch.setattr(ck, name, counting(name, getattr(ck, name)))
    return seen


def test_serving_fuses_all_69_sites(small, monkeypatch):
    _, tsym, arg, aux, x, _ = small
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "1")
    monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", "1")
    assert len(chip_smoke.k3_sites(tmx, tsym, BATCH, IMAGE)) == SITES
    seen = _counting(monkeypatch, ("scale_bias_relu", "softmax_lastaxis"))
    args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu())
    srv = tmx.serving.ModelServer(max_batch=BATCH, ctx=tmx.cpu())
    srv.add_model("inception", tsym, args, auxs, {"data": (1,) + IMAGE})
    srv.start()
    try:
        got = srv.infer("inception", {"data": x[:BATCH]})[0]
    finally:
        srv.stop()
    assert seen == {"scale_bias_relu": SITES, "softmax_lastaxis": 1}
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "0")
    pred = tmx.Predictor.from_parts(tsym, args, auxs,
                                    {"data": (BATCH,) + IMAGE},
                                    ctx=tmx.cpu())
    ref = pred.forward(data=x[:BATCH]).get_output(0).asnumpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    jpred = jmx.Predictor.from_parts(small[0], {k: jmx.nd.array(v) for k, v
                                                in arg.items()},
                                     {k: jmx.nd.array(v) for k, v
                                      in aux.items()},
                                     {"data": (BATCH,) + IMAGE}) \
        if hasattr(jmx.Predictor, "from_parts") else None
    if jpred is not None:
        want = jpred.forward(data=x[:BATCH]).get_output(0).asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_chip_smoke_phase_14_rehearses_on_the_cpu(monkeypatch):
    """``op_sweep`` (the CPU against itself: every check bitwise),
    ``fused_bn_relu_once`` (one K3 wrapper call, bitwise equal to the
    plain version) and ``inception_phase`` at 13x13, batch 2, one warmup
    and one timed step, with counting wrappers: K1b once a bucket and K2
    once a step, then the served forwards at 69 K3 and one K2 each."""
    c = tmx.cpu()
    sweep = chip_smoke.op_sweep(tmx, c, c)
    assert sweep["failed"] == [] and sweep["bitwise"] == sweep["checks"]
    assert sweep["cases"] == len(chip_smoke.OP_CASES) > 300
    for knob in ("MXNET_PALLAS_FUSED_OPT", "MXNET_PALLAS_SOFTMAX",
                 "MXNET_PALLAS_BN_RELU"):
        monkeypatch.setenv(knob, "1")
    seen = _counting(monkeypatch, ("scale_bias_relu", "softmax_lastaxis",
                                   "sgd_mom_sweep"))
    fbr = chip_smoke.fused_bn_relu_once(tmx, ck, c, shape=(2, 8, 5, 5))
    assert seen == {"scale_bias_relu": 1} and fbr["bitwise"]
    seen.clear()
    mod, inc = chip_smoke.inception_phase(tmx, ck, c, image=IMAGE, batch=2,
                                          classes=CLASSES, warmup=1,
                                          steps=1)
    sv = inc["serve"]
    nb = inc["buckets"]
    assert inc["sites"] == SITES and nb >= 1
    # the served forwards, the same-bucket Predictor's forwards they are
    # held to, the module's forwards beside them, and the timed
    # predictor's six (a warmup, one counted, four timed)
    fwd = sv["forwards"] + 2 * sv["answers"] + 6
    assert seen == {"sgd_mom_sweep": 2 * nb,
                    "softmax_lastaxis": 2 + fwd,
                    "scale_bias_relu": SITES * fwd}
    assert sv["answers"] == 9 and (sv["bitwise"] or sv["max_rel"] <= 1e-6)
    assert sv["cross_shape_bitwise"] or sv["cross_shape_max_rel"] <= 1e-6
    assert sv["buckets"] == [1, 2]
    assert np.isfinite(inc["ce_first"]) and inc["step_ms"] > 0
