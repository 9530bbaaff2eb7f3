"""The port's ops, symbols and predictor against the JAX package.

Each op on the ResNet inference path runs through the JAX registry and
the port's registry on the same numpy inputs; graphs move between the
packages as JSON; and a whole cifar ResNet-8 forward through the JAX
Predictor (knobs auto, and forced on in interpret mode) and the port's
Predictor on the CPU must agree.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu.symbol.symbol import _bn_relu_peephole as jax_peephole
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager
from mxnet_tpu_torch.ops.registry import get_op as torch_op
from mxnet_tpu_torch.symbol.symbol import _bn_relu_peephole as port_peephole
from mxnet_tpu_torch.symbols import resnet as port_resnet

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example", "image-classification",
    "symbols"))
import resnet as jax_resnet  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _run_both(op, arrays, **attrs):
    """One registry op on both packages; returns the first outputs as
    numpy."""
    j = jax_op(op).fn(*[jnp.asarray(a) for a in arrays], **attrs)
    t = torch_op(op).fn(*[torch.from_numpy(a) for a in arrays], **attrs)
    j = j[0] if isinstance(j, tuple) else j
    t = t[0] if isinstance(t, tuple) else t
    return np.asarray(j), t.numpy()


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("attrs,no_bias", [
    (dict(kernel=(3, 3), num_filter=6, stride=(2, 2), pad=(1, 1)), False),
    (dict(kernel=(1, 1), num_filter=5), True),
    (dict(kernel=(7, 7), num_filter=4, stride=(2, 2), pad=(3, 3)), True),
])
def test_convolution_matches_jax(attrs, no_bias):
    rng = np.random.RandomState(20)
    k = attrs["kernel"]
    arrays = [_randn(rng, 2, 3, 11, 11),
              _randn(rng, attrs["num_filter"], 3, *k) * 0.3]
    if not no_bias:
        arrays.append(_randn(rng, attrs["num_filter"]))
    j, t = _run_both("Convolution", arrays, no_bias=no_bias, **attrs)
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(7, 7), global_pool=True, pool_type="avg"),
    dict(kernel=(7, 7), global_pool=True, pool_type="max"),
])
def test_pooling_matches_jax(attrs):
    rng = np.random.RandomState(21)
    # all-negative input: a max pool that padded with 0 instead of -inf
    # would show up as zeros on the border
    x = -np.abs(_randn(rng, 2, 3, 10, 10)) - 0.1
    j, t = _run_both("Pooling", [x], **attrs)
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected_matches_jax(no_bias):
    rng = np.random.RandomState(22)
    arrays = [_randn(rng, 4, 3, 2, 5), _randn(rng, 7, 30)]
    if not no_bias:
        arrays.append(_randn(rng, 7))
    j, t = _run_both("FullyConnected", arrays, num_hidden=7, no_bias=no_bias)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_eval_matches_jax(fix_gamma):
    rng = np.random.RandomState(23)
    arrays = [_randn(rng, 2, 4, 5, 5), rng.rand(4).astype(np.float32) + 0.5,
              _randn(rng, 4), _randn(rng, 4) * 0.1,
              rng.rand(4).astype(np.float32) + 0.5]
    j, t = _run_both("BatchNorm", arrays, eps=2e-5, fix_gamma=fix_gamma)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op,attrs,n_in", [
    ("Activation", dict(act_type="relu"), 1),
    ("Flatten", {}, 1),
    ("elemwise_add", {}, 2),
])
def test_elementwise_and_shape_ops_match_jax(op, attrs, n_in):
    rng = np.random.RandomState(24)
    arrays = [_randn(rng, 2, 3, 4, 5) for _ in range(n_in)]
    j, t = _run_both(op, arrays, **attrs)
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("knob", ["auto", "1"])
def test_softmax_output_forward_matches_jax(monkeypatch, knob):
    monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", knob)
    rng = np.random.RandomState(25)
    x = _randn(rng, 6, 1000) * 5
    label = rng.randint(0, 1000, size=6).astype(np.float32)
    j, t = _run_both("SoftmaxOutput", [x, label])
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_batchnorm_training_mode_is_not_ported():
    """The name is kept from the serving slice, which refused training
    mode.  Training mode is ported now: through both registries, the
    batch's statistics normalise and the moving stats come back updated,
    and with use_global_stats the moving stats normalise and come back
    unchanged (the gradients are held in test_torch_train.py)."""
    rng = np.random.RandomState(26)
    arrays = [_randn(rng, 2, 4, 3, 3) * 2 + 0.5,
              rng.rand(4).astype(np.float32) + 0.5, _randn(rng, 4),
              _randn(rng, 4) * 0.1, rng.rand(4).astype(np.float32) + 0.5]
    for use_global_stats in (False, True):
        kw = dict(eps=2e-5, momentum=0.9, fix_gamma=False,
                  use_global_stats=use_global_stats, __is_train__=True)
        j = jax_op("BatchNorm").fn(*[jnp.asarray(a) for a in arrays], **kw)
        t = torch_op("BatchNorm").fn(*[torch.from_numpy(a) for a in arrays],
                                     **kw)
        for jo, to in zip(j, t):
            np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                       rtol=RTOL, atol=ATOL)
        moved = not np.array_equal(t[1].numpy(), arrays[3])
        assert moved != use_global_stats


# ---------------------------------------------------------------------------
# symbols: JSON, inference, the peephole
# ---------------------------------------------------------------------------
def test_resnet50_json_identical_and_inference_agrees():
    # fresh name counters: unnamed nodes (the max pool, the flatten) are
    # numbered by how many were built before in this thread
    with jmx.name.NameManager():
        js = jax_resnet.get_symbol(1000, 50, "3,224,224")
    with NameManager():
        ps = port_resnet.get_symbol(1000, 50, "3,224,224")
    assert ps.tojson() == js.tojson()
    loaded = tmx.sym.load_json(js.tojson())
    assert loaded.list_arguments() == js.list_arguments()
    assert loaded.list_auxiliary_states() == js.list_auxiliary_states()
    assert loaded.list_outputs() == js.list_outputs()
    ja, jo, jx = js.infer_shape(data=(2, 3, 224, 224))
    ta, to, tx = loaded.infer_shape(data=(2, 3, 224, 224))
    assert [tuple(s) for s in ja] == ta
    assert [tuple(s) for s in jo] == to == [(2, 1000)]
    assert [tuple(s) for s in jx] == tx
    assert loaded.tojson() == js.tojson()


def test_peephole_fuses_the_same_33_sites_as_jax(monkeypatch):
    """Symbol only.  The JAX package's ``auto`` means off on the CPU, so
    both sides run with the knob forced on."""
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "1")
    js = jax_resnet.get_symbol(1000, 50, "3,224,224")
    ps = tmx.sym.load_json(js.tojson())
    j_skip, j_fuse = jax_peephole(js, js._topo(), False)
    p_skip, p_fuse = port_peephole(ps, ps._topo(), False, "cpu")

    def names(nodes, skip, fuse):
        by_id = {id(n): n.name for n in nodes}
        return (sorted(by_id[i] for i in skip),
                sorted((by_id[a], bn.name) for a, bn in fuse.items()))

    j_names = names(js._topo(), j_skip, j_fuse)
    p_names = names(ps._topo(), p_skip, p_fuse)
    assert p_names == j_names
    assert len(p_names[0]) == 33
    # bn3 and sc_bn feed the residual add: never fused
    assert not any(n.endswith(("_bn3", "_sc_bn")) for n in p_names[0])


def test_peephole_off_by_knob_and_in_training(monkeypatch):
    ps = port_resnet.get_symbol(10, 8, "3,32,32")
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "0")
    assert port_peephole(ps, ps._topo(), False, "cuda") == (frozenset(), {})
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "1")
    assert port_peephole(ps, ps._topo(), True, "cpu") == (frozenset(), {})
    monkeypatch.delenv("MXNET_PALLAS_BN_RELU")
    assert port_peephole(ps, ps._topo(), False, "cpu") == (frozenset(), {})
    # bn0/relu0 and bn1/relu1 of each of the three basic units
    assert len(port_peephole(ps, ps._topo(), False, "cuda")[1]) == 4


def test_peephole_skips_bn_that_is_a_head_or_shared(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "1")
    data = tmx.sym.var("data")
    bn = tmx.sym.BatchNorm(data, name="bn")
    relu = tmx.sym.Activation(bn, act_type="relu", name="relu")
    head = tmx.sym.Group([relu, bn])
    assert port_peephole(head, head._topo(), False, "cpu")[1] == {}
    shared = relu + bn
    assert port_peephole(shared, shared._topo(), False, "cpu")[1] == {}
    alone = tmx.sym.Activation(bn, act_type="relu")
    assert len(port_peephole(alone, alone._topo(), False, "cpu")[1]) == 1


def test_attribute_strings_from_json_are_parsed():
    """BN eps arrives as the string "2e-05": a parse miss would fall back
    to the peephole's 1e-3 default and change results silently."""
    js = jax_resnet.get_symbol(10, 8, "3,32,32")
    ps = tmx.sym.load_json(js.tojson())
    bn0 = next(n for n in ps._topo() if n.name == "bn0")
    assert bn0.attrs["eps"] == "2e-05"
    from mxnet_tpu_torch.symbol.symbol import _visible_attrs
    assert _visible_attrs(bn0)["eps"] == 2e-05
    assert _visible_attrs(bn0)["fix_gamma"] is False


def test_unknown_attribute_is_rejected_when_the_graph_is_built():
    with pytest.raises(MXNetError, match="did you mean 'num_filter'"):
        tmx.sym.Convolution(tmx.sym.var("x"), kernel=(3, 3), num_filters=4)


# ---------------------------------------------------------------------------
# the whole slice: a ResNet-8 forward through both Predictors
# ---------------------------------------------------------------------------
def _resnet8_parts(batch=4, seed=0):
    sym = jax_resnet.get_symbol(10, 8, "3,32,32")
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(batch, 3, 32, 32))
    rng = np.random.RandomState(seed)
    arg, aux = {}, {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        fan_in = max(1, int(np.prod(shp[1:])))
        arg[n] = (rng.randn(*shp) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    for n, shp in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = ((rng.rand(*shp) + 0.5) if n.endswith("_var")
                  else rng.randn(*shp) * 0.1).astype(np.float32)
    x = rng.randn(batch, 3, 32, 32).astype(np.float32)
    return sym, arg, aux, x


def _jax_predict(sym, arg, aux, x):
    p = jmx.predictor.Predictor.from_parts(
        sym, {k: jmx.nd.array(v) for k, v in arg.items()},
        {k: jmx.nd.array(v) for k, v in aux.items()}, {"data": x.shape})
    return p.forward(data=x).get_output(0).asnumpy()


@pytest.mark.parametrize("port_knob", ["auto", "1"])
def test_resnet8_predictor_matches_jax(monkeypatch, port_knob):
    sym, arg, aux, x = _resnet8_parts()
    for k in ("MXNET_PALLAS_BN_RELU", "MXNET_PALLAS_SOFTMAX"):
        monkeypatch.delenv(k, raising=False)
    j_auto = _jax_predict(sym, arg, aux, x)
    for k in ("MXNET_PALLAS_BN_RELU", "MXNET_PALLAS_SOFTMAX"):
        monkeypatch.setenv(k, "1")
    j_forced = _jax_predict(sym, arg, aux, x)
    for k in ("MXNET_PALLAS_BN_RELU", "MXNET_PALLAS_SOFTMAX"):
        monkeypatch.setenv(k, port_knob)
    args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu(),
                                               symbol=sym)
    p = tmx.Predictor.from_parts(tmx.sym.load_json(sym.tojson()), args,
                                 auxs, {"data": x.shape}, ctx=tmx.cpu())
    got = p.forward(data=x).get_output(0).asnumpy()
    assert got.shape == (4, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, j_auto, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, j_forced, rtol=0, atol=1e-5)


def test_predictor_aliases_parameters_never_copies():
    sym, arg, aux, x = _resnet8_parts(batch=2)
    args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu())
    p = tmx.Predictor.from_parts(tmx.sym.load_json(sym.tojson()), args,
                                 auxs, {"data": x.shape}, ctx=tmx.cpu())
    for k, v in args.items():
        assert p._exe.arg_dict[k]._data is v._data
    for k, v in auxs.items():
        assert p._exe.aux_dict[k]._data is v._data
    # softmax_label is allocated zero-filled and ignored by the forward
    assert float(p._exe.arg_dict["softmax_label"]._data.abs().sum()) == 0


def test_params_from_numpy_names_what_is_missing():
    sym, arg, aux, _ = _resnet8_parts(batch=1)
    arg.pop("fc1_weight")
    with pytest.raises(MXNetError, match="fc1_weight"):
        tmx.convert.params_from_numpy(arg, aux, tmx.cpu(), symbol=sym)


def test_simple_bind_is_inference_only():
    """``grad_req="null"`` binds for inference only: no gradient buffers,
    a training forward runs BatchNorm on the batch's stats without a
    backward, and backward() does nothing.  The default is the reference's
    ``write``, as in the JAX package: a gradient per argument, which a
    training forward and backward fill; other values raise."""
    ps = port_resnet.get_symbol(10, 8, "3,32,32")
    with pytest.raises(MXNetError, match="grad_req"):
        ps.simple_bind(ctx=tmx.cpu(), grad_req="sum", data=(1, 3, 32, 32))
    wexe = ps.simple_bind(ctx=tmx.cpu(), grad_req="write",
                          data=(1, 3, 32, 32))
    assert set(wexe.grad_dict) == set(ps.list_arguments())
    dexe = ps.simple_bind(ctx=tmx.cpu(), data=(2, 3, 32, 32))
    jexe = jax_resnet.get_symbol(10, 8, "3,32,32").simple_bind(
        ctx=jmx.cpu(), data=(2, 3, 32, 32))
    assert sorted(dexe.grad_dict) == sorted(jexe.grad_dict) \
        == sorted(ps.list_arguments())
    rng = np.random.RandomState(27)
    for n, a in dexe.arg_dict.items():
        a[:] = rng.randn(*a.shape).astype(np.float32)
    dexe.arg_dict["softmax_label"][:] = np.array([1, 2], np.float32)
    dexe.forward(is_train=True)
    dexe.backward()
    g = dexe.grad_dict["fc1_weight"].asnumpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    exe = ps.simple_bind(ctx=tmx.cpu(), grad_req="null", data=(2, 3, 32, 32))
    assert exe.grad_dict == {}
    for n, a in exe.aux_dict.items():
        a[:] = 1.0 if n.endswith("_var") else 0.0
    for n, a in exe.arg_dict.items():
        a[:] = np.random.RandomState(27).randn(*a.shape).astype(np.float32)
    exe.forward(is_train=True)
    assert not np.allclose(exe.aux_dict["bn0_moving_mean"].asnumpy(), 0)
    exe.backward()                  # no gradients to compute: a no-op
    with pytest.raises(MXNetError, match="unknown forward argument"):
        exe.forward(images=np.zeros((1, 3, 32, 32), np.float32))


def test_simple_bind_takes_the_reference_keywords():
    """Queue 3 item 1: ``stype_dict``, ``group2ctx``, ``shared_arg_names``
    and ``shared_buffer`` in the reference's positional order, as the JAX
    package takes them; a sparse storage type binds dense, as in the JAX
    package; a second device raises MXNetError naming what is missing,
    the port's own ``compute_dtype`` and ``cast_exclude`` are keywords
    only."""
    import inspect
    want = ["ctx", "grad_req", "type_dict", "stype_dict", "group2ctx",
            "shared_arg_names", "shared_exec", "shared_buffer"]
    for mx in (jmx, tmx):
        params = list(inspect.signature(mx.sym.Symbol.simple_bind)
                      .parameters)
        assert params[1:len(want) + 1] == want
    kinds = inspect.signature(tmx.sym.Symbol.simple_bind).parameters
    assert kinds["compute_dtype"].kind is inspect.Parameter.KEYWORD_ONLY
    assert kinds["cast_exclude"].kind is inspect.Parameter.KEYWORD_ONLY
    ps = port_resnet.get_symbol(10, 8, "3,32,32")
    js = jax_resnet.get_symbol(10, 8, "3,32,32")
    for sym, ctx in ((ps, tmx.cpu()), (js, jmx.cpu())):
        exe = sym.simple_bind(ctx, "null", None, {"data": "default"},
                              {"dev1": ctx}, ["fc1_weight"], None, {},
                              data=(1, 3, 32, 32))
        assert exe.grad_dict == {}
        assert exe.arg_dict["data"].shape == (1, 3, 32, 32)
    # a sparse storage type binds dense in both packages
    for sym, ctx in ((ps, tmx.cpu()), (js, jmx.cpu())):
        exe = sym.simple_bind(ctx, stype_dict={"fc1_weight": "row_sparse"},
                              data=(1, 3, 32, 32))
        assert exe.arg_dict["fc1_weight"].stype == "default"
        assert exe.arg_dict["fc1_weight"].shape == (10, 64)
    with pytest.raises(MXNetError, match="one device"):
        ps.simple_bind(tmx.cpu(), group2ctx={"a": tmx.cpu(0),
                                             "b": tmx.gpu(0)},
                       data=(1, 3, 32, 32))
    with pytest.raises(TypeError):
        ps.simple_bind(tmx.cpu(), "null", None, None, None, None, None,
                       None, "bfloat16", data=(1, 3, 32, 32))
