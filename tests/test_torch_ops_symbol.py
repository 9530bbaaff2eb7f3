"""The port's Symbol side of the operator library against the JAX package,
on the CPU: graphs built from every ``chip_smoke.OP_CASES`` op write the
same ``tojson()`` and infer the same shapes, partial shapes and dtypes;
``Symbol.bind``/``eval`` run the graph path to the imperative result;
the fluent methods of ``NDArray`` and ``Symbol``, ``AttrScope``, and the
range overlay (each entry rejects the same value in both packages).
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import constraints as tcons
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

CASES = list(range(len(chip_smoke.OP_CASES)))
# the contrib ops not ported yet (ROADMAP.md queue 7), by short name
DEFERRED_CONTRIB = {
    "CTCLoss", "DeformableConvolution", "DeformablePSROIPooling",
    "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget", "MultiProposal",
    "PSROIPooling", "Proposal", "ROIAlign", "ROIPooling",
    "bipartite_matching", "box_iou", "box_nms", "box_non_maximum_suppression",
    "ctc_loss", "dequantize", "quantize", "quantize_v2", "quantized_conv",
    "quantized_flatten", "quantized_fully_connected", "quantized_pooling",
    "requantize"}


def _ids(i):
    return "%d-%s" % (i, chip_smoke.OP_CASES[i]["name"])


def _build(mx, case):
    vs = [mx.sym.var("in%d" % k) for k in range(len(case["inputs"]))]
    return getattr(mx.sym, case["name"])(*vs, name="op", **case["attrs"])


def _infer(fn, **kw):
    """``fn(**kw)`` as a string, or "MXNetError" when it raises one (the
    two packages refuse the same graphs)."""
    try:
        return str(fn(**kw))
    except (MXNetError, JMXNetError):
        return "MXNetError"


@pytest.mark.parametrize("i", CASES, ids=_ids)
def test_symbol_json_shapes_and_types_match_the_jax_package(i):
    case = chip_smoke.OP_CASES[i]
    js, ts = _build(jmx, case), _build(tmx, case)
    assert ts.tojson() == js.tojson()
    shapes = {"in%d" % k: x.shape for k, x in enumerate(case["inputs"])}
    types = {"in%d" % k: x.dtype for k, x in enumerate(case["inputs"])}
    assert _infer(ts.infer_shape, **shapes) == _infer(js.infer_shape,
                                                      **shapes)
    assert str(ts.infer_shape_partial()) == str(js.infer_shape_partial())
    jt, tt = js.infer_type(**types), ts.infer_type(**types)
    assert [[str(x) for x in l] for l in tt] == \
        [[str(x) for x in l] for l in jt]


def _evaluable(case):
    """A case the graph path can run as the imperative call does: no
    state written back, no random draw, no attr set to None (symbol
    composition drops those, as in the JAX package, so the op's default
    applies), and a graph the shape inference accepts."""
    op = treg.get_op(case["name"])
    if any(v is None for v in case["attrs"].values()):
        return False
    if op.mutate_aux or op.needs_rng and case["attrs"].get(
            "act_type") != "rrelu":
        return False
    try:
        _build(tmx, case).infer_shape(**{
            "in%d" % k: x.shape for k, x in enumerate(case["inputs"])})
    except MXNetError:
        return False        # the JAX package refuses the same graph
    return True


@pytest.mark.parametrize(
    "i", [i for i in CASES if _evaluable(chip_smoke.OP_CASES[i])], ids=_ids)
def test_symbol_eval_equals_the_imperative_call(i):
    """``Symbol.eval`` (bind + forward through the executor's graph
    function) gives the ``mx.nd`` call's outputs bit for bit."""
    case = chip_smoke.OP_CASES[i]
    c = tmx.cpu()
    want, _, _ = chip_smoke.run_case(tmx, case, c, grad=False)
    feeds = {"in%d" % k: tmx.nd.array(x, ctx=c, dtype=x.dtype)
             for k, x in enumerate(case["inputs"])}
    got = [chip_smoke._to_host(o) for o in _build(tmx, case).eval(
        ctx=c, **feeds)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bind_with_gradients_and_aux_states():
    """``bind`` over given arrays (aux states made as zeros... then the
    moving stats of a training forward), forward and backward of a
    MakeLoss graph: the gradients equal the JAX package's within 1e-5 of
    the largest."""
    c = tmx.cpu()
    rng = np.random.RandomState(0)
    host = {"data": rng.randn(4, 3, 5, 5).astype(np.float32),
            "w": rng.randn(4, 3, 5, 5).astype(np.float32),
            "bn_gamma": np.array([1.0, 0.5, 2.0], np.float32),
            "bn_beta": np.array([0.3, -0.2, 0.1], np.float32)}

    def run(mx, ctx):
        data, w = mx.sym.var("data"), mx.sym.var("w")
        net = mx.sym.BatchNorm(mx.sym.LeakyReLU(data, act_type="elu"),
                               fix_gamma=False, name="bn")
        net = mx.sym.MakeLoss(mx.sym.sum(net * w))
        args = {k: mx.nd.array(v, ctx=ctx) for k, v in host.items()}
        grads = {k: mx.nd.zeros(v.shape, ctx=ctx) for k, v in host.items()}
        exe = net.bind(ctx, args, args_grad=grads)
        exe.forward(is_train=True)
        exe.backward()
        return exe, grads, net

    texe, tgrads, tnet = run(tmx, c)
    jexe, jgrads, _ = run(jmx, jmx.cpu())
    assert sorted(texe.aux_dict) == ["bn_moving_mean", "bn_moving_var"]
    for k in host:
        want = jgrads[k].asnumpy()
        np.testing.assert_allclose(tgrads[k].asnumpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(texe.aux_dict["bn_moving_var"].asnumpy(),
                               jexe.aux_dict["bn_moving_var"].asnumpy(),
                               rtol=1e-6)
    with pytest.raises(MXNetError, match="missing"):
        tnet.bind(c, {"data": tmx.nd.zeros((1,), ctx=c)})


def test_symbol_surface_matches_the_jax_package():
    def build(mx):
        a, b = mx.sym.var("a", lr_mult=2.0), mx.sym.var("b", dtype="float16")
        s = (2 - a) * 3 / b + (a % 2 if False else a) ** 2
        s = mx.sym.maximum(s, 0.5) + mx.sym.minimum(1.0, a) - (-a)
        s = mx.sym.hypot(s, b > a)
        s = s.astype("float32").reshape((-1,)).sum(axis=0) + \
            s.transpose().mean() + s.slice_axis(axis=0, begin=0, end=1).sin()
        return mx.sym.Group([s, mx.sym.zeros((2, 2)),
                             mx.sym.arange(0, 3)])
    with jmx.name.NameManager():
        j = build(jmx)
    with tmx.name.NameManager():
        t = build(tmx)
    assert t.tojson() == j.tojson()
    assert t.list_inputs() == j.list_inputs() == ["a", "b"]
    assert t.debug_str() == j.debug_str()
    assert t[0].get_children().list_outputs() == \
        j[0].get_children().list_outputs()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert str(t.infer_type(a="float32")) == str(j.infer_type(a="float32"))
    for dt in ("bfloat16", "int32"):
        assert [[str(x) for x in l] for l in t.infer_type(a=dt)] == \
            [[str(x) for x in l] for l in j.infer_type(a=dt)]
    assert len(t) == 3 and [s.name for s in t] == [s.name for s in j]
    assert t.attr("__lr_mult__") is None
    for name in dir(jmx.sym.Symbol):
        if not name.startswith("_"):
            assert hasattr(tmx.sym.Symbol, name), name
    for name in ("maximum", "minimum", "hypot", "zeros", "ones", "arange",
                 "random", "linalg", "contrib"):
        assert hasattr(tmx.sym, name), name
    def ops(mod):
        return sorted(n for n in dir(mod) if not n.startswith("_")
                      and callable(getattr(mod, n))
                      and not isinstance(getattr(mod, n), type(sys)))
    for sub in ("linalg", "contrib"):
        assert set(ops(getattr(jmx.sym, sub))) - set(
            ops(getattr(tmx.sym, sub))) <= DEFERRED_CONTRIB, sub


def test_attr_scope_matches_the_jax_package():
    def build(mx):
        with mx.AttrScope(ctx_group="stage1", __lr_mult__="0.5"):
            a = mx.sym.var("a")
            with mx.AttrScope(ctx_group="stage2"):
                b = mx.sym.FullyConnected(a, num_hidden=4, name="fc")
        return mx.sym.Activation(b, act_type="tanh", name="act"), a, b
    with jmx.name.NameManager():
        j, ja, jb = build(jmx)
    with tmx.name.NameManager():
        t, ta, tb = build(tmx)
    assert t.tojson() == j.tojson()
    assert ta.list_attr() == ja.list_attr() == {
        "ctx_group": "stage1", "__lr_mult__": "0.5"}
    assert tb.attr("ctx_group") == jb.attr("ctx_group") == "stage2"
    assert t.attr("ctx_group") is None
    assert t.attr_dict() == j.attr_dict()
    with pytest.raises(ValueError):
        tmx.AttrScope(x=1)


def test_ndarray_methods_match_the_jax_package():
    rng = np.random.RandomState(1)
    x = rng.uniform(-2, 2, (3, 4)).astype(np.float32)
    c = tmx.cpu()
    t, j = tmx.nd.array(x, ctx=c), jmx.nd.array(x)
    calls = [
        lambda a: a.T, lambda a: a.clip(-0.5, 0.5), lambda a: a.tile((2,)),
        lambda a: a.topk(k=2), lambda a: a.sort(axis=0),
        lambda a: a.argmax(axis=1), lambda a: a % 0.7, lambda a: 1.5 % a,
        lambda a: a > 0, lambda a: a <= a.T.T, lambda a: a != 0.5,
        lambda a: a.sin(), lambda a: a.reshape_like(a.T),
        lambda a: a.broadcast_to((2, 3, 4)), lambda a: a.split(2, axis=1)[1],
        lambda a: a.swapaxes(0, 1), lambda a: a.flatten(),
        lambda a: a.expand_dims(0).squeeze(), lambda a: a.flip(axis=1),
        lambda a: a.repeat(2, axis=0), lambda a: a.slice_axis(1, 1, 3),
        lambda a: a.slice((0, 1), (2, 3)), lambda a: a.one_hot(5),
        lambda a: a.norm(), lambda a: a.dot(a.T), lambda a: a.softmax(),
        lambda a: a.zeros_like(), lambda a: a.max(axis=0, keepdims=True),
        lambda a: a.argsort(is_ascend=False), lambda a: a.relu().sqrt(),
        lambda a: a.pad(mode="constant", pad_width=(0, 0, 1, 1)) if False
        else a.sign(), lambda a: a.take(a.argmax(axis=1)),
        lambda a: a.log_softmax(axis=0), lambda a: a.prod(axis=1),
        lambda a: a.sum_axis(axis=0), lambda a: a.rcbrt()]
    for k, f in enumerate(calls):
        got, want = f(t), f(j)
        np.testing.assert_allclose(got.asnumpy(), np.asarray(want.asnumpy(),
                                                             np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=str(k))
    assert t.ctx == c and t.ndim == 2 and t.as_in_context(c) is t
    assert tmx.nd.array([3.5], ctx=c).asscalar() == 3.5 == \
        tmx.nd.array([3.5], ctx=c).item()
    assert float(tmx.nd.array([2.0], ctx=c)) == 2.0 and len(t) == 3
    assert [r.shape for r in t] == [(4,)] * 3
    with pytest.raises(MXNetError):
        bool(t)
    y = tmx.nd.array(x, ctx=c)
    y += 1
    y *= 2
    np.testing.assert_array_equal(y.asnumpy(), (x + 1) * 2)
    for name in dir(jmx.nd.NDArray):
        if not name.startswith("_") and name not in (
                "handle", "stype", "tostype", "as_nd_ndarray"):
            assert hasattr(tmx.nd.NDArray, name), name
    for name in ("add", "subtract", "multiply", "divide", "true_divide",
                 "modulo", "power", "maximum", "minimum", "equal",
                 "not_equal", "greater", "greater_equal", "lesser",
                 "lesser_equal", "logical_and", "logical_or", "logical_xor"):
        for lhs, rhs in ((t, 0.5), (0.5, t), (t, t.T.T)):
            jl = j if lhs is t else lhs
            jr = j if rhs is not t and rhs is not lhs and not isinstance(
                rhs, float) else (rhs if isinstance(rhs, float) else j)
            got = getattr(tmx.nd, name)(lhs, rhs).asnumpy()
            want = getattr(jmx.nd, name)(jl, jr).asnumpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(
        tmx.nd.concatenate([t, t]).asnumpy(),
        jmx.nd.concatenate([j, j]).asnumpy())
    np.testing.assert_array_equal(tmx.nd.moveaxis(t, 0, 1).asnumpy(),
                                  x.T)
    out = tmx.nd.zeros((3, 4), ctx=c)
    tmx.nd.onehot_encode(tmx.nd.array([1, 0, 3], ctx=c), out)
    np.testing.assert_array_equal(out.asnumpy(), np.eye(4)[[1, 0, 3]])
    assert tmx.nd.full((2,), 7, ctx=c).asnumpy().tolist() == [7.0, 7.0]
    tmx.nd.waitall()


def test_parameter_tables_and_the_range_overlay_match_the_jax_package():
    """Every ported op accepts the same parameter names with the same
    types, bounds and required flags (Convolution's layout enum is the
    port's narrower one: it runs NCHW only); each overlay entry and each
    name-wide bound rejects the same out-of-range value in both."""
    assert tcons.UNAPPLIED == ()
    checked = 0
    for name, top in treg._OP_REGISTRY.items():
        jop = jreg.get_op(name)
        assert set(top.params) == set(jop.params), name
        for p, tp in top.params.items():
            jp = jop.params[p]
            if name.startswith("Convolution") and p == "layout":
                continue
            assert (tp.ptype, tp.low, tp.high, tp.required) == \
                (jp.ptype, jp.low, jp.high, jp.required), (name, p)
            for bad in ([tp.low - 1] if tp.low is not None else []) + \
                    ([tp.high + 1] if tp.high is not None else []):
                if tp.ptype is tuple:
                    bad = (bad,)
                elif tp.ptype is int:
                    bad = int(bad)
                msgs = []
                for op, err in ((top, MXNetError), (jop, JMXNetError)):
                    with pytest.raises(err) as info:
                        op.validate_attrs({p: bad})
                    msgs.append(str(info.value))
                assert msgs[0] == msgs[1]
                checked += 1
    assert checked > 60
    with pytest.raises(MXNetError, match="norm: invalid parameter ord=3"):
        tmx.nd.norm(tmx.nd.ones((2,), ctx=tmx.cpu()), ord=3)
