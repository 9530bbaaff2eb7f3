"""The port's gluon layers against the JAX package's, on the CPU: every
layer of ``gluon.nn`` that this slice adds (convolutions and their
transposes, pooling, ReflectionPad2D, BatchNorm, InstanceNorm, Flatten,
the activations, Lambda and HybridLambda) runs on the same numpy input
with the JAX block's initial parameters carried across by name; outputs,
the input's gradient and every parameter's gradient must lie within
1e-6 of the largest magnitude of each (the fp32 band).  Deferred
initialization (``in_channels=0``, nested containers), BatchNorm's
running statistics in training and predict mode, ``cast`` and the
``collect_params(select)`` repair are held the same way.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

SEED = 0
TOL = 1e-6          # of the largest magnitude, per array (fp32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def nd(mx, a):
    return mx.nd.array(np.asarray(a, np.float32))


def build(mx, make):
    """``make(mx)`` under a fresh NameManager, so both packages count
    prefixes alike."""
    with mx.name.NameManager():
        return make(mx)


def carry(jnet, tnet):
    """Set every parameter of the port's block to the JAX block's value,
    by name; both must be initialized (shapes known)."""
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp.keys()) == list(tp.keys())
    for k in jp.keys():
        tp[k].set_data(np.array(jp[k].data().asnumpy()))


def init(mx, net, first_input=None):
    """Initialize, and finish deferred shapes with one predict-mode
    forward of ``first_input`` (which moves no running statistic)."""
    if mx is tmx:
        net.initialize(mx.init.Xavier(), ctx=tmx.cpu())
    else:
        net.initialize(mx.init.Xavier())
    if first_input is not None:
        net(nd(mx, first_input))


def forward_backward(mx, net, x, seed=SEED, train=True):
    """The output, the input's gradient and each parameter's gradient of
    ``sum(net(x) * w)``, ``w`` fixed by ``seed``."""
    xa = nd(mx, x)
    xa.attach_grad()
    with mx.autograd.record(train_mode=train):
        y = net(xa)
        w = nd(mx, np.random.RandomState(seed + 1).randn(*y.shape))
        loss = (y * w).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return y.asnumpy(), xa.grad.asnumpy(), grads


def hold(make, x, train=True):
    """Run ``make`` in both packages on ``x`` and compare."""
    jnet = build(jmx, make)
    init(jmx, jnet, x)
    with tmx.cpu():
        tnet = build(tmx, make)
        init(tmx, tnet, x)
        carry(jnet, tnet)
        got = forward_backward(tmx, tnet, x, train=train)
    want = forward_backward(jmx, jnet, x, train=train)
    assert got[0].shape == want[0].shape
    assert rel(got[0], want[0]) <= TOL
    assert rel(got[1], want[1]) <= TOL
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        assert rel(got[2][k], want[2][k]) <= TOL, k
    return jnet, tnet


def _x(*shape, seed=SEED):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LAYERS = {
    "conv1d": (lambda mx: mx.gluon.nn.Conv1D(4, 3, strides=2, padding=1,
                                             dilation=1, prefix="c_"),
               (2, 3, 9)),
    "conv1d_groups": (lambda mx: mx.gluon.nn.Conv1D(
        4, 3, groups=2, use_bias=False, in_channels=4, prefix="c_"),
        (2, 4, 7)),
    "conv2d": (lambda mx: mx.gluon.nn.Conv2D(
        4, 3, strides=2, padding=1, activation="relu", prefix="c_"),
        (2, 3, 9, 9)),
    "conv2d_dilated_depthwise": (lambda mx: mx.gluon.nn.Conv2D(
        4, (3, 2), padding=(2, 1), dilation=(2, 1), groups=4, prefix="c_"),
        (2, 4, 7, 6)),
    "conv3d": (lambda mx: mx.gluon.nn.Conv3D(2, (2, 3, 3), padding=1,
                                             prefix="c_"),
               (1, 2, 4, 5, 5)),
    "conv1d_transpose": (lambda mx: mx.gluon.nn.Conv1DTranspose(
        3, 3, strides=2, output_padding=1, prefix="c_"), (2, 4, 5)),
    "conv2d_transpose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, prefix="c_"),
        (2, 4, 5, 5)),
    "conv3d_transpose": (lambda mx: mx.gluon.nn.Conv3DTranspose(
        2, 2, strides=2, prefix="c_"), (1, 3, 3, 3, 3)),
    "maxpool1d_ceil": (lambda mx: mx.gluon.nn.MaxPool1D(
        3, 2, 1, ceil_mode=True), (2, 3, 10)),
    "maxpool2d": (lambda mx: mx.gluon.nn.MaxPool2D(3, 2, 1), (2, 3, 9, 9)),
    "maxpool3d": (lambda mx: mx.gluon.nn.MaxPool3D(), (1, 2, 4, 4, 6)),
    "avgpool1d_exclude_pad": (lambda mx: mx.gluon.nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), (2, 3, 10)),
    "avgpool2d_ceil": (lambda mx: mx.gluon.nn.AvgPool2D(
        3, 2, 1, ceil_mode=True), (2, 3, 8, 8)),
    "avgpool3d": (lambda mx: mx.gluon.nn.AvgPool3D(2, 1), (1, 2, 3, 4, 4)),
    "globalmax1d": (lambda mx: mx.gluon.nn.GlobalMaxPool1D(), (2, 3, 7)),
    "globalmax2d": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(), (2, 3, 5, 6)),
    "globalmax3d": (lambda mx: mx.gluon.nn.GlobalMaxPool3D(),
                    (1, 2, 3, 4, 5)),
    "globalavg1d": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(), (2, 3, 7)),
    "globalavg2d": (lambda mx: mx.gluon.nn.GlobalAvgPool2D(), (2, 3, 5, 6)),
    "globalavg3d": (lambda mx: mx.gluon.nn.GlobalAvgPool3D(),
                    (1, 2, 3, 4, 5)),
    "reflectionpad2d": (lambda mx: mx.gluon.nn.ReflectionPad2D(2),
                        (1, 2, 5, 6)),
    "batchnorm": (lambda mx: mx.gluon.nn.BatchNorm(prefix="bn_"),
                  (4, 3, 5, 5)),
    "batchnorm_unscaled": (lambda mx: mx.gluon.nn.BatchNorm(
        scale=False, center=False, momentum=0.8, epsilon=1e-3,
        prefix="bn_"), (4, 3, 5, 5)),
    "batchnorm_axis_last": (lambda mx: mx.gluon.nn.BatchNorm(
        axis=-1, prefix="bn_"), (4, 5, 3)),
    "instancenorm": (lambda mx: mx.gluon.nn.InstanceNorm(
        scale=True, prefix="in_"), (2, 3, 6, 5)),
    "instancenorm_axis2": (lambda mx: mx.gluon.nn.InstanceNorm(
        axis=2, prefix="in_"), (2, 3, 4, 5)),
    "flatten": (lambda mx: mx.gluon.nn.Flatten(), (2, 3, 4, 5)),
    "leakyrelu": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), (3, 7)),
    "prelu": (lambda mx: mx.gluon.nn.PReLU(prefix="p_"), (3, 4, 5)),
    "elu": (lambda mx: mx.gluon.nn.ELU(0.5), (3, 7)),
    "selu": (lambda mx: mx.gluon.nn.SELU(), (3, 7)),
    "swish": (lambda mx: mx.gluon.nn.Swish(1.5), (3, 7)),
    "hybridlambda_name": (lambda mx: mx.gluon.nn.HybridLambda("tanh"),
                          (3, 7)),
    "hybridlambda_fn": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2 + 1), (3, 7)),
    "lambda_name": (lambda mx: mx.gluon.nn.Lambda("sigmoid"), (3, 7)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_jax_package(name):
    make, shape = LAYERS[name]
    hold(make, _x(*shape))


def _stack(mx):
    """Conv -> BatchNorm -> relu -> pool -> Dense, every shape deferred,
    inside nested HybridSequentials."""
    net = mx.gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        body = mx.gluon.nn.HybridSequential(prefix="")
        body.add(mx.gluon.nn.Conv2D(6, 3, padding=1, use_bias=False),
                 mx.gluon.nn.BatchNorm(),
                 mx.gluon.nn.Activation("relu"),
                 mx.gluon.nn.MaxPool2D())
        net.add(body, mx.gluon.nn.Conv2D(4, 1, use_bias=False),
                mx.gluon.nn.BatchNorm(), mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dense(5))
    return net


def test_deferred_shapes_of_a_nested_stack_match_the_jax_package():
    x = _x(2, 3, 8, 8)
    jnet, tnet = hold(_stack, x)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert [tp[k].shape for k in tp.keys()] == \
        [jp[k].shape for k in jp.keys()]
    assert tp["net_conv0_weight"].shape == (6, 3, 3, 3)
    assert tp["net_dense0_weight"].shape == (5, 64)


@pytest.mark.parametrize("train", [True, False], ids=["train", "predict"])
def test_batchnorm_running_stats_move_as_in_the_jax_package(train):
    """Two forwards under ``record(train_mode=...)``: in training the
    running mean and variance take MXNet's momentum step each time, in
    predict mode they stay, and the output uses the batch's statistics
    or the running ones accordingly."""
    def make(mx):
        return mx.gluon.nn.BatchNorm(momentum=0.7, prefix="bn_")

    jnet = build(jmx, make)
    init(jmx, jnet, _x(4, 3, 2, 2))
    outs = {}
    with tmx.cpu():
        tnet = build(tmx, make)
        init(tmx, tnet, _x(4, 3, 2, 2))
        carry(jnet, tnet)
        for mx, net in ((jmx, jnet), (tmx, tnet)):
            ys = []
            for s in (1, 2):
                with mx.autograd.record(train_mode=train):
                    ys.append(net(nd(mx, _x(4, 3, 2, 2, seed=s) * s + s))
                              .asnumpy())
            p = net.collect_params()
            outs[mx] = ys + [p["bn_running_mean"].data().asnumpy(),
                             p["bn_running_var"].data().asnumpy()]
    for got, want in zip(outs[tmx], outs[jmx]):
        assert rel(got, want) <= TOL
    moved = not np.allclose(outs[tmx][2], 0)
    assert moved == train
    assert tnet.running_mean.grad_req == "null"
    assert tnet.running_var.grad_req == "null"


def test_batchnorm_cast_keeps_float16_in_float32_as_the_jax_package():
    dtypes = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            net = build(mx, lambda m: m.gluon.nn.BatchNorm(in_channels=3))
            init(mx, net)
            net.cast("float16")
            dtypes[mx] = [str(np.dtype(p.data().dtype))
                          for p in net.collect_params().values()]
            net.cast("float32")
    assert dtypes[tmx] == dtypes[jmx] == ["float32"] * 4


def test_unscaled_batchnorm_gamma_takes_no_gradient_as_in_the_jax_package():
    for mx in (jmx, tmx):
        with tmx.cpu():
            net = build(mx, lambda m: m.gluon.nn.BatchNorm(
                scale=False, center=False, in_channels=2))
            reqs = [p.grad_req for p in net.collect_params().values()]
        assert reqs == ["null"] * 4


def test_collect_params_selects_by_regular_expression():
    """``collect_params(select)`` (queue 3 item 2): the same names as the
    JAX package's for a pattern, an alternation and no pattern, through
    nested blocks and a loss (which has none)."""
    got = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            net = build(mx, _stack)
            loss = build(mx, lambda m: m.gluon.loss.L2Loss())
            got[mx] = [list(net.collect_params(sel).keys())
                       for sel in (None, ".*weight", "net_batchnorm.*|.*bias",
                                   "nomatch")] + \
                [list(loss.collect_params(".*").keys())]
    assert got[tmx] == got[jmx]
    assert got[tmx][1] == ["net_conv0_weight", "net_conv1_weight",
                           "net_dense0_weight"]
    assert got[tmx][2] == ["net_batchnorm0_gamma", "net_batchnorm0_beta",
                           "net_batchnorm0_running_mean",
                           "net_batchnorm0_running_var",
                           "net_batchnorm1_gamma", "net_batchnorm1_beta",
                           "net_batchnorm1_running_mean",
                           "net_batchnorm1_running_var", "net_dense0_bias"]
    assert got[tmx][3] == [] and got[tmx][4] == []


def test_conv_layer_refuses_a_layout_it_does_not_take():
    for mx in (jmx, tmx):
        with pytest.raises((AssertionError, ValueError)):
            mx.gluon.nn.Conv1D(2, 3, layout="NWC")
        with pytest.raises((AssertionError, ValueError)):
            mx.gluon.nn.MaxPool2D(layout="NHWC")


def test_lambda_refuses_an_unknown_name():
    for mx in (jmx, tmx):
        with pytest.raises((AssertionError, ValueError)):
            mx.gluon.nn.Lambda("no_such_function")
        with pytest.raises((AssertionError, ValueError)):
            mx.gluon.nn.HybridLambda("no_such_function")


def test_sequential_slices_into_a_container_of_the_same_type():
    for mx in (jmx, tmx):
        with tmx.cpu():
            net = build(mx, _stack)
            head = net[1:]
            assert type(head) is type(net) and len(head) == 4
            assert head.prefix == net.prefix
            assert isinstance(net[0], mx.gluon.nn.HybridSequential)
