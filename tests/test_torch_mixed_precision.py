"""Mixed precision in the port against the JAX package, on the CPU.

Three parts, each run through both packages on the same numpy inputs and
parameters:

- ``Module(compute_dtype="bfloat16")``: fp32 masters cast to bf16 at graph
  entry (labels excluded), fp32 gradients into the optimizer, on a Conv
  -> BatchNorm -> ReLU -> Pool -> FC -> SoftmaxOutput net;
- multi-precision SGD and Adam on fp16 weights (an fp32 master in the
  optimizer state) and their ``.states`` files;
- gluon ``Parameter.cast``/``Block.cast`` and a bf16-cast
  ``TransformerLM`` forward and Adam step.

The JAX side runs its Pallas kernels in interpret mode where a knob is 1,
as its own tests do; the port's wrappers take their plain versions on CPU
tensors.  Bands, each with its reason:

- ``BF16_FWD`` = 2^-6 of the largest magnitude: both packages round every
  op's output to bf16 (8 bits), and a sum taken in another order rounds
  to a neighbouring bf16 value, one step of 2^-8 relative, which the next
  ops carry on; four such steps at the largest value;
- ``BF16_UPDATE`` = 2^-4 of each tensor's largest update or gradient,
  or twice the distance of the JAX package's own bf16 result from its
  fp32 one where that is larger.  A gradient through a training-mode
  BatchNorm, a softmax or a LayerNorm is the bf16 sum of terms that
  nearly cancel, in both packages and in different orders, so each
  package's bf16 result lies about as far from the fp32 one as the other
  (for this file's conv weight after three steps 13.5%, the cast
  transformer's attention weights 7-10%), and two of them at most twice
  that from each other.  The same steps in fp32 agree within 1e-5 of the
  largest, so what differs is rounding, not the algorithm;
- moving stats within 2^-8 of their largest: fp32 updates from the batch
  statistics of bf16 activations one bf16 step apart;
- fp16 multi-precision: exact for the fp32 masters (the same fp32 update
  of the same fp16 gradient), and the fp16 weights equal (the masters
  rounded to fp16).
"""
import io
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.contrib import transformer as jtr
from mxnet_tpu_torch.gluon.contrib import transformer as ttr

import chip_smoke

torch.set_num_threads(1)

CPU = tmx.cpu()
BF16_FWD = 2.0 ** -6
BF16_UPDATE = 2.0 ** -4
BF16_STAT = 2.0 ** -8
SHAPE = (1, 8, 8)
BATCH = 4
KNOBS = ("MXNET_PALLAS_BN_RELU", "MXNET_PALLAS_SOFTMAX")
# the nodes whose output dtype the two packages must agree on
NODES = ("c1_output", "bn1_output0", "relu1_output", "pool1_output",
         "flat1_output", "fc_output", "softmax_output")


def _net(mx):
    data = mx.sym.var("data")
    n = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           no_bias=True, name="c1")
    n = mx.sym.BatchNorm(n, fix_gamma=False, name="bn1")
    n = mx.sym.Activation(n, act_type="relu", name="relu1")
    n = mx.sym.Pooling(n, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="pool1")
    n = mx.sym.Flatten(n, name="flat1")
    n = mx.sym.FullyConnected(n, num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(n, name="softmax")


@pytest.fixture(scope="module")
def small():
    """Parameters (He-scaled weights, gamma near 1, beta +-0.5 by
    channel so no ReLU input sits near 0), moving stats and 12 samples
    with labels, all from a seed."""
    sym = _net(jmx)
    shapes = dict(data=(BATCH,) + SHAPE, softmax_label=(BATCH,))
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(3)
    arg = {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_gamma"):
            v = 1 + 0.1 * rng.randn(*shp)
        elif n.endswith("_beta"):
            v = 0.5 * np.sign(rng.randn(*shp))
        elif len(shp) > 1:
            v = rng.randn(*shp) * np.sqrt(2.0 / np.prod(shp[1:]))
        else:
            v = 0.1 * rng.randn(*shp)
        arg[n] = v.astype(np.float32)
    aux = {n: ((rng.rand(*shp) + 0.5) if n.endswith("_var")
               else 0.1 * rng.randn(*shp)).astype(np.float32)
           for n, shp in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = rng.rand(12, *SHAPE).astype(np.float32)
    y = rng.randint(0, 10, 12).astype(np.float32)
    return arg, aux, x, y


def _set_knobs(monkeypatch, value):
    for k in KNOBS:
        monkeypatch.setenv(k, value)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _bind(mx, ctx, sym, arg, aux, grad_req="null", **extra):
    exe = sym.simple_bind(ctx, grad_req=grad_req, compute_dtype="bfloat16",
                          cast_exclude=("softmax_label",),
                          data=(BATCH,) + SHAPE, softmax_label=(BATCH,),
                          **extra)
    for n, v in arg.items():
        exe.arg_dict[n][:] = v
    for n, v in aux.items():
        exe.aux_dict[n][:] = v
    return exe


def _outputs(outs):
    return [(str(o.dtype), o.asnumpy().astype(np.float32)) for o in outs]


# ---------------------------------------------------------------------------
# the executor's policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knob", ["0", "1"])
@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_node_dtypes_and_outputs_match(small, monkeypatch, knob, is_train):
    """Every node's output under compute_dtype="bfloat16": the same dtype
    as the JAX package's (bf16 through the FC, the SoftmaxOutput fp32), the
    values within BF16_FWD of the largest; eval with the BatchNorm->ReLU
    peephole (knob 1) and without, training with batch statistics."""
    arg, aux, x, y = small
    _set_knobs(monkeypatch, knob)
    res = {}
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, CPU)):
        sym = _net(mx)
        grp = mx.sym.Group([sym.get_internals()[n] for n in NODES])
        exe = _bind(mx, ctx, grp, dict(arg, data=x[:BATCH],
                                       softmax_label=y[:BATCH]), aux)
        res[mx] = _outputs(exe.forward(is_train=is_train))
    for name, (jdt, jv), (tdt, tv) in zip(NODES, res[jmx], res[tmx]):
        assert tdt == jdt, (name, tdt, jdt)
        assert _rel(tv, jv) <= BF16_FWD, (name, _rel(tv, jv))
    assert [d for d, _ in res[tmx]] == ["bfloat16"] * 6 + ["float32"]


def test_infer_type_matches(small):
    """``infer_type`` per node from bf16 data and weights agrees with the
    JAX package's."""
    types = dict(data="bfloat16", c1_weight="bfloat16", fc_weight="bfloat16")
    got = []
    for mx in (jmx, tmx):
        grp = mx.sym.Group([_net(mx).get_internals()[n] for n in NODES])
        arg_t, out_t, aux_t = grp.infer_type(**types)
        got.append(([str(t) for t in arg_t], [str(t) for t in out_t],
                    [str(t) for t in aux_t]))
    assert got[0] == got[1]


def test_cast_exclude_keeps_the_label_fp32(small):
    """The label stays fp32 through the graph (a BlockGrad of it comes out
    fp32), the data is cast (its BlockGrad comes out bf16), and the bound
    arguments and aux states stay fp32 in both packages."""
    arg, aux, x, y = small
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, CPU)):
        sym = _net(mx)
        grp = mx.sym.Group([sym, mx.sym.BlockGrad(mx.sym.var("softmax_label")),
                            mx.sym.BlockGrad(mx.sym.var("data"))])
        exe = _bind(mx, ctx, grp, dict(arg, data=x[:BATCH],
                                       softmax_label=y[:BATCH]), aux)
        outs = exe.forward(is_train=False)
        assert [str(o.dtype) for o in outs] == ["float32", "float32",
                                                "bfloat16"], mx
        assert {str(a.dtype) for a in exe.arg_dict.values()} == {"float32"}
        assert {str(a.dtype) for a in exe.aux_dict.values()} == {"float32"}


def _fit(mx, ctx, small, n, kvstore, compute_dtype="bfloat16"):
    """``n`` steps of ``Module(compute_dtype=...).fit`` from the fixture's
    parameters (SGD lr 0.1, momentum 0.9, wd 1e-4); returns the module."""
    arg, aux, x, y = small
    mod = mx.mod.Module(_net(mx), context=ctx, compute_dtype=compute_dtype)
    it = mx.io.NDArrayIter(x[:n * BATCH], y[:n * BATCH], batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in arg.items()},
                    aux_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in aux.items()})
    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4})
    return mod


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("path", ["tpu-1", "tpu-0", "local"])
def test_fit_masters_match(small, monkeypatch, path, steps):
    """The fp32 masters and the moving stats after 1 and 3 steps of
    ``fit`` under compute_dtype="bfloat16": the fused step with the sweep
    (``tpu-1``) and per array (``tpu-0``), and the Updater (``local``),
    each against the JAX package's same path: updates within BF16_UPDATE
    of their largest (or twice the JAX package's own bf16-to-fp32
    distance), moving stats within BF16_STAT; the port's fp32 run of the
    same steps within 1e-5 of the JAX package's."""
    arg, aux, _, _ = small
    kvstore, _, knob = path.partition("-")
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", knob or "0")
    f32 = {k: v.asnumpy() for k, v in _fit(
        jmx, jmx.cpu(), small, steps, kvstore, None).get_params()[0].items()}
    t32 = _fit(tmx, CPU, small, steps, kvstore, None).get_params()[0]
    for k, v in t32.items():
        assert _rel(v.asnumpy() - arg[k], f32[k] - arg[k]) <= 1e-5, k
    res = {}
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, CPU)):
        mod = _fit(mx, ctx, small, steps, kvstore)
        a, b = mod.get_params()
        res[mx] = ({k: v.asnumpy() for k, v in a.items()},
                   {k: v.asnumpy() for k, v in b.items()},
                   {k: str(v.dtype) for k, v in list(a.items())
                    + list(b.items())})
    (ja, jb, jd), (ta, tb, td) = res[jmx], res[tmx]
    assert td == jd and set(td.values()) == {"float32"}
    for k in arg:
        if k == "bn1_gamma" and not np.abs(ja[k] - arg[k]).max():
            continue
        band = max(BF16_UPDATE,
                   2 * _rel(ja[k] - arg[k], f32[k] - arg[k]))
        assert _rel(ta[k] - arg[k], ja[k] - arg[k]) <= band, k
    for k in aux:
        assert _rel(tb[k], jb[k]) <= BF16_STAT, k


def test_fused_step_keeps_fp32_masters_and_slots(small, monkeypatch):
    """Under the sweep the buckets, the weights (views of them) and the
    momentum are fp32; ``get_params`` and ``optimizer_slots`` return fp32."""
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    mod = _fit(tmx, CPU, small, 2, "tpu")
    exe = mod._exec_group.execs[0]
    assert exe._sweep is not None
    assert {f.dtype for f in exe._sweep["flats"]} == {torch.float32}
    slots = exe.optimizer_slots()
    assert slots and {s.dtype for v in slots.values() for s in v} \
        == {torch.float32}
    a, b = mod.get_params()
    assert {str(v.dtype) for v in list(a.values()) + list(b.values())} \
        == {"float32"}


@pytest.mark.parametrize("kvstore", ["tpu", "local"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_module_computes_in_the_compute_dtype(small, monkeypatch,
                                              compute_dtype, kvstore):
    """What ``Module(compute_dtype=...)`` really runs: every convolution
    and FC of its training forward and of ``score`` reads data and
    weight in the compute dtype (bf16, or fp32 without one), while the
    masters stay fp32."""
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    want = "bfloat16/bfloat16" if compute_dtype else "float32/float32"
    with chip_smoke.op_dtype_spy() as fit_ops:
        mod = _fit(tmx, CPU, small, 2, kvstore, compute_dtype)
    _, _, x, y = small
    with chip_smoke.op_dtype_spy() as eval_ops:
        mod.score(tmx.io.NDArrayIter(x[:BATCH], y[:BATCH],
                                     batch_size=BATCH), "acc")
    for ops in (fit_ops, eval_ops):
        assert {k: set(v) for k, v in ops.seen.items()} == {
            "conv2d": {want}, "linear": {want}}, ops.seen
    assert fit_ops.seen["conv2d"][want] == 2
    a, b = mod.get_params()
    assert {str(v.dtype) for v in list(a.values()) + list(b.values())} \
        == {"float32"}


def _resnet50_logits(mx, ctx, sym, arg, aux, x, knob, compute_dtype):
    """ResNet-50's logits (the FC under the SoftmaxOutput) of an eval
    forward of ``x`` with both serving knobs at ``knob``, as fp32 numpy."""
    grp = mx.sym.Group([sym, sym.get_children()[0]])
    old = {k: os.environ.get(k) for k in KNOBS}
    try:
        for k in KNOBS:
            os.environ[k] = knob
        exe = grp.simple_bind(ctx, grad_req="null",
                              compute_dtype=compute_dtype,
                              cast_exclude=("softmax_label",),
                              data=x.shape, softmax_label=(x.shape[0],))
        for n, v in arg.items():
            exe.arg_dict[n][:] = v
        for n, v in aux.items():
            exe.aux_dict[n][:] = v
        out = exe.forward(is_train=False, data=mx.nd.array(x, ctx=ctx))
        return out[1].asnumpy().astype(np.float32)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_resnet50_bf16_eval_peephole_gap_matches_the_jax_package():
    """Why the bf16 eval forward through the BatchNorm->ReLU peephole (K3)
    is held to the knobs-0 one within ``chip_smoke.BF16_EVAL_TOL`` and
    not one bf16 rounding, at ResNet-50 v1's depth (3x64x64, batch 4):

    - with moving mean and beta 0, K3's ``x * scale + bias`` and the plain
      chain's ``(x - mean) * scale + beta`` are one expression, and the
      port's two bf16 paths are bitwise equal; in fp32 they agree within
      1e-5 whatever the stats;
    - with the seed's stats (gamma 1 +- 0.1, beta and mean +- 0.1, var
      0.5-1.5) the two round some BatchNorm outputs to neighbouring bf16
      values, and 50 layers carry it on: the port's paths lie 0.0076 of
      the largest logit apart, the JAX package's own 0.0086; both within
      the limit, and each package's peephole no further from its fp32
      forward than twice its plain bf16 path (1.3x, 1.2x)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "example", "image-classification",
        "symbols"))
    import resnet as jax_resnet
    image = (3, 64, 64)
    tsym = chip_smoke.resnet_symbol(50, image)
    jsym = jax_resnet.get_symbol(1000, 50, "3,64,64")
    arg, aux = chip_smoke.he_params(tsym, image, 7)
    x = np.random.RandomState(1).rand(4, *image).astype(np.float32)
    plain = {(k, c): _resnet50_logits(tmx, CPU, tsym, arg, aux, x, k, c)
             for k in ("0", "1") for c in ("bfloat16", None)}
    assert np.array_equal(plain["1", "bfloat16"], plain["0", "bfloat16"])
    rng = np.random.RandomState(11)
    for n in arg:
        if n.endswith("_gamma"):
            arg[n] = (1 + 0.1 * rng.randn(*arg[n].shape)).astype(np.float32)
        elif n.endswith("_beta"):
            arg[n] = (0.1 * rng.randn(*arg[n].shape)).astype(np.float32)
    aux = {n: ((rng.rand(*v.shape) + 0.5) if n.endswith("_var")
               else 0.1 * rng.randn(*v.shape)).astype(np.float32)
           for n, v in aux.items()}
    got = {}
    for mx, ctx, sym in ((jmx, jmx.cpu(), jsym), (tmx, CPU, tsym)):
        for k in ("0", "1"):
            for c in ("bfloat16", None):
                got[mx, k, c] = _resnet50_logits(mx, ctx, sym, arg, aux, x,
                                                 k, c)
    for mx in (jmx, tmx):
        gap = _rel(got[mx, "1", "bfloat16"], got[mx, "0", "bfloat16"])
        assert 0 < gap <= chip_smoke.BF16_EVAL_TOL, (mx.__name__, gap)
        assert _rel(got[mx, "1", "bfloat16"], got[mx, "0", None]) <= 2 * _rel(
            got[mx, "0", "bfloat16"], got[mx, "0", None]), mx.__name__
    assert _rel(got[tmx, "1", None], got[tmx, "0", None]) <= 1e-5
    assert _rel(plain["1", None], plain["0", None]) <= 1e-5
    assert _rel(got[tmx, "0", None], got[jmx, "0", None]) <= 1e-5


def _blob_images(n, seed):
    """Two classes of 1x8x8 images: a bright top half or bottom half (the
    JAX package's tests/test_train.py data)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 8, 8).astype(np.float32) * 0.3
    y = (rng.rand(n) > 0.5).astype(np.float32)
    x[y > 0, 0, :4] += 0.6
    x[y == 0, 0, 4:] += 0.6
    return x, y


def test_bf16_training_converges():
    """The port of the JAX package's
    ``test_train.py::test_bf16_training_converges``: an MLP under
    compute_dtype="bfloat16" trained by forward_backward/update reaches
    the same accuracy class."""
    tmx.random.seed(0)
    x, y = _blob_images(256, 1)
    train = tmx.io.NDArrayIter(x, y, batch_size=32, shuffle=True)
    net = tmx.sym.Flatten(tmx.sym.var("data"))
    net = tmx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = tmx.sym.SoftmaxOutput(net, name="softmax")
    mod = tmx.mod.Module(net, context=CPU, compute_dtype="bfloat16")
    mod.bind(data_shapes=train.provide_data,
             label_shapes=train.provide_label, for_training=True)
    mod.init_params(tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    metric = tmx.metric.Accuracy()
    for _ in range(8):
        train.reset()
        metric.reset()
        for batch in train:
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
    assert metric.get()[1] > 0.9, metric.get()


def test_module_bf16_trains(monkeypatch):
    """The port of the JAX package's
    ``test_fused_update.py::test_module_bf16_trains``: fp32 masters, bf16
    compute through the fused step; the toy problem must still learn."""
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    tmx.random.seed(0)
    rng = np.random.RandomState(0)
    x = rng.rand(64, 1, 8, 8).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) * 10).astype(np.int32).clip(0, 9).astype(
        np.float32)
    data = tmx.sym.var("data")
    net = tmx.sym.Convolution(data, num_filter=8, kernel=(3, 3),
                              pad=(1, 1), name="c1")
    net = tmx.sym.BatchNorm(net, name="bn1")
    net = tmx.sym.Activation(net, act_type="relu")
    net = tmx.sym.Pooling(net, global_pool=True, pool_type="avg",
                          kernel=(1, 1))
    net = tmx.sym.Flatten(net)
    net = tmx.sym.FullyConnected(net, num_hidden=10, name="fc")
    sym = tmx.sym.SoftmaxOutput(net, name="softmax")
    it = tmx.io.NDArrayIter(x, y, batch_size=16, shuffle=True,
                            label_name="softmax_label")
    mod = tmx.mod.Module(sym, context=CPU, compute_dtype="bfloat16")
    mod.fit(it, num_epoch=8, kvstore="tpu",
            optimizer_params={"learning_rate": 0.3, "momentum": 0.9},
            initializer=tmx.init.Xavier())
    assert mod._exec_group.execs[0]._sweep is not None
    args, _ = mod.get_params()
    for k, v in args.items():
        assert v.dtype == "float32", "master params must stay fp32 (%s)" % k
    it.reset()
    score = mod.score(it, tmx.metric.Accuracy())
    assert score[0][1] > 0.4, score


# ---------------------------------------------------------------------------
# multi-precision optimizers
# ---------------------------------------------------------------------------
MP_OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
            "multi_precision": True},
    "adam": {"learning_rate": 1e-2, "wd": 1e-3, "epsilon": 1e-3,
             "multi_precision": True},
}


def _mp_run(mx, ctx, name, steps, states=None):
    """``steps`` updates of one fp16 weight through a multi-precision
    Updater (its states set from ``states`` bytes first, if given);
    returns (fp16 weight, the states' master and slots as numpy, the
    updater's pickled states)."""
    rng = np.random.RandomState(9)
    w0 = rng.randn(5, 3).astype(np.float16)
    grads = [rng.randn(5, 3).astype(np.float16) for _ in range(4)]
    opt = mx.optimizer.create(name, **MP_OPTIMIZERS[name])
    upd = mx.optimizer.get_updater(opt)
    w = mx.nd.array(w0, ctx=ctx, dtype="float16")
    if states is not None:
        upd.set_states(states)
        grads = grads[2:]
    for g in grads[:steps]:
        upd(0, mx.nd.array(g, ctx=ctx, dtype="float16"), w)
    inner, master = upd.states[0]
    inner = inner if isinstance(inner, (tuple, list)) else (inner,)
    return (w.asnumpy(), [master.asnumpy()] + [s.asnumpy() for s in inner],
            upd.get_states())


@pytest.mark.parametrize("name", sorted(MP_OPTIMIZERS))
def test_multi_precision_matches_the_jax_package(name):
    """The counterpart of the JAX package's
    ``test_optimizer.py::test_multi_precision_sgd``: an fp16 weight keeps
    an fp32 master in its state, ``(slots, master)``; after four updates
    the fp16 weight equals the JAX package's and the master and slots are
    fp32 and equal to its."""
    got = _mp_run(tmx, CPU, name, 4)
    ref = _mp_run(jmx, jmx.cpu(), name, 4)
    assert got[0].dtype == np.float16
    np.testing.assert_array_equal(got[0], ref[0])
    assert [a.dtype for a in got[1]] == [np.float32] * len(ref[1])
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    w16 = tmx.nd.array([1.0], ctx=CPU, dtype="float16")
    tmx.optimizer.get_updater(tmx.optimizer.SGD(
        learning_rate=0.1, momentum=0.9, multi_precision=True))(
        0, tmx.nd.array([1.0], ctx=CPU, dtype="float16"), w16)
    assert w16.dtype == "float16"
    np.testing.assert_allclose(w16.asnumpy(), [0.9], rtol=1e-2)


class _Across(pickle.Unpickler):
    """Unpickles one package's ``.states`` bytes with the other package's
    NDArray: the two files differ in nothing but the module path of the
    array class."""

    def __init__(self, data, src, dst):
        super().__init__(io.BytesIO(data))
        self.src, self.dst = src, dst

    def find_class(self, module, name):
        if module.startswith(self.src + "."):
            module = self.dst + module[len(self.src):]
        return super().find_class(module, name)


@pytest.mark.parametrize("name", sorted(MP_OPTIMIZERS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_multi_precision_states_load_in_the_other_package(name, writer):
    """A multi-precision Updater's ``.states`` bytes after two updates
    hold ``{index: (slots, fp32 master)}`` in both packages, so the bytes
    one package wrote, read with the other's NDArray class, resume there
    as that package's own bytes do: two more updates give the same fp16
    weight, master and slots (SGD's also equal four updates without the
    file; a resumed Adam restarts its update count, as a resumed Adam
    does in both packages)."""
    pkgs = {"port": (tmx, CPU, "mxnet_tpu_torch"),
            "jax": (jmx, jmx.cpu(), "mxnet_tpu")}
    reader = "jax" if writer == "port" else "port"
    wmx, wctx, wname = pkgs[writer]
    rmx, rctx, rname = pkgs[reader]
    blob = _mp_run(wmx, wctx, name, 2)[2]
    moved = pickle.dumps(_Across(blob, wname, rname).load())
    resumed = _mp_run(rmx, rctx, name, 2, states=moved)
    own = _mp_run(rmx, rctx, name, 2,
                  states=_mp_run(rmx, rctx, name, 2)[2])
    runs = [own] + ([_mp_run(rmx, rctx, name, 4)] if name == "sgd" else [])
    for ref in runs:
        np.testing.assert_array_equal(resumed[0], ref[0])
        for a, b in zip(resumed[1], ref[1]):
            np.testing.assert_array_equal(a, b)
    layout = [tuple(type(s).__name__ for s in st)
              for st in pickle.loads(_mp_run(tmx, CPU, name, 2)[2]).values()]
    assert layout == [(("NDArray" if name == "sgd" else "tuple"),
                       "NDArray")]


def test_fused_step_declines_multi_precision():
    """As in the JAX package, the fused step has no multi-precision form:
    ``fused_update_kernel`` returns None, so such a Module updates per
    array through the Updater."""
    opt = tmx.optimizer.SGD(momentum=0.9, multi_precision=True)
    assert tmx.optimizer.fused_update_kernel(opt) is None
    assert jmx.optimizer.fused_update_kernel(jmx.optimizer.SGD(
        momentum=0.9, multi_precision=True)) is None


# ---------------------------------------------------------------------------
# gluon cast
# ---------------------------------------------------------------------------
def _mlp(mx, ctx, seed=4):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
                mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _copy_params(src, dst, ctx):
    for (_, p), (_, q) in zip(sorted(src.collect_params().items()),
                              sorted(dst.collect_params().items())):
        q.set_data(tmx.nd.array(p.data().asnumpy(), ctx=ctx))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_block_cast_dtypes_and_gradients(dtype):
    """``Block.cast``: every parameter's data and grad in the new dtype,
    as the JAX package's; a hybridized block's next forward runs in it (no
    cached graph of the old dtype survives: the JAX package clears its
    cache), its output within BF16_FWD of the JAX package's, and a
    backward writes gradients of the new dtype into the cast buffers."""
    x = np.random.RandomState(5).randn(6, 8).astype(np.float32)
    jnet, tnet = _mlp(jmx, jmx.cpu()), _mlp(tmx, CPU)
    _copy_params(jnet, tnet, CPU)
    outs, grads = {}, {}
    for mx, net, ctx in ((jmx, jnet, jmx.cpu()), (tmx, tnet, CPU)):
        net.hybridize()
        net(mx.nd.array(x, ctx=ctx))
        net.cast(dtype)
        if mx is jmx:
            assert all(not b._jit_cache for b in [net] + list(
                net._children.values()))
        xin = mx.nd.array(x, ctx=ctx).astype(dtype)
        with mx.autograd.record():
            out = net(xin)
            loss = (out * out).sum()
        loss.backward()
        outs[mx] = out
        grads[mx] = {k[len(net.prefix):]: (str(p.data().dtype),
                                           str(p.grad().dtype),
                                           p.grad().asnumpy().astype(
                                               np.float32))
                     for k, p in net.collect_params().items()}
    assert str(outs[tmx].dtype) == str(outs[jmx].dtype) == dtype
    assert _rel(outs[tmx].asnumpy(), outs[jmx].asnumpy()) <= BF16_FWD
    assert sorted(grads[tmx]) == sorted(grads[jmx])
    for k, (dt, gdt, g) in grads[tmx].items():
        assert (dt, gdt) == grads[jmx][k][:2] == (dtype, dtype), k
        assert np.abs(g).max() > 0, k


def test_parameter_cast_before_and_after_initialize():
    """``Parameter.cast`` on an initialized parameter casts data and grad
    and marks them again (a backward writes the cast grad buffer); on a
    deferred one it sets the dtype the value is created in."""
    p = tmx.gluon.Parameter("w", shape=(3,))
    p.initialize(tmx.init.One(), ctx=CPU)
    p.cast("bfloat16")
    assert p.data().dtype == p.grad().dtype == "bfloat16"
    with tmx.autograd.record():
        y = (p.data() * 3).sum()
    y.backward()
    np.testing.assert_array_equal(p.grad().asnumpy().astype(np.float32),
                                  [3, 3, 3])
    q = tmx.gluon.Parameter("v", shape=(0, 2), allow_deferred_init=True)
    q.initialize(tmx.init.One(), ctx=CPU)
    q.cast("float16")
    q.shape = (4, 2)
    q._finish_deferred_init()
    assert q.data().dtype == "float16" and q.grad().dtype == "float16"


VOCAB = 32
SMALL = dict(units=64, hidden_size=128, num_layers=2, num_heads=4,
             max_len=32)
LM_ADAM = {"learning_rate": 1e-2, "epsilon": 1e-3}
# Adam's first update is lr * g / (|g| + LM_EPS)
LM_EPS = LM_ADAM["epsilon"] / np.sqrt(1 - 0.999)


@pytest.fixture(scope="module")
def cast_lm():
    """A small TransformerLM built by the JAX package, its fp32 weights,
    and one batch at T 16."""
    jmx.random.seed(5)
    lm = jtr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(jmx.init.Xavier())
    lm(jmx.nd.zeros((1, 4)))
    weights = {k: v.data().asnumpy() for k, v in lm.collect_params().items()}
    ids = np.random.RandomState(70).randint(0, VOCAB, (2, 17))
    return (lm.prefix, weights, ids[:, :-1].astype(np.float32),
            ids[:, 1:].astype(np.float32))


def _lm_step(mx, ctx, cast_lm, dtype="bfloat16"):
    """The LM of ``cast_lm``'s weights cast to ``dtype``: its logits,
    then one record -> SoftmaxCrossEntropyLoss -> backward -> Adam step;
    returns (logits, loss, gradients, parameters after the step) as
    numpy."""
    prefix, weights, x, y = cast_lm
    if mx is jmx:
        lm = jtr.TransformerLM(VOCAB, prefix=prefix, **SMALL)
        lm.initialize(jmx.init.Xavier())
        lm(jmx.nd.zeros((1, 4)))
        for k, p in lm.collect_params().items():
            p.set_data(jmx.nd.array(weights[k]))
    else:
        lm = ttr.TransformerLM(VOCAB, prefix=prefix, **SMALL)
        lm.initialize(tmx.init.Xavier(), ctx=ctx)
        tmx.convert.block_params_from_numpy(lm, weights, ctx=ctx)
    lm.cast(dtype)
    lm.hybridize()
    xs, ys = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    logits = lm(xs).asnumpy().astype(np.float32)
    params = lm.collect_params()
    trainer = mx.gluon.Trainer(params, "adam", dict(LM_ADAM))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(lm(xs).reshape((-1, VOCAB)), ys.reshape((-1,))).mean()
    loss.backward()
    grads = {k: p.grad().asnumpy().astype(np.float32)
             for k, p in params.items()}
    trainer.step(1)
    after = {k: (str(p.data().dtype), p.data().asnumpy().astype(np.float32))
             for k, p in params.items()}
    return logits, float(loss.asnumpy()), grads, after


@pytest.mark.parametrize("knob", ["0", "1"])
def test_cast_transformer_lm_matches_the_jax_package(cast_lm, monkeypatch,
                                                     knob):
    """A 2-layer, 64-unit, 4-head TransformerLM cast to bf16 at T 16 (the
    JAX package runs it: its forward and step are the reference here):
    the logits within BF16_FWD of the largest, every gradient nonzero and
    within BF16_UPDATE of its largest (or twice the JAX package's own
    bf16-to-fp32 distance), the same step in fp32 within 1e-5 of the JAX
    package's, and every parameter after one Adam
    step bf16 and, element by element, within 2^-6 of the sum of its
    magnitudes before and after the step (two to four bf16 steps of the
    largest of ``w``, ``u`` and ``w - u``: the two packages round Adam's
    intermediate bf16 values at other places) plus what the
    gradients' difference can move Adam's first
    update ``lr * g / (|g| + eps')`` (eps' = eps / sqrt(1 - beta2)): at
    most ``lr * |dg| / eps'``, and never more than ``2 lr``."""
    for k in ("MXNET_PALLAS_NORM", "MXNET_PALLAS_SOFTMAX"):
        monkeypatch.setenv(k, knob)
    _, weights, _, _ = cast_lm
    jl, jloss, jg, ja = _lm_step(jmx, jmx.cpu(), cast_lm)
    tl, tloss, tg, ta = _lm_step(tmx, CPU, cast_lm)
    jg32 = _lm_step(jmx, jmx.cpu(), cast_lm, "float32")[2]
    tg32 = _lm_step(tmx, CPU, cast_lm, "float32")[2]
    for k in jg32:
        assert _rel(tg32[k], jg32[k]) <= 1e-5, k
    _, weights, _, _ = cast_lm
    assert _rel(tl, jl) <= BF16_FWD
    assert abs(tloss - jloss) <= BF16_FWD * abs(jloss)
    for k in jg:
        assert np.abs(tg[k]).max() > 0, k
        band = max(BF16_UPDATE, 2 * _rel(jg[k], jg32[k]))
        assert _rel(tg[k], jg[k]) <= band, (k, _rel(tg[k], jg[k]))
        assert ta[k][0] == ja[k][0] == "bfloat16", k
        mag = np.abs(ja[k][1]) + np.abs(weights[k])
        tol = mag * 2.0 ** -6 + LM_ADAM["learning_rate"] * \
            np.minimum(2.0, np.abs(tg[k] - jg[k]) / LM_EPS)
        assert (np.abs(ta[k][1] - ja[k][1]) <= tol).all(), k


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------
def test_chip_smoke_mixed_precision_phase_rehearses_on_the_cpu(monkeypatch):
    """``mixed_fit`` trains a small ResNet under compute_dtype="bfloat16"
    through the fused step (knob 1: the sweep's plain version) with fp32
    masters, slots and moving stats and a falling loss, and holds its
    first step to the same step with every knob 0; ``mixed_eval`` holds a
    bf16 eval forward through the peephole to the knobs-0 one;
    ``fp16_multi_precision`` trains a small fp16 gluon MLP through a
    multi-precision SGD with fp32 masters."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.symbols import resnet
    sym = resnet.get_symbol(10, 20, "3,28,28")
    fit = chip_smoke.mixed_fit(tmx, ck, CPU, sym, (3, 28, 28), batch=4,
                               steps=3, warmup=1, classes=10, on="1")
    assert fit["masters_fp32"] and fit["ce_last"] < fit["ce_first"]
    assert fit["kernel"] == "sgd_mom_sweep" and fit["fused"]
    assert fit["first_step"]["max_by_largest_update"] <= \
        chip_smoke.MIXED_STEP_TOL, fit["first_step"]
    assert set(fit["dtypes"]["sgd_mom_sweep"]) == {"float32"}
    assert set(fit["dtypes"]["softmax_lastaxis"]) == {"float32"}
    assert {k: set(v) for k, v in fit["compute_dtypes"].items()} == {
        "conv2d": {"bfloat16/bfloat16"}, "linear": {"bfloat16/bfloat16"}}
    ev = chip_smoke.mixed_eval(tmx, ck, CPU, fit["module"], (3, 28, 28),
                               batch=4, classes=10, on="1")
    assert (ev["dtype"], ev["logits_dtype"]) == ("float32", "bfloat16")
    sites = len(chip_smoke.k3_sites(tmx, sym, 4, (3, 28, 28)))
    assert ev["dtypes"]["scale_bias_relu"] == {"bfloat16": sites}
    assert ev["max_by_largest"] <= chip_smoke.BF16_EVAL_TOL, ev
    assert ev["kernel_vs_fp32"] <= 2 * ev["plain_vs_fp32"], ev
    assert 0 < ev["plain_vs_fp32"] < 2.0 ** -4, ev
    mp = chip_smoke.fp16_multi_precision(tmx, CPU, steps=5)
    assert mp["weights"] == {"float16"} and mp["masters"] == {"float32"}
    assert mp["losses"][-1] < mp["losses"][0]


def test_chip_smoke_cast_transformer_phase_rehearses_on_the_cpu(monkeypatch):
    """``lm_mixed`` at small width with ctx=cpu() and the norm and softmax
    knobs at 1: the bf16-cast forward's LayerNorms and masked softmaxes
    all take bf16 operands (the CPU never takes the flash route under
    ``auto``), its logits bf16 and within LM_BF16_LOGIT_TOL of the knobs-0
    bf16 forward; the step's gradients bf16, nonzero and within their
    bands of the knobs-0 step with the same ReLU decisions; one step's
    LayerNorm backwards bf16; the loss falls over the timed steps."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    for k in ("MXNET_PALLAS_NORM", "MXNET_PALLAS_SOFTMAX"):
        monkeypatch.setenv(k, "1")
    config = dict(SMALL, vocab_size=VOCAB)
    fwd, train, run = chip_smoke.lm_mixed(tmx, ck, CPU, config, batch=2,
                                          t=16, warmup=1, steps=3)
    layers = SMALL["num_layers"]
    assert fwd["dtypes"] == {"layernorm_fwd": {"bfloat16": 2 * layers + 1},
                             "bias_softmax": {"bfloat16": layers}}
    assert fwd["logits_dtype"] == "bfloat16" and fwd["finite"]
    assert fwd["dev"] <= max(chip_smoke.LM_BF16_LOGIT_TOL,
                             2 * fwd["dev_plain_fp32"]), fwd
    assert train["grad_dtypes"] == ["bfloat16"] and not train["zero_grads"]
    assert train["grad_dev_by_band"] <= 1.0, train
    assert train["dtypes"]["layernorm_bwd"] == {"bfloat16": 2 * layers + 1}
    assert train["param_dtypes"] == ["bfloat16"]
    assert train["losses"][-1] < train["losses"][0]
    assert run[0] is not None and not any(train["calls"].values())


@pytest.mark.parametrize("table,kind", [
    ("KINDS", "convolution"), ("LM_KINDS", "GEMM"),
    ("LM_TRAIN_KINDS", "GEMM")])
def test_chip_smoke_profiles_count_cublas_bf16_gemms(table, kind):
    """cuBLAS runs bf16 products in kernels named ``nvjet_*`` (on the H100,
    ``nvjet_tst_192x128_64x5_1x2_h_bz_coopB_TNT``); the profile tables
    count them with the products (the ResNet table lumps its FC with the
    convolutions), not in "other"."""
    us = chip_smoke.by_kind({"nvjet_tst_192x128_64x5_1x2_h_bz_coopB_TNT": 1.0},
                            getattr(chip_smoke, table))
    assert us[kind] == 1.0 and sum(us.values()) == 1.0
