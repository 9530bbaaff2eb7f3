"""The port's default context against the JAX package's, on the CPU.

``with ctx:`` makes ``ctx`` the default of the block's thread in both
packages (reference: python/mxnet/context.py), so arrays, gluon
parameters and modules created inside a ``with cpu(0):`` block without a
``ctx`` land on ``cpu(0)``.  Outside any block the port's default is
``gpu(0)`` (its entry points run on the card), the JAX package's the CPU
here; each test compares what a block changes, not the two defaults.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PACKAGES = {"jax": jmx, "torch": tmx}


@pytest.fixture(params=sorted(PACKAGES))
def mx(request):
    return PACKAGES[request.param]


def _ctx(a):
    return str(a.context)


def test_creation_inside_a_cpu_block_lands_on_cpu0():
    """nd.zeros, nd.ones, nd.full, nd.empty and nd.array without ``ctx``
    inside ``with cpu(0):`` are cpu(0) arrays in both packages, with the
    same values."""
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = {}
    for name, mx in PACKAGES.items():
        with mx.cpu(0):
            arrays = (mx.nd.zeros((2, 2)), mx.nd.ones((2, 3)),
                      mx.nd.full((3,), 7.0), mx.nd.empty((1, 2)),
                      mx.nd.array(src))
        got[name] = arrays
        assert [_ctx(a) for a in arrays] == ["cpu(0)"] * 5, name
    for a, b in zip(got["jax"], got["torch"]):
        assert a.shape == b.shape and a.dtype == b.dtype
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got["jax"][i].asnumpy(),
                                      got["torch"][i].asnumpy())


def test_gluon_parameters_initialized_in_a_cpu_block_land_on_cpu0():
    """A Dense block initialized inside ``with cpu(0):`` with no ``ctx``
    has its weights on cpu(0), also those whose shape the first forward
    fills in after the block has ended; the forward agrees with the JAX
    package's on the same weights."""
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    outs, weights = {}, None
    for name in ("jax", "torch"):
        mx = PACKAGES[name]
        net = mx.gluon.nn.Dense(3, prefix="dense_")
        with mx.cpu(0):
            net.initialize(mx.init.Xavier())
            assert str(mx.current_context()) == "cpu(0)"
        with mx.cpu(0):
            xin = mx.nd.array(x)
        out = net(xin)      # deferred shapes finish outside the block
        params = net.collect_params()
        assert {str(p.data().context) for p in params.values()} == \
            {"cpu(0)"}, name
        if weights is None:
            weights = {k: v.data().asnumpy() for k, v in params.items()}
        else:
            for k, v in params.items():
                v.set_data(weights[k])
            out = net(xin)
        assert _ctx(out) == "cpu(0)"
        outs[name] = out.asnumpy()
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-6,
                               atol=1e-6)


def test_a_parameter_initialized_in_a_block_keeps_its_context():
    """A lone Parameter with a known shape initialized inside the block
    lands on cpu(0) in both packages."""
    for name, mx in PACKAGES.items():
        p = mx.gluon.Parameter("w", shape=(2, 3))
        with mx.cpu(0):
            p.initialize(mx.init.Zero())
        assert _ctx(p.data()) == "cpu(0)", name
        np.testing.assert_array_equal(p.data().asnumpy(), np.zeros((2, 3)))


def test_module_created_in_a_cpu_block_binds_on_cpu0():
    """``Module(sym)`` without ``context`` inside the block takes cpu(0),
    and its forward matches the JAX package's."""
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    outs = {}
    for name, mx in PACKAGES.items():
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
        with mx.cpu(0):
            mod = mx.mod.Module(net, label_names=None)
        assert [str(c) for c in mod._context] == ["cpu(0)"], name
        mod.bind(data_shapes=[("data", (2, 4))], for_training=False)
        w = np.arange(12, dtype=np.float32).reshape(3, 4) / 10
        b = np.array([0.5, -1.0, 2.0], np.float32)
        with mx.cpu(0):
            mod.init_params(arg_params={"fc_weight": mx.nd.array(w),
                                        "fc_bias": mx.nd.array(b)})
            mod.forward(mx.io.DataBatch([mx.nd.array(x)]), is_train=False)
        out = mod.get_outputs()[0]
        assert _ctx(out) == "cpu(0)", name
        outs[name] = out.asnumpy()
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-6,
                               atol=1e-6)


def test_nested_blocks_restore_the_outer_context(mx):
    """An inner block's context holds inside it; its end restores the
    outer block's, and the outer block's end the default."""
    outside = str(mx.current_context())
    with mx.cpu(0) as c:
        assert c == mx.cpu(0)
        assert str(mx.current_context()) == "cpu(0)"
        with mx.gpu(0):
            assert str(mx.current_context()) == "gpu(0)"
        assert str(mx.current_context()) == "cpu(0)"
        with mx.cpu(1):
            assert str(mx.current_context()) == "cpu(1)"
            with mx.cpu(0):
                assert _ctx(mx.nd.zeros((1,))) == "cpu(0)"
            assert str(mx.current_context()) == "cpu(1)"
        assert _ctx(mx.nd.ones((1,))) == "cpu(0)"
    assert str(mx.current_context()) == outside


def test_a_block_ends_on_an_exception(mx):
    """A block left by an exception restores the context before it."""
    outside = str(mx.current_context())
    with pytest.raises(ValueError):
        with mx.cpu(0):
            raise ValueError("inside")
    assert str(mx.current_context()) == outside


def test_another_thread_keeps_the_default(mx):
    """A thread started inside a block sees the default, not the block's
    context, and its own block does not reach the first thread."""
    outside = str(mx.current_context())
    seen, barrier = {}, threading.Barrier(2)

    def worker():
        seen["start"] = str(mx.current_context())
        with mx.cpu(0):
            barrier.wait()      # the main thread reads while this block holds
            barrier.wait()
            seen["inside"] = str(mx.current_context())
        seen["after"] = str(mx.current_context())

    with mx.gpu(0):
        th = threading.Thread(target=worker)
        th.start()
        barrier.wait()
        seen["main"] = str(mx.current_context())
        barrier.wait()
        th.join()
    assert seen == {"start": outside, "inside": "cpu(0)", "after": outside,
                    "main": "gpu(0)"}


def test_current_context_inside_and_outside_a_block():
    """current_context (top level and in ``context``) is the block's
    context inside it; outside it is the port's default, gpu(0), where
    the JAX package's is its CPU host here."""
    for mx, outside in ((jmx, "cpu(0)"), (tmx, "gpu(0)")):
        assert mx.current_context is mx.context.current_context
        assert str(mx.current_context()) == outside
        assert mx.current_context() == mx.Context.default_ctx()
        with mx.cpu(0):
            assert mx.current_context() == mx.cpu(0)
            assert isinstance(mx.current_context(), mx.Context)
        assert str(mx.current_context()) == outside


def test_the_port_still_defaults_to_the_gpu():
    """With no block the port's creation sites resolve gpu(0), which
    raises on a machine without CUDA and names the way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: gpu(0) does not raise here")
    for make in (lambda: tmx.nd.zeros((2, 2)), lambda: tmx.nd.array([1.0]),
                 lambda: tmx.gluon.Parameter("w", shape=(2,)).initialize(),
                 lambda: tmx.mod.Module(tmx.sym.Variable("data"))):
        with pytest.raises(MXNetError, match=r"gpu\(0\).*ctx=cpu\(\)"):
            make()
    with tmx.cpu(0):
        assert tmx.nd.zeros((2, 2)).context == tmx.cpu(0)


def test_mx_torch_is_not_pytorch():
    """``mx.torch`` does not name PyTorch in the port (in the JAX package
    it is the bridge module); the port still imports torch, privately."""
    assert getattr(tmx, "torch", None) is not torch
    assert not hasattr(tmx, "torch")
    assert tmx._torch is torch
    assert jmx.torch is not torch and hasattr(jmx.torch, "to_torch")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
