"""The port's gluon losses, ``gluon.utils``, ``Constant`` and the dense
storage defaults against the JAX package's, on the CPU.  Each loss runs
on the same numpy predictions and labels (with and without a sample
weight); its per-sample values and the prediction's gradient must lie
within 1e-6 of the largest magnitude of each (the fp32 band).
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

from test_torch_gluon_layers import TOL, build, init, nd, rel

SEED = 0


def _rng(seed=SEED):
    return np.random.RandomState(seed)


def _data(kind, n=4, c=5):
    r = _rng()
    pred = r.randn(n, c).astype(np.float32)
    if kind == "class":
        return pred, r.randint(0, c, n).astype(np.float32)
    if kind == "signed":
        return pred, np.sign(r.randn(n, c)).astype(np.float32)
    if kind == "binary":
        return pred, (r.rand(n, c) > 0.5).astype(np.float32)
    if kind == "prob":
        p = r.rand(n, c).astype(np.float32) + 0.05
        return pred, p / p.sum(axis=1, keepdims=True)
    if kind == "sigmoid":
        return (1 / (1 + np.exp(-pred))).astype(np.float32), \
            (r.rand(n, c) > 0.5).astype(np.float32)
    return pred, r.randn(n, c).astype(np.float32)


LOSSES = {
    "l2": (lambda g: g.loss.L2Loss(), "real"),
    "l1": (lambda g: g.loss.L1Loss(weight=0.5), "real"),
    "sigmoid_bce": (lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(),
                    "binary"),
    "sigmoid_bce_from_sigmoid": (lambda g: g.loss.SigmoidBCELoss(
        from_sigmoid=True), "sigmoid"),
    "softmax_ce": (lambda g: g.loss.SoftmaxCrossEntropyLoss(), "class"),
    "kldiv": (lambda g: g.loss.KLDivLoss(from_logits=False), "prob"),
    "kldiv_logits": (lambda g: g.loss.KLDivLoss(), "prob"),
    "huber": (lambda g: g.loss.HuberLoss(rho=0.7), "real"),
    "hinge": (lambda g: g.loss.HingeLoss(margin=0.5), "signed"),
    "squared_hinge": (lambda g: g.loss.SquaredHingeLoss(), "signed"),
    "logistic_signed": (lambda g: g.loss.LogisticLoss(), "signed"),
    "logistic_binary": (lambda g: g.loss.LogisticLoss(
        label_format="binary"), "binary"),
}


def _loss_run(mx, make, pred, label, sample_weight):
    loss_fn = make(mx.gluon)
    p = nd(mx, pred)
    p.attach_grad()
    args = [nd(mx, label)]
    if sample_weight is not None:
        args.append(nd(mx, sample_weight))
    with mx.autograd.record():
        loss = loss_fn(p, *args)
    loss.backward()
    return loss.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "sample_weight"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_the_jax_package(name, weighted):
    make, kind = LOSSES[name]
    pred, label = _data(kind)
    sw = _rng(1).rand(pred.shape[0], 1).astype(np.float32) \
        if weighted else None
    want = _loss_run(jmx, make, pred, label, sw)
    with tmx.cpu():
        got = _loss_run(tmx, make, pred, label, sw)
    assert got[0].shape == want[0].shape == (pred.shape[0],)
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


def test_triplet_loss_matches_the_jax_package():
    r = _rng()
    a, pos, neg = (r.randn(4, 3, 2).astype(np.float32) for _ in range(3))
    out = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            x = nd(mx, a)
            x.attach_grad()
            with mx.autograd.record():
                loss = mx.gluon.loss.TripletLoss(margin=2)(
                    x, nd(mx, pos), nd(mx, neg))
            loss.backward()
            out[mx] = (loss.asnumpy(), x.grad.asnumpy())
    for g, w in zip(out[tmx], out[jmx]):
        assert rel(g, w) <= TOL
    assert (out[tmx][0] >= 0).all() and (out[tmx][0] > 0).any()


def test_logistic_loss_refuses_an_unknown_label_format():
    for mx in (jmx, tmx):
        with pytest.raises(ValueError):
            mx.gluon.loss.LogisticLoss(label_format="sign")


# -- gluon.utils -----------------------------------------------------------
@pytest.mark.parametrize("batch_axis,even,n,size", [
    (0, True, 2, 6), (1, True, 3, 6), (0, False, 4, 6), (0, False, 8, 5)])
def test_split_data_matches_the_jax_package(batch_axis, even, n, size):
    shape = [3, 3]
    shape[batch_axis] = size
    a = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = [s.asnumpy() for s in jmx.gluon.utils.split_data(
        jmx.nd.array(a), n, batch_axis, even)]
    with tmx.cpu():
        got = [s.asnumpy() for s in tmx.gluon.split_data(
            tmx.nd.array(a), n, batch_axis, even)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split_data_refuses_an_uneven_split():
    for mx in (jmx, tmx):
        with tmx.cpu():
            with pytest.raises(ValueError):
                mx.gluon.utils.split_data(mx.nd.zeros((5, 2)), 2)


def test_split_and_load_puts_each_slice_on_its_context():
    a = np.arange(8, dtype=np.float32).reshape(4, 2)
    got = tmx.gluon.split_and_load(a, [tmx.cpu(), tmx.cpu()])
    want = jmx.gluon.split_and_load(a, [jmx.cpu(), jmx.cpu()])
    assert [g.context for g in got] == [tmx.cpu(), tmx.cpu()]
    assert [g.shape for g in got] == [(2, 2), (2, 2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    one = tmx.gluon.split_and_load(tmx.nd.array(a, ctx=tmx.cpu()),
                                   [tmx.cpu()])
    assert len(one) == 1 and one[0].shape == (4, 2)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_clip_global_norm_matches_the_jax_package(max_norm):
    r = _rng()
    arrays = [r.randn(3, 4).astype(np.float32), r.randn(5).astype(np.float32)]
    jarr = [jmx.nd.array(a) for a in arrays]
    want = jmx.gluon.utils.clip_global_norm(jarr, max_norm)
    with tmx.cpu():
        tarr = [tmx.nd.array(a) for a in arrays]
        got = tmx.gluon.clip_global_norm(tarr, max_norm)
    assert isinstance(got, float)
    assert abs(got - want) <= TOL * want
    for t, j in zip(tarr, jarr):
        assert rel(t.asnumpy(), j.asnumpy()) <= TOL


def test_clip_global_norm_warns_on_a_non_finite_norm():
    with tmx.cpu():
        with pytest.warns(UserWarning, match="nan or inf"):
            tmx.gluon.clip_global_norm(
                [tmx.nd.array(np.array([np.inf, 1.0], np.float32))], 1.0)


def test_check_sha1_and_download_use_local_files_only(tmp_path):
    """``download`` returns a file already in place (by path, directory
    or ``file://`` url, with its sha1 when given) and raises otherwise,
    in both packages; nothing is fetched."""
    import hashlib
    f = tmp_path / "w.params"
    f.write_bytes(b"weights")
    sha = hashlib.sha1(b"weights").hexdigest()
    for mx in (jmx, tmx):
        u = mx.gluon.utils
        assert u.check_sha1(str(f), sha) and not u.check_sha1(str(f), "0" * 40)
        url = "file://" + str(f)
        assert u.download(url, path=str(tmp_path)) == str(f)
        assert u.download(url, path=str(f), sha1_hash=sha) == str(f)
        for kw in ({"sha1_hash": "0" * 40}, {"overwrite": True}):
            with pytest.raises(Exception, match="w.params"):
                u.download(url, path=str(f), **kw)
        with pytest.raises(Exception, match="missing.params"):
            u.download("https://example.invalid/missing.params",
                       path=str(tmp_path))
    with pytest.raises(MXNetError):
        tmx.gluon.utils.download("https://example.invalid/missing.params",
                                 path=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["w.params"]


# -- Constant, get_constant and the dense storage defaults ------------------
def _constant_net(value):
    def make(mx):
        class Net(mx.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.c = self.params.get_constant("c", value)
                    self.w = self.params.get("w", shape=(2, 3))

            def hybrid_forward(self, F, x, c, w):
                return x * c + w

        return Net(prefix="net_")
    return make


def test_constant_matches_the_jax_package():
    """A ``get_constant`` parameter in a block: no gradient, its value
    after ``initialize``, the forward ``x * c + w``.  The JAX package's
    ``initialize`` cannot find a Constant's initializer by name
    (KeyError), so its forward is held with the constant set by hand,
    and the port's ``initialize`` must give the same."""
    value = _rng().randn(2, 3).astype(np.float32)
    make = _constant_net(value)
    jnet = build(jmx, make)
    with pytest.raises(KeyError):
        init(jmx, jnet)
    jp = jnet.collect_params()
    for k in ("net_c", "net_w"):
        jp[k].initialize(init=jmx.init.Zero(), force_reinit=True)
    jp["net_c"].set_data(jmx.nd.array(value))
    out = {}
    with tmx.cpu():
        tnet = build(tmx, make)
        init(tmx, tnet)
        assert tnet.params.get_constant("c") is tnet.c
        with pytest.raises(KeyError):
            tnet.params.get_constant("absent")
        for mx, net in ((jmx, jnet), (tmx, tnet)):
            p = net.collect_params()
            p["net_w"].set_data(mx.nd.array(np.ones((2, 3), np.float32)))
            x = nd(mx, np.full((2, 3), 2.0))
            with mx.autograd.record():
                y = net(x)
            y.backward()
            c = p["net_c"]
            out[mx] = (c.grad_req, type(c).__name__, y.asnumpy(),
                       c.data().asnumpy(), p["net_w"].grad().asnumpy())
    assert out[tmx][:2] == out[jmx][:2] == ("null", "Constant")
    for g, w in zip(out[tmx][2:], out[jmx][2:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(out[tmx][3], value)


def test_get_constant_refuses_a_parameter_of_that_name():
    with tmx.cpu():
        d = tmx.gluon.ParameterDict("p_")
        d.get("x", shape=(1,))
        with pytest.raises(MXNetError, match="not a constant"):
            d.get_constant("x", [1.0])


def test_dense_storage_defaults_are_accepted_and_sparse_ones_refused():
    """Queue 3 item 4, then sparse storage: ``Parameter(stype=,
    grad_stype=)`` and ``Embedding(sparse_grad=)`` take the dense
    defaults and the sparse values as the JAX package does (nothing is
    refused now): the storage types are kept, the data stays dense, and
    ``sparse_grad=True`` makes the weight's gradient row-sparse; the
    lookups agree."""
    outs = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            p = mx.gluon.Parameter("w", shape=(2,), stype="default",
                                   grad_stype="default")
            assert p.name == "w"
            for kw in ({"stype": "row_sparse"}, {"grad_stype": "row_sparse"},
                       {"stype": "csr"}):
                q = mx.gluon.Parameter("w", shape=(2,), **kw)
                assert (q._stype, q._grad_stype) == (
                    kw.get("stype", "default"),
                    kw.get("grad_stype", "default"))
            for sparse_grad in (False, True):
                emb = build(mx, lambda m: m.gluon.nn.Embedding(
                    5, 3, sparse_grad=sparse_grad, prefix="e_"))
                init(mx, emb)
                emb.weight.set_data(nd(mx, np.arange(15).reshape(5, 3)))
                assert emb.weight._grad_stype == (
                    "row_sparse" if sparse_grad else "default")
                assert emb.weight.data().stype == "default"
                outs.append(emb(nd(mx, [[1, 4]])).asnumpy())
    assert outs[0].shape == (1, 2, 3)
    for j, t in zip(outs[:2], outs[2:]):
        np.testing.assert_array_equal(t, j)
