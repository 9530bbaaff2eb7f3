"""Sparse storage in the port against the JAX package on the CPU: the
cases of ``tests/test_sparse.py`` run through both packages from shared
numpy inputs (the port's results within 1e-6 of the largest value of the
JAX package's, untouched rows and the CSR structure bit for bit), the
storage ops, ``nd.save`` of a sparse array, and a row-sparse step that
moves no payload to the host."""
import collections
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as tsp

F32 = 1e-6


def close(got, want, band=F32):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    assert float(np.abs(got.astype(np.float64) - want).max()) <= band * scale


def both():
    """``(mx, sparse module)`` of each package, the JAX package first."""
    return ((jmx, jsp), (tmx, tsp))


def in_both(fn):
    """``fn(mx, sp)`` through each package (the port's inside ``with
    mx.cpu():``): ``[the JAX package's result, the port's]``."""
    out = []
    for mx, sp in both():
        with tmx.cpu():
            out.append(fn(mx, sp))
    return out


def test_rowsparse_accessors():
    dense = np.zeros((6, 3), np.float32)
    dense[1] = 1.0
    dense[4] = 2.0

    def run(mx, sp):
        rs = sp.row_sparse_array(dense)
        assert rs.stype == "row_sparse" and rs.shape == (6, 3)
        return (rs.indices.asnumpy(), rs.data.asnumpy(), rs.asnumpy())
    j, t = in_both(run)
    assert t[0].tolist() == j[0].tolist() == [1, 4]
    # the dtype stated: MXNet's int64 aux type in the port, int32 in the
    # JAX package (no 64-bit types without x64)
    assert (t[0].dtype, j[0].dtype) == (np.int64, np.int32)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], dense)


def test_csr_accessors_match_bitwise():
    a = np.random.RandomState(1).rand(5, 7).astype(np.float32)
    a[a < 0.6] = 0.0

    def run(mx, sp):
        csr = sp.csr_matrix(a)
        return (csr.indptr.asnumpy(), csr.indices.asnumpy(),
                csr.data.asnumpy(), csr.asnumpy())
    j, t = in_both(run)
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x, y)
    assert t[0].dtype == t[1].dtype == np.int64


@pytest.mark.parametrize("form", ["plain", "transpose_a", "vector",
                                  "method"])
def test_csr_dot_matches_the_jax_package(form):
    rng = np.random.RandomState(0)
    a = rng.rand(5, 7).astype(np.float32)
    a[a < 0.6] = 0.0
    rhs = {"plain": rng.rand(7, 4), "transpose_a": rng.rand(5, 4),
           "vector": rng.rand(7), "method": rng.rand(7, 4)}[form] \
        .astype(np.float32)

    def run(mx, sp):
        csr = sp.csr_matrix(a)
        r = mx.nd.array(rhs)
        if form == "method":
            return csr.dot(r).asnumpy()
        return mx.nd.dot(csr, r, transpose_a=form == "transpose_a") \
            .asnumpy()
    j, t = in_both(run)
    close(t, j)
    close(t, (a.T if form == "transpose_a" else a) @ rhs, 1e-5)


def test_csr_dot_never_materializes_and_a_rebind_recompacts():
    b = np.arange(12).astype(np.float32).reshape(3, 4)

    def run(mx, sp):
        csr = sp.csr_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                             np.array([0, 2, 1]), np.array([0, 2, 3])),
                            shape=(2, 3))
        out = mx.nd.dot(csr, mx.nd.array(b)).asnumpy()
        assert csr._dense_cache is None, "CSR dot read the dense value"
        new = np.array([[0, 7, 0], [0, 0, 0]], np.float32)
        csr._data = mx.nd.array(new)._data
        return out, csr.data.asnumpy(), csr.indices.asnumpy(), \
            csr.indptr.asnumpy()
    j, t = in_both(run)
    close(t[0], j[0])
    np.testing.assert_array_equal(
        t[0], np.array([[1, 0, 2], [0, 3, 0]], np.float32) @ b)
    assert t[1].tolist() == j[1].tolist() == [7.0]
    assert t[2].tolist() == j[2].tolist() == [1]
    assert t[3].tolist() == j[3].tolist() == [0, 1, 1]


class TensorSpy(TorchFunctionMode):
    """Counts host reads (``.cpu()``, ``.numpy()``, ``.tolist()``,
    ``.item()`` and the number conversions) and records the largest
    tensor any torch call returns."""

    HOST = ("cpu", "numpy", "tolist", "item", "__int__", "__float__",
            "__index__", "__bool__")

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()
        self.largest = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.HOST:
            self.calls[name] += 1
        out = func(*args, **(kwargs or {}))
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor):
                self.largest = max(self.largest,
                                   o.numel() * o.element_size())
        return out


def test_rowsparse_allocates_o_nnz():
    """A 1M x 128 row-sparse array with 1% of its rows stored allocates
    O(nnz): construction, the accessors and ``retain`` never build a
    tensor near the 512 MB dense value."""
    rows, cols, nnz = 1_000_000, 128, 10_000
    idx = np.arange(0, rows, rows // nnz)[:nnz]
    vals = np.ones((nnz, cols), np.float32)
    payload = nnz * cols * 4
    with tmx.cpu():
        spy = TensorSpy()
        with spy:
            rs = tsp.row_sparse_array((vals, idx), shape=(rows, cols))
            assert rs.shape == (rows, cols)
            assert rs.data.shape == (nnz, cols)
            assert rs.indices.shape == (nnz,)
            rs.wait_to_read()
            kept = rs.retain(tmx.nd.array(idx[:5].astype(np.float32)))
            got = kept.data.asnumpy()
        assert rs._dense_cache is None and kept._dense_cache is None
        assert spy.largest <= payload, spy.largest
    jrs = jsp.row_sparse_array((vals, idx), shape=(rows, cols))
    jkept = jrs.retain(jmx.nd.array(idx[:5].astype(np.float32)))
    np.testing.assert_array_equal(got, jkept.data.asnumpy())
    np.testing.assert_array_equal(kept.indices.asnumpy(),
                                  jkept.indices.asnumpy())


def _lazy_run(mx, sp, make, steps, w0, states0):
    """``steps`` lazy updates of ``make(mx)`` from ``w0``: the weight and
    the state arrays after each step."""
    opt = make(mx)
    w = mx.nd.array(w0)
    state = opt.create_state(0, w)
    flat = [] if state is None else (
        list(state) if isinstance(state, tuple) else [state])
    for s, v in zip(flat, states0):
        s[:] = mx.nd.array(v)
    out = []
    for g in steps:
        opt.update(0, w, sp.row_sparse_array(g), state)
        out.append([w.asnumpy()] + [s.asnumpy() for s in flat])
    return out


@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adam"])
def test_lazy_updates_leave_untouched_rows_bitwise(kind):
    rng = np.random.RandomState(3)
    w0 = rng.randn(8, 4).astype(np.float32)
    make = {"sgd": lambda mx: mx.optimizer.SGD(
                learning_rate=0.1, wd=0.01, lazy_update=True),
            "sgd_momentum": lambda mx: mx.optimizer.SGD(
                learning_rate=0.1, momentum=0.9, wd=0.01, lazy_update=True,
                clip_gradient=0.8),
            "adam": lambda mx: mx.optimizer.Adam(
                learning_rate=0.01, wd=0.01, lazy_update=True)}[kind]
    n_states = {"sgd": 0, "sgd_momentum": 1, "adam": 2}[kind]
    states0 = [np.abs(rng.randn(8, 4)).astype(np.float32)
               for _ in range(n_states)]
    g1 = np.zeros((8, 4), np.float32)
    g1[[0, 2, 5]] = rng.randn(3, 4)
    g2 = np.zeros((8, 4), np.float32)
    g2[[2, 5]] = rng.randn(2, 4)
    j, t = in_both(lambda mx, sp: _lazy_run(mx, sp, make, [g1, g2], w0,
                                            states0))
    before = [w0] + states0
    for step, touched in ((0, [0, 2, 5]), (1, [2, 5])):
        untouched = [r for r in range(8) if r not in touched]
        for k, (tj, tt) in enumerate(zip(j[step], t[step])):
            close(tt, tj)
            for got, run in ((tt, t), (tj, j)):
                prev = before[k] if step == 0 else run[0][k]
                np.testing.assert_array_equal(got[untouched],
                                              prev[untouched])
        assert not np.allclose(t[step][0][touched], (
            w0 if step == 0 else t[0][0])[touched])


def test_lazy_update_off_takes_the_dense_update():
    """``lazy_update=False`` decays the momentum of every row, in both
    packages."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(6, 3).astype(np.float32)
    m0 = rng.randn(6, 3).astype(np.float32)
    g = np.zeros((6, 3), np.float32)
    g[1] = 1.0
    make = lambda mx: mx.optimizer.SGD(  # noqa: E731
        learning_rate=0.1, momentum=0.9, lazy_update=False)
    j, t = in_both(lambda mx, sp: _lazy_run(mx, sp, make, [g], w0, [m0]))
    close(t[0][1], j[0][1])
    np.testing.assert_allclose(t[0][1][0], 0.9 * m0[0], rtol=1e-6)


@pytest.mark.parametrize("out_kind", ["row_sparse", "dense"])
def test_row_sparse_pull_honours_row_ids(out_kind):
    vals = np.arange(24).astype(np.float32).reshape(6, 4)

    def run(mx, sp):
        kv = mx.kv.create("local")
        kv.init("emb", mx.nd.array(vals))
        out = sp.zeros("row_sparse", (6, 4)) if out_kind == "row_sparse" \
            else mx.nd.zeros((6, 4))
        kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array([1, 4, 1]))
        ids = out.indices.asnumpy().tolist() \
            if out_kind == "row_sparse" else None
        return out.asnumpy(), ids
    j, t = in_both(run)
    np.testing.assert_array_equal(t[0], j[0])
    want = np.zeros_like(vals)
    want[[1, 4]] = vals[[1, 4]]
    np.testing.assert_array_equal(t[0], want)
    assert t[1] == j[1]
    if out_kind == "row_sparse":
        assert t[1] == [1, 4]


def test_row_sparse_pull_takes_a_row_ids_array_per_key():
    with tmx.cpu():
        kv = tmx.kv.create("local")
        a = np.arange(12, dtype=np.float32).reshape(4, 3)
        kv.init(["a", "b"], [tmx.nd.array(a), tmx.nd.array(a * 2)])
        outs = [tsp.zeros("row_sparse", (4, 3)) for _ in range(2)]
        kv.row_sparse_pull(["a", "b"], out=outs,
                           row_ids=[tmx.nd.array([3]), tmx.nd.array([0, 2])])
        assert outs[0].indices.asnumpy().tolist() == [3]
        np.testing.assert_array_equal(outs[1].data.asnumpy(), a[[0, 2]] * 2)
        with pytest.raises(tmx.MXNetError, match="one row_ids"):
            kv.row_sparse_pull(["a", "b"], out=outs,
                               row_ids=[tmx.nd.array([3])])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_embedding_sparse_grad_training_matches_the_jax_package(optimizer):
    """``Embedding(sparse_grad=True)`` under ``gluon.Trainer``: only the
    looked-up rows move (weight and states), as in the JAX package, for
    three steps; a row looked up twice moves further."""
    w0 = np.random.RandomState(5).randn(10, 4).astype(np.float32)
    batches = [np.array([1, 3, 3], np.float32),
               np.array([3, 7], np.float32),
               np.array([1, 8, 8, 8], np.float32)]
    params = {"sgd": {"learning_rate": 0.5, "momentum": 0.9},
              "adam": {"learning_rate": 0.05}}[optimizer]

    def run(mx, sp):
        with mx.name.NameManager():
            net = mx.gluon.nn.Embedding(10, 4, sparse_grad=True)
        net.initialize(mx.init.Zero())
        net.weight.set_data(mx.nd.array(w0))
        trainer = mx.gluon.Trainer(net.collect_params(), optimizer,
                                   dict(params))
        out = []
        for x in batches:
            with mx.autograd.record():
                y = net(mx.nd.array(x))
                loss = (y * y).sum()
            loss.backward()
            trainer.step(1)
            out.append(net.weight.data().asnumpy())
        return out
    j, t = in_both(run)
    seen = set()
    for x, wj, wt in zip(batches, j, t):
        seen |= set(x.astype(int).tolist())
        close(wt, wj)
        untouched = [r for r in range(10) if r not in seen]
        np.testing.assert_array_equal(wt[untouched], w0[untouched])
    assert abs(t[0][3] - w0[3]).sum() > abs(t[0][1] - w0[1]).sum()


def test_a_looked_up_row_with_a_zero_gradient_drops_out_in_both():
    """The Trainer takes the gradient's nonzero rows: a row looked up
    whose gradient sums to exactly zero keeps its momentum, in both
    packages (``momentum * m`` would decay it under a dense update)."""
    w0 = np.ones((4, 2), np.float32)

    def run(mx, sp):
        with mx.name.NameManager():
            net = mx.gluon.nn.Embedding(4, 2, sparse_grad=True)
        net.initialize(mx.init.One())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.5})
        out = []
        for x, sign in ((np.array([0, 2], np.float32), [1.0, 1.0]),
                        (np.array([0, 2], np.float32), [1.0, 0.0])):
            with mx.autograd.record():
                y = net(mx.nd.array(x))
                loss = (y * mx.nd.array(np.array(sign, np.float32)
                                        .reshape(2, 1))).sum()
            loss.backward()
            trainer.step(1)
            out.append(net.weight.data().asnumpy())
        return out
    j, t = in_both(run)
    for wt, wj in zip(t, j):
        np.testing.assert_array_equal(wt, wj)
    # row 2's second gradient is zero: it drops out, so its weight holds
    np.testing.assert_array_equal(t[1][2], t[0][2])
    assert not np.array_equal(t[1][0], t[0][0])
    np.testing.assert_array_equal(t[1][[1, 3]], w0[[1, 3]])


def test_retain():
    dense = np.zeros((5, 2), np.float32)
    dense[[0, 2, 4]] = [[1, 1], [2, 2], [3, 3]]

    def run(mx, sp):
        kept = sp.row_sparse_array(dense).retain(mx.nd.array([0, 4]))
        via_nd = mx.nd.sparse_retain(sp.row_sparse_array(dense),
                                     mx.nd.array([2]))
        return (kept.asnumpy(), kept.indices.asnumpy(), via_nd.stype,
                via_nd.asnumpy())
    j, t = in_both(run)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1].tolist() == j[1].tolist() == [0, 4]
    assert t[2] == j[2] == "row_sparse"
    np.testing.assert_array_equal(t[3], j[3])


def test_a_row_sparse_step_moves_no_payload_to_the_host():
    """A lazy SGD step from a compact gradient, the recompaction after
    the weight's dense rebind and a retain read nothing back to the host
    but the count of stored rows."""
    R, C = 64, 8
    w0 = np.random.RandomState(0).rand(R, C).astype(np.float32)
    with tmx.cpu():
        weight = tsp.row_sparse_array(w0)
        grad = tsp.RowSparseNDArray(
            torch.ones(3, C), indices=torch.tensor([2, 7, 11]),
            shape=(R, C))
        opt = tmx.optimizer.SGD(learning_rate=0.1, lazy_update=True)
        opt.update(0, weight, grad, opt.create_state(0, weight))
        retain_idx = tmx.nd.array(np.array([2, 11], np.int64))
        spy = TensorSpy()
        with spy:
            opt.update(0, weight, grad, None)
            weight.data
            weight.indices
            kept = tsp.retain(weight, retain_idx)
            kept.wait_to_read()
        moved = {k: v for k, v in spy.calls.items()
                 if k in ("cpu", "numpy", "tolist")}
        assert moved == {}, moved
        assert sum(spy.calls.values()) <= 2, dict(spy.calls)
        np.testing.assert_allclose(kept.data.asnumpy(), w0[[2, 11]] - 0.2,
                                   rtol=1e-6)


def test_storage_ops_match_the_jax_package():
    """``nd.cast_storage`` to each type, ``nd.square_sum``,
    ``nd._sparse_adagrad_update`` and ``nd.contrib.SparseEmbedding``."""
    rng = np.random.RandomState(6)
    x = rng.randn(5, 4).astype(np.float32)
    x[[1, 3]] = 0.0
    x[0, 2] = 0.0
    w, g, h = (rng.rand(5, 4).astype(np.float32) for _ in range(3))
    ids = np.array([[0, 4], [4, 2]], np.float32)

    def run(mx, sp):
        out = {}
        for stype in ("default", "row_sparse", "csr"):
            c = mx.nd.cast_storage(mx.nd.array(x), stype=stype)
            out[stype] = [c.stype, c.asnumpy()] + (
                [c.indices.asnumpy().tolist()] if stype != "default"
                else [])
            if stype == "csr":
                out[stype] += [c.indptr.asnumpy().tolist(),
                               c.data.asnumpy()]
            back = c.tostype("default")
            out[stype].append((back.stype, back.asnumpy()))
        out["square_sum"] = [
            mx.nd.square_sum(mx.nd.array(x), axis=1).asnumpy(),
            mx.nd.square_sum(mx.nd.array(x)).asnumpy(),
            mx.nd._square_sum(mx.nd.array(x), axis=0,
                              keepdims=True).asnumpy()]
        hist = mx.nd.array(h)
        new_w = mx.nd._sparse_adagrad_update(
            mx.nd.array(w), mx.nd.array(g), hist, lr=0.1, wd=0.01,
            rescale_grad=0.5, clip_gradient=0.3)
        out["adagrad"] = [new_w.asnumpy(), hist.asnumpy()]
        out["embedding"] = mx.nd.contrib.SparseEmbedding(
            mx.nd.array(ids), mx.nd.array(w), input_dim=5,
            output_dim=4).asnumpy()
        return out
    j, t = in_both(run)
    for key in ("default", "row_sparse", "csr"):
        for a, b in zip(t[key], j[key]):
            if isinstance(a, tuple):
                assert a[0] == b[0]
                np.testing.assert_array_equal(a[1], b[1])
            elif isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    for a, b in zip(t["square_sum"], j["square_sum"]):
        close(a, b)
    for a, b in zip(t["adagrad"], j["adagrad"]):
        close(a, b)
    np.testing.assert_array_equal(t["embedding"], j["embedding"])


def test_nd_save_of_a_sparse_array_is_the_jax_packages_bytes(tmp_path):
    dense = np.zeros((6, 3), np.float32)
    dense[[1, 4]] = np.arange(6, dtype=np.float32).reshape(2, 3)
    csr_dense = np.random.RandomState(7).rand(3, 5).astype(np.float32)
    csr_dense[csr_dense < 0.5] = 0.0
    blobs = []
    for mx, sp in both():
        with tmx.cpu():
            path = str(tmp_path / ("%s.params" % mx.__name__))
            mx.nd.save(path, {"rs": sp.row_sparse_array(dense),
                              "csr": sp.csr_matrix(csr_dense)})
            with open(path, "rb") as f:
                blobs.append(f.read())
            back = mx.nd.load(path)
            np.testing.assert_array_equal(back["rs"].asnumpy(), dense)
            assert back["csr"].stype == "default"
    assert blobs[0] == blobs[1]


def test_sparse_arrays_keep_their_device_and_metadata():
    with tmx.cpu():
        rs = tsp.zeros("row_sparse", (4, 3))
        csr = tsp.zeros("csr", (2, 5), dtype="float32")
        assert (rs.shape, rs.dtype, rs.stype, rs.size, rs.ndim) == (
            (4, 3), "float32", "row_sparse", 12, 2)
        assert rs.context == tmx.cpu() and csr.context == tmx.cpu()
        assert rs.indices.shape == (0,) and csr.indptr.shape == (3,)
        np.testing.assert_array_equal(csr.asnumpy(), np.zeros((2, 5)))
        assert repr(rs) == "<RowSparseNDArray 4x3 @cpu(0)>"
        # a write through the dense value recompacts the payload
        rs[:] = np.eye(4, 3, dtype=np.float32)
        assert rs.indices.asnumpy().tolist() == [0, 1, 2]
        assert tsp.array(rs).indices.asnumpy().tolist() == [0, 1, 2]


def test_the_sparse_module_imports_neither_jax_nor_the_jax_package():
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import mxnet_tpu_torch.ndarray.sparse\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')))" % repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
