"""``io.LibSVMIter`` and the kvstore's sparse paths against the JAX
package on the CPU, the two defects of the JAX package that the port does
not copy (ROADMAP queue 3 items 19 and 20), ``row_sparse_pull`` on
``dist_sync`` and ``dist_async`` in a world of two processes, and a CPU
rehearsal of ``chip_smoke.py``'s phase 25 at small widths."""
import os
import sys
import time
import tracemalloc

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu_torch.ops import cuda_kernels as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

WIDE = 1_000_001


def write_lines(path, n, width, seed, per_row=6):
    """A libsvm file of ``n`` rows: unsorted indices, a repeated index, a
    stored zero and a blank line among them."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for r in range(n):
            idx = rng.randint(0, width, per_row)
            val = np.round(rng.randn(per_row), 3)
            if r % 5 == 1:
                idx[1] = idx[0]            # a repeated index: the last wins
            if r % 7 == 2:
                val[2] = 0.0               # a stored zero drops out
            f.write("%d %s\n" % (r % 2, " ".join(
                "%d:%g" % (i, v) for i, v in zip(idx, val))))
            if r == 3:
                f.write("\n")
    return path


def batches(mx, path, width, batch_size):
    out = []
    with tmx.cpu():
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(width,),
                              batch_size=batch_size)
        for b in it:
            d = b.data[0]
            out.append((d.stype, d.shape, d.indptr.asnumpy(),
                        d.indices.asnumpy(), d.data.asnumpy(),
                        b.label[0].asnumpy(), b.pad))
        desc = (it.provide_data, it.provide_label)
        it.reset()
        again = it.next().data[0].indices.asnumpy()
    return out, desc, again


def test_libsvm_batches_match_the_jax_package(tmp_path):
    path = write_lines(str(tmp_path / "d.libsvm"), 23, 64, 0)
    (jb, jdesc, jagain), (tb, tdesc, tagain) = (
        batches(mx, path, 64, 5) for mx in (jmx, tmx))
    assert len(tb) == len(jb) == 5
    assert tb[-1][-1] == jb[-1][-1] == 2            # the padded last batch
    for t, j in zip(tb, jb):
        assert t[:2] == j[:2] == ("csr", (5, 64))
        for a, b in zip(t[2:6], j[2:6]):
            np.testing.assert_array_equal(a, b)
        assert t[6] == j[6]
        # the index dtype: the port's int64, the JAX package's int32
        assert (t[3].dtype, j[3].dtype) == (np.int64, np.int32)
    assert [tuple(d) for d in tdesc[0]] == [tuple(d) for d in jdesc[0]]
    assert [tuple(d) for d in tdesc[1]] == [tuple(d) for d in jdesc[1]]
    np.testing.assert_array_equal(tagain, jagain)


def test_libsvm_labels_from_a_label_file_match_the_jax_package(tmp_path):
    path = write_lines(str(tmp_path / "d.libsvm"), 7, 16, 1)
    lpath = str(tmp_path / "l.libsvm")
    with open(lpath, "w") as f:
        for r in range(7):
            f.write("%d 0:%g\n" % (r % 3, 0.5 * r))
    got = []
    for mx in (jmx, tmx):
        with tmx.cpu():
            it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(16,),
                                  label_libsvm=lpath, batch_size=3)
            got.append([b.label[0].asnumpy() for b in it])
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1][0], [0.0, 0.5, 1.0])


def test_libsvm_refuses_an_index_past_the_width(tmp_path):
    path = str(tmp_path / "d.libsvm")
    with open(path, "w") as f:
        f.write("1 3:1 64:1\n")
    with tmx.cpu(), pytest.raises(tmx.MXNetError, match="outside"):
        tmx.io.LibSVMIter(data_libsvm=path, data_shape=(64,))


def _peak(fn):
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_a_wide_file_parses_in_little_memory(tmp_path):
    """1,000 lines at Avazu's 1,000,001 features parse and batch under 64
    MB of host allocations; a dense row a line would take 4 GB."""
    path = write_lines(str(tmp_path / "wide.libsvm"), 1000, WIDE, 2, 15)

    def run():
        with tmx.cpu():
            it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(WIDE,),
                                   batch_size=256)
            n = sum(b.data[0].data.shape[0] for b in it)
        assert n > 14000
    assert _peak(run) < 64 << 20


def test_queue3_item20_the_jax_package_builds_a_dense_row_a_line(tmp_path):
    """Queue 3 item 20, not copied: ``mxnet_tpu/io.py:629-641`` keeps a
    dense float32 row of the full width for every line, and ``:660-668``
    a dense block a batch: 16 lines at 1,000,001 features cost the JAX
    package 16 x 4 MB and more, the port a few hundred KB, for the same
    batches."""
    path = write_lines(str(tmp_path / "w16.libsvm"), 16, WIDE, 3, 15)
    peaks, firsts = [], []
    for mx in (jmx, tmx):
        def run():
            with tmx.cpu():
                it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(WIDE,),
                                      batch_size=4)
                d = it.next().data[0]
                firsts.append((d.indptr.asnumpy(), d.indices.asnumpy(),
                               d.data.asnumpy()))
        peaks.append(_peak(run))
    assert peaks[0] > 16 * WIDE * 4
    assert peaks[1] < 2 << 20
    for a, b in zip(*firsts):
        np.testing.assert_array_equal(a, b)


def test_queue3_item19_row_sparse_pushes_merge_row_sparse(tmp_path):
    """Queue 3 item 19, not copied: two row-sparse pushes of one key on a
    ``local`` store.  The JAX package's ``KVStore._reduce``
    (``mxnet_tpu/kvstore.py:154-161``) merges them into a dense array, so
    its lazy SGD takes the dense update and the rows neither push names
    decay; the port merges them into a row-sparse sum over the union of
    their rows (the reference's CommCPU ReduceRowSparse), and those rows
    keep their weight and momentum bitwise."""
    w0 = np.random.RandomState(8).randn(6, 3).astype(np.float32)
    first = np.ones((6, 3), np.float32)       # seeds momentum everywhere
    a = np.zeros((6, 3), np.float32)
    a[1] = 0.5
    b = np.zeros((6, 3), np.float32)
    b[[1, 3]] = [[0.25, 0.25, 0.25], [1.0, 2.0, 3.0]]
    got = {}
    for mx, sp in ((jmx, jsp), (tmx, tsp)):
        with tmx.cpu():
            kv = mx.kv.create("local")
            kv.init(0, mx.nd.array(w0))
            kv.set_optimizer(mx.optimizer.SGD(
                learning_rate=0.1, momentum=0.9, lazy_update=True))
            kv.push(0, sp.row_sparse_array(first))
            out = mx.nd.zeros((6, 3))
            kv.pull(0, out=out)
            before = out.asnumpy()
            merged = kv._reduce(0, [sp.row_sparse_array(a),
                                    sp.row_sparse_array(b)])
            kv.push(0, [sp.row_sparse_array(a), sp.row_sparse_array(b)])
            kv.pull(0, out=out)
            got[mx.__name__] = (merged.stype, before, out.asnumpy(),
                                merged.asnumpy())
    jstype, jbefore, jafter, jmerged = got["mxnet_tpu"]
    tstype, tbefore, tafter, tmerged = got["mxnet_tpu_torch"]
    assert (jstype, tstype) == ("default", "row_sparse")
    np.testing.assert_array_equal(tmerged, a + b)
    np.testing.assert_array_equal(jmerged, a + b)
    np.testing.assert_array_equal(tbefore, jbefore)
    untouched = [0, 2, 4, 5]
    np.testing.assert_array_equal(tafter[untouched], tbefore[untouched])
    assert not np.array_equal(jafter[untouched], jbefore[untouched])
    # the rows the pushes name take the same update in both
    np.testing.assert_allclose(tafter[[1, 3]], jafter[[1, 3]], rtol=1e-6)


def test_row_sparse_pull_on_the_fused_store_applies_the_pending_push():
    """``kvstore="tpu"`` buffers a push until the next pull; the port's
    ``row_sparse_pull`` flushes it first, as its ``pull`` does, where the
    JAX package's hands out the rows from before the push."""
    w0 = chip_smoke.SPARSE_PULL_W0
    got = []
    for mx, sp in ((jmx, jsp), (tmx, tsp)):
        with tmx.cpu():
            kv = mx.kv.create("tpu")
            kv.init(0, mx.nd.array(w0))
            kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
            kv.push(0, mx.nd.ones((6, 4)))
            out = sp.zeros("row_sparse", (6, 4))
            kv.row_sparse_pull(0, out=out, row_ids=mx.nd.array([2, 5]))
            got.append(out.data.asnumpy())
    np.testing.assert_array_equal(got[0], w0[[2, 5]])
    np.testing.assert_array_equal(got[1], w0[[2, 5]] - 0.5)


def test_row_sparse_pull_on_dist_sync_in_a_world_of_two(tmp_path):
    t0 = time.monotonic()
    outs = chip_smoke.run_ranks("chip_smoke:sparse_pull_rank", 2,
                                workdir=str(tmp_path), timeout=120,
                                threads=1)
    want = chip_smoke.SPARSE_PULL_W0 - 0.5 * 3.0   # rank 0's init, both
    for rank, (ids, rows, dense) in enumerate(outs):   # pushes summed
        sel = sorted({rank, 4})
        assert ids.tolist() == sel
        np.testing.assert_array_equal(rows, want[sel])
        exp = np.zeros_like(want)
        exp[sel] = want[sel]
        np.testing.assert_array_equal(dense, exp)
    assert time.monotonic() - t0 < 120


def test_row_sparse_pull_on_dist_async_in_a_world_of_two(tmp_path):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    outs = chip_smoke.run_ranks("chip_smoke:sparse_async_rank", 2,
                                args=(spool,), workdir=str(tmp_path),
                                timeout=120, threads=1)
    want = chip_smoke.SPARSE_PULL_W0 - 0.5 * 2.0     # worker 1's push
    for rank, (ids, rows) in enumerate(outs):
        sel = sorted({rank, 4})
        assert ids.tolist() == sel
        np.testing.assert_array_equal(rows, want[sel])


def test_chip_smoke_sparse_phase_rehearses_on_the_cpu(tmp_path):
    """Phase 25 at small widths on the CPU, its twin the CPU too: every
    check of the card run, under 30 s."""
    cfg = dict(chip_smoke.SPARSE, features=15_001, head=50, batch=512,
               batches=8, users=1000, items=900, rated_users=980,
               rated_items=150, mf_ratings=100_000, mf_val=8192,
               mf_batch=1024)
    t0 = time.monotonic()
    with tmx.cpu():
        line = chip_smoke.sparse_phase(tmx, ck, "cpu", cfg=cfg,
                                       ctx=tmx.cpu(), twin_ctx=tmx.cpu(),
                                       workdir_parent=str(tmp_path))
    a, b = line["linear_classification"], line["matrix_factorization"]
    assert a["batches_exact"] == 8 and a["untouched_bitwise"]
    assert a["accuracy_by_epoch"][-1] > chip_smoke.SPARSE_ACC
    assert a["twin_ids_equal"] and a["launches"] == {}
    assert b["steps"] == 97 and b["launches"] == {}
    assert all(v["weight_bitwise"] and v["states_zero"]
               for v in b["held"].values())
    rmse = [r for _, r in b["rmse"]]
    assert rmse == sorted(rmse, reverse=True) and len(rmse) == 4
    assert time.monotonic() - t0 < 30
