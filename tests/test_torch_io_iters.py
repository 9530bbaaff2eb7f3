"""The port's data iterators against the JAX package's, on the CPU:
``ResizeIter``, ``PrefetchingIter`` (two sources, renames), ``MNISTIter``
(idx files written here, gz or not), ``CSVIter``, ``ImageRecordIter``
(shuffle, crops, mirror, ``seed_aug``, ``num_parts``, the last batch's
pad, mean/std/scale, a corrupt record), ``ImageDetRecordIter``'s labels
and the ``MXDataIter`` shell.  Inputs are numpy arrays and JPEGs made
from a seed; batches are compared bitwise.

The JAX package decodes records with its C++ libjpeg library when that
builds, which seeds crops another way by design; the port decodes with
PIL only, so the JAX side runs here with its native entry points
replaced by their "library unavailable" answer (``monkeypatch``, no file
of the package changes), which takes its Python path.
"""
import gzip
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.native as jnative
import mxnet_tpu_torch as tmx

SEED = 0


@pytest.fixture
def jax_python_decode(monkeypatch):
    monkeypatch.setattr(jnative, "scan_record_spans", lambda path: None)
    monkeypatch.setattr(jnative, "decode_jpeg_batch",
                        lambda *a, **k: None)


def _batches(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lab.asnumpy() for lab in (b.label or [])], b.pad))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y)


def _arrays(n=10, seed=SEED):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.randint(0, 4, (n,)).astype(np.float32))


# -- ResizeIter and PrefetchingIter ------------------------------------------
@pytest.mark.parametrize("size,reset_internal", [(2, True), (7, True),
                                                 (4, False)])
def test_resize_iter_matches(size, reset_internal):
    x, y = _arrays()
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            src = mx.io.NDArrayIter(x, y, batch_size=3)
            it = mx.io.ResizeIter(src, size, reset_internal=reset_internal)
            assert it.provide_data == src.provide_data
            got.append(_batches(it, epochs=2))
    _same(*got)
    assert len(got[1]) == 2 * size


def test_prefetching_iter_joins_two_sources_with_renames():
    x, y = _arrays()
    x2 = x * 2
    got, descs = [], []
    for mx in (jmx, tmx):
        with mx.cpu():
            a = mx.io.NDArrayIter(x, y, batch_size=4)
            b = mx.io.NDArrayIter(x2, y + 1, batch_size=4)
            it = mx.io.PrefetchingIter(
                [a, b], rename_data=[{"data": "a"}, {"data": "b"}],
                rename_label=[{"softmax_label": "la"},
                              {"softmax_label": "lb"}])
            descs.append([(d.name, d.shape) for d in
                          it.provide_data + it.provide_label])
            got.append(_batches(it, epochs=2))
            assert it.batch_size == 4
    assert descs[0] == descs[1] == [("a", (4, 3)), ("b", (4, 3)),
                                    ("la", (4,)), ("lb", (4,))]
    _same(*got)
    assert [g[2] for g in got[1]] == [0, 0, 2] * 2


def test_prefetching_iter_rethrows_a_source_error():
    class Broken(tmx.io.NDArrayIter):
        def next(self):
            raise ValueError("broken source")

    x, y = _arrays()
    with tmx.cpu():
        it = tmx.io.PrefetchingIter(Broken(x, y, batch_size=2))
        with pytest.raises(ValueError, match="broken source"):
            it.next()
    tmx.nd.waitall()        # delivered once, not again


# -- MNISTIter and CSVIter ------------------------------------------------------
def _write_mnist(d, n, gz):
    rng = np.random.RandomState(SEED)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, (n,)).astype(np.uint8)
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img_path = os.path.join(d, "img" + suffix)
    lab_path = os.path.join(d, "lab" + suffix)
    with op(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(lab_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img_path, lab_path


@pytest.mark.parametrize("gz,flat,parts", [(False, False, 1), (True, True, 1),
                                           (False, False, 2)])
def test_mnist_iter_matches(tmp_path, gz, flat, parts):
    img, lab = _write_mnist(str(tmp_path), 12, gz)
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            it = mx.io.MNISTIter(image=img, label=lab, batch_size=4,
                                 shuffle=False, flat=flat, num_parts=parts,
                                 part_index=parts - 1)
            got.append(_batches(it, epochs=2))
            assert it.provide_data[0].shape == ((4, 784) if flat
                                                else (4, 1, 28, 28))
    _same(*got)


def test_mnist_iter_rejects_a_bad_magic(tmp_path):
    img, lab = _write_mnist(str(tmp_path), 4, False)
    with pytest.raises(tmx.MXNetError, match="magic"):
        tmx.io.MNISTIter(image=img, label=img, batch_size=2)


@pytest.mark.parametrize("labels,round_batch", [(True, True), (True, False),
                                                (False, True)])
def test_csv_iter_matches(tmp_path, labels, round_batch):
    rng = np.random.RandomState(SEED)
    data = rng.uniform(-1, 1, (7, 6)).astype(np.float32)
    dpath = str(tmp_path / "d.csv")
    np.savetxt(dpath, data, delimiter=",", fmt="%.6f")
    kw = {}
    if labels:
        lpath = str(tmp_path / "l.csv")
        np.savetxt(lpath, rng.randint(0, 3, (7, 1)), delimiter=",",
                   fmt="%d")
        kw = dict(label_csv=lpath)
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            it = mx.io.CSVIter(data_csv=dpath, data_shape=(2, 3),
                               batch_size=3, round_batch=round_batch, **kw)
            got.append(_batches(it, epochs=2))
    _same(*got)
    assert len(got[1]) == (6 if round_batch else 4)


# -- the record iterators -------------------------------------------------------
def _write_rec(d, n=22, seed=SEED, labels=None, name="r"):
    """``n`` small JPEGs of varied sizes (some narrower than the crop) in
    a ``.rec``/``.idx`` pair; labels from ``labels(i)`` or scalars."""
    rng = np.random.RandomState(seed)
    prefix = os.path.join(d, name)
    w = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                       "w")
    for i in range(n):
        h, wd = rng.randint(14, 30), rng.randint(14, 30)
        y, x = np.mgrid[0:h, 0:wd]
        img = np.stack([(x * 9 + i * 7) % 256, (y * 5 + i * 3) % 256,
                        ((x + y) * 4) % 256], -1) \
            + rng.randint(0, 20, (h, wd, 3))
        lab = labels(i) if labels else float(i % 5)
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, lab, i, 0),
            np.clip(img, 0, 255).astype(np.uint8), quality=90))
    w.close()
    return prefix + ".rec"


RECORD_CONFIGS = {
    "shuffle_crop_mirror": dict(shuffle=True, rand_crop=True,
                                rand_mirror=True, seed_aug=11,
                                mean_r=120.0, mean_g=110.0, mean_b=100.0,
                                std_r=50.0, std_g=60.0, std_b=70.0,
                                scale=0.5, shuffle_chunk_size=4),
    "parts": dict(num_parts=2, part_index=1, seed_aug=3,
                  rand_mirror=True),
    "resize": dict(resize=20, rand_crop=True, seed_aug=5, shuffle=True,
                   preprocess_threads=1),
}


@pytest.mark.parametrize("cfg", sorted(RECORD_CONFIGS))
def test_image_record_iter_is_bitwise_the_jax_python_path(
        tmp_path, jax_python_decode, cfg):
    rec = _write_rec(str(tmp_path))
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            it = mx.io.ImageRecordIter(rec, data_shape=(3, 16, 16),
                                       batch_size=4, **RECORD_CONFIGS[cfg])
            got.append(_batches(it, epochs=2))
            it.close()
    _same(*got)
    n = 11 if cfg == "parts" else 22
    assert sum(4 - p for _d, _l, p in got[1]) == 2 * n
    assert got[1][-1][2] == (4 - n % 4) % 4      # the epoch's last pad


def test_a_corrupt_record_raises_at_next(tmp_path, jax_python_decode):
    rec = _write_rec(str(tmp_path), n=9)
    bad = str(tmp_path / "bad.rec")
    r = tmx.recordio.MXRecordIO(rec, "r")
    w = tmx.recordio.MXRecordIO(bad, "w")
    for i in range(9):
        s = r.read()
        if i == 5:
            s = tmx.recordio.pack(tmx.recordio.IRHeader(0, 1.0, i, 0),
                                  b"not an image")
        w.write(s)
    w.close()
    r.close()
    errors = []
    for mx in (jmx, tmx):
        with mx.cpu():
            it = mx.io.ImageRecordIter(bad, data_shape=(3, 12, 12),
                                       batch_size=4)
            first = it.next()        # records 0-3 decode
            assert first.data[0].shape == (4, 3, 12, 12)
            with pytest.raises(Exception) as exc:
                it.next()
            errors.append(type(exc.value).__name__)
            it.close()
    assert errors[0] == errors[1] == "UnidentifiedImageError"
    tmx.nd.waitall()        # delivered at next(), not again


def test_the_producer_builds_on_the_callers_context(tmp_path,
                                                     jax_python_decode):
    """The JAX package's producer thread calls ``array(data)`` with no
    context; on this host its batches are cpu(0), as the caller's ``with
    mx.cpu():`` asks.  The port's producer builds on the context current
    where the iterator was made: the batches stay on the host after the
    block is left, and the consumer's blocks do not move them."""
    rec = _write_rec(str(tmp_path), n=8)
    with jmx.cpu():
        jit = jmx.io.ImageRecordIter(rec, data_shape=(3, 12, 12),
                                     batch_size=4)
        jb = jit.next()
    with tmx.cpu():
        tit = tmx.io.ImageRecordIter(rec, data_shape=(3, 12, 12),
                                     batch_size=4)
        tb = tit.next()
    tb2 = tit.next()        # outside the block
    assert jb.data[0].context == jmx.cpu(0)
    assert tb.data[0].context == tb2.data[0].context == tmx.cpu(0)
    assert tb2.label[0].context == tmx.cpu(0)
    jit.close()
    tit.close()


def test_two_iterators_keep_their_own_augmentation(tmp_path,
                                                   jax_python_decode):
    """A training and an evaluation reader side by side: each decodes
    with its own crop and mirror settings.  The JAX package reads one
    module-wide setting, which the reader made last overwrites, so its
    training reader then crops at the centre (a defect the port does not
    copy)."""
    rec = _write_rec(str(tmp_path), n=8)
    args = dict(data_shape=(3, 12, 12), batch_size=4, seed_aug=1)
    batches = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        with mx.cpu():
            train = mx.io.ImageRecordIter(rec, rand_crop=True,
                                          rand_mirror=True, **args)
            evaluation = mx.io.ImageRecordIter(rec, **args)
            train.reset()       # decode after both exist
            batches[name] = (_batches(train), _batches(evaluation))
            train.close()
            evaluation.close()
    with tmx.cpu():
        alone = tmx.io.ImageRecordIter(rec, rand_crop=True,
                                       rand_mirror=True, **args)
        alone.reset()           # the same epoch as the others
        alone_batches = _batches(alone)
        alone.close()
    _same(batches["port"][0], alone_batches)
    _same(batches["port"][1], batches["jax"][1])
    assert not all(np.array_equal(a[0][0], b[0][0]) for a, b in
                   zip(batches["jax"][0], alone_batches))


def test_image_det_record_iter_labels(tmp_path, jax_python_decode):
    def det_label(i):
        """Odd records: a header [2, 5] and 1-3 objects (more than the
        label shape holds); even ones: one bare object row."""
        objs = [[i % 3, 0.1, 0.2, 0.5 + 0.01 * i, 0.6]] * (1 + i % 3)
        if i % 2:
            return np.asarray([2, 5] + sum(objs, []), np.float32)
        return np.asarray(objs[0], np.float32)

    rec = _write_rec(str(tmp_path), n=10, labels=det_label)
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            it = mx.io.ImageDetRecordIter(rec, data_shape=(3, 12, 12),
                                          batch_size=4, label_shape=(2, 5))
            assert [(d.name, d.shape) for d in it.provide_label] == \
                [("label", (4, 2, 5))]
            got.append(_batches(it))
            it.close()
    _same(*got)
    labels = got[1][0][1][0]
    assert labels.shape == (4, 2, 5) and (labels[0, 1] == -1).all()


def test_mxdataiter_shell_matches():
    x, y = _arrays()
    for mx in (jmx, tmx):
        with pytest.raises(Exception, match="MXDataIter wraps"):
            mx.io.MXDataIter()
    got = []
    for mx in (jmx, tmx):
        with mx.cpu():
            it = mx.io.MXDataIter(mx.io.NDArrayIter(x, y, batch_size=5))
            assert it.batch_size == 5
            assert it.provide_data[0].shape == (5, 3)
            got.append(_batches(it, epochs=2))
    _same(*got)
