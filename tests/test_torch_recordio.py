"""The port's ``recordio`` against the JAX package's, on the CPU: the
``.rec`` and ``.idx`` files each writes are the same bytes, each package
reads the other's files, the header packing is the same, and
``pack_img``/``unpack_img`` (PIL) give the same bytes and pixels.  Inputs
are numpy arrays from a seed; every comparison is exact.
"""
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu.recordio as jrio
import mxnet_tpu_torch.recordio as trio
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu_torch.base import MXNetError

SEED = 0


def _payloads(seed=SEED):
    """Records of every header form: a scalar label, a vector label (flag
    = its length), lengths 0-9 (each padding to 4 bytes), and ids."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(10):
        body = rng.bytes(i)
        label = float(rng.randint(0, 5)) if i % 2 else \
            rng.uniform(-1, 1, i % 4 + 1).astype(np.float32)
        out.append((i, label, 7 * i, body))
    return out


def _write(rio, d, tag, payloads, indexed):
    rec, idx = str(d / (tag + ".rec")), str(d / (tag + ".idx"))
    w = rio.MXIndexedRecordIO(idx, rec, "w") if indexed \
        else rio.MXRecordIO(rec, "w")
    for i, label, id2, body in payloads:
        s = rio.pack(rio.IRHeader(0, label, i, id2), body)
        if indexed:
            w.write_idx(i, s)
        else:
            w.write(s)
    w.close()
    return rec, idx


@pytest.mark.parametrize("indexed", [False, True])
def test_writers_give_the_same_bytes(tmp_path, indexed):
    p = _payloads()
    jrec, jidx = _write(jrio, tmp_path, "jax", p, indexed)
    trec, tidx = _write(trio, tmp_path, "port", p, indexed)
    assert open(trec, "rb").read() == open(jrec, "rb").read()
    if indexed:
        assert open(tidx).read() == open(jidx).read()


def _read_all(rio, rec):
    r = rio.MXRecordIO(rec, "r")
    out = []
    while True:
        s = r.read()
        if s is None:
            break
        out.append(s)
    r.close()
    return out


@pytest.mark.parametrize("writer,reader", [(jrio, trio), (trio, jrio)],
                         ids=["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    p = _payloads()
    rec, idx = _write(writer, tmp_path, "w", p, indexed=True)
    assert _read_all(reader, rec) == _read_all(writer, rec)
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == list(range(len(p)))
    for i in (7, 0, 9, 3):
        header, body = reader.unpack(r.read_idx(i))
        assert header.id == i and header.id2 == 7 * i and body == p[i][3]
        assert np.array_equal(np.asarray(header.label, np.float32),
                              np.asarray(p[i][1], np.float32))
    r.close()


def test_pack_and_unpack_match():
    for _i, label, id2, body in _payloads():
        h = (0, label, 3, id2)
        s = trio.pack(trio.IRHeader(*h), body)
        assert s == jrio.pack(jrio.IRHeader(*h), body)
        th, tb = trio.unpack(s)
        jh, jb = jrio.unpack(s)
        assert tb == jb == body
        assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
        assert np.array_equal(np.asarray(th.label), np.asarray(jh.label))


@pytest.mark.parametrize("fmt,quality", [(".jpg", 95), (".jpg", 80),
                                         (".png", 95)])
def test_pack_img_and_unpack_img_match(fmt, quality):
    rng = np.random.RandomState(SEED)
    img = rng.randint(0, 256, (20, 28, 3)).astype(np.uint8)
    h = (0, 2.0, 5, 0)
    s = trio.pack_img(trio.IRHeader(*h), img, quality=quality, img_fmt=fmt)
    assert s == jrio.pack_img(jrio.IRHeader(*h), img, quality=quality,
                              img_fmt=fmt)
    th, timg = trio.unpack_img(s)
    jh, jimg = jrio.unpack_img(s)
    assert th.label == jh.label == 2.0
    assert timg.dtype == jimg.dtype == np.uint8
    assert np.array_equal(timg, jimg)
    if fmt == ".png":
        assert np.array_equal(timg, img)


def _multi_chunk_file(path, chunks):
    """A record written as ``len(chunks)`` frames (cflag 1, 2..., 3), as
    dmlc's writer splits a record that holds the magic number, then a
    whole record."""
    with open(path, "wb") as f:
        n = len(chunks)
        for k, c in enumerate(chunks):
            cflag = 1 if k == 0 else (3 if k == n - 1 else 2)
            f.write(struct.pack("<II", 0xced7230a, (cflag << 29) | len(c)))
            f.write(c + b"\x00" * ((4 - len(c) % 4) % 4))
        f.write(struct.pack("<II", 0xced7230a, 3) + b"abc\x00")


def test_multi_chunk_records_read_alike(tmp_path):
    path = str(tmp_path / "m.rec")
    _multi_chunk_file(path, [b"first", b"2nd", b"the-last"])
    assert _read_all(trio, path) == _read_all(jrio, path) \
        == [b"first2ndthe-last", b"abc"]


def test_bad_magic_raises_in_both(tmp_path):
    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 0x12345678, 4) + b"abcd")
    with pytest.raises(MXNetError):
        trio.MXRecordIO(path, "r").read()
    with pytest.raises(JMXNetError):
        jrio.MXRecordIO(path, "r").read()
    with pytest.raises(ValueError):
        trio.MXRecordIO(path, "x")


def test_pickled_reader_reopens_where_it_was(tmp_path):
    rec, _ = _write(trio, tmp_path, "p", _payloads(), indexed=False)
    r = trio.MXRecordIO(rec, "r")
    first = r.read()
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.read() == first      # reopened at the start
    assert r.read() == _read_all(trio, rec)[1]
    r.close()
    r2.close()
    closed = pickle.loads(pickle.dumps(r))
    assert closed.fid is None
