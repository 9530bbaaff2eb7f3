"""The port's ``gluon.data`` against the JAX package's, on the CPU: the
samplers and the DataLoader give bitwise the same batches under
``np.random.seed`` in every ``last_batch`` mode, with 0 and 2 worker
threads; the datasets read files the tests write (MNIST idx, CIFAR
pickles, a ``.rec``, an image folder) to the same samples; every vision
transform, with numpy's generator seeded alike, gives the same array;
and the four image ops agree within 1e-6 of the largest value.
"""
import gzip
import os
import pickle
import struct
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_gluon_layers import TOL, rel

CPU = tmx.cpu()


def _host(b):
    if isinstance(b, (list, tuple)):
        return [_host(x) for x in b]
    return b.asnumpy() if hasattr(b, "asnumpy") else np.asarray(b)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list):
            _same(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _epochs(mx, make, n=2, seed=7):
    np.random.seed(seed)
    loader = make(mx)
    out = []
    with tmx.cpu():
        for _ in range(n):
            out.append([_host(b) for b in loader])
    return out, len(loader)


def _arrays(n=11):
    r = np.random.RandomState(0)
    return r.randn(n, 3).astype(np.float32), np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True],
                         ids=["sequential", "shuffled"])
def test_dataloader_batches_are_the_jax_packages(shuffle, last_batch,
                                                 workers):
    x, y = _arrays()

    def make(mx):
        ds = mx.gluon.data.ArrayDataset(x, y)
        return mx.gluon.data.DataLoader(ds, batch_size=4, shuffle=shuffle,
                                        last_batch=last_batch,
                                        num_workers=workers)

    want, want_len = _epochs(jmx, make)
    got, got_len = _epochs(tmx, make)
    assert got_len == want_len
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got[0]) == {"keep": 3, "discard": 2, "rollover": 2}[
        last_batch]


def test_dataloader_takes_a_batchify_fn_and_a_batch_sampler():
    x, _ = _arrays(10)

    def make(mx):
        sampler = mx.gluon.data.BatchSampler(
            mx.gluon.data.RandomSampler(10), 3, "keep")
        return mx.gluon.data.DataLoader(
            mx.gluon.data.SimpleDataset(list(x)), batch_sampler=sampler,
            batchify_fn=lambda s: np.stack(s).sum(axis=0))

    _same(_epochs(tmx, make)[0][0], _epochs(jmx, make)[0][0])
    for mx in (jmx, tmx):
        with pytest.raises(ValueError):
            mx.gluon.data.DataLoader(x, batch_size=2,
                                     batch_sampler=[[0, 1]])
        with pytest.raises(ValueError):
            mx.gluon.data.DataLoader(x)


def test_samplers_match_the_jax_package():
    for mx in (jmx, tmx):
        d = mx.gluon.data
        np.random.seed(3)
        got = [list(d.SequentialSampler(5)), list(d.RandomSampler(7)),
               list(d.BatchSampler(d.SequentialSampler(7), 3, "keep")),
               list(d.BatchSampler(d.SequentialSampler(7), 3, "discard"))]
        roll = d.BatchSampler(d.SequentialSampler(7), 3, "rollover")
        got += [list(roll), len(roll), list(roll)]
        got = [[np.asarray(b).tolist() for b in g]
               if isinstance(g, list) else g for g in got]
        if mx is jmx:
            want = got
    assert got == want
    assert got[5:] == [2, [[6, 0, 1], [2, 3, 4]]]


def test_dataloader_keeps_a_bounded_window_of_batches_in_flight():
    """The JAX package submits every batch of an epoch before yielding
    the first; the port keeps at most twice its workers in flight and
    yields the same batches in the same order."""
    fetched = []

    class Counting(object):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            fetched.append(i)
            time.sleep(0.001)
            return np.float32(i)

    ahead = {}
    for mx in (jmx, tmx):
        fetched.clear()
        loader = mx.gluon.data.DataLoader(Counting(), batch_size=2,
                                          num_workers=2)
        with tmx.cpu():
            it = iter(loader)
            first = _host(next(it))
            time.sleep(0.3)
            ahead[mx] = len(fetched)
            rest = [_host(b) for b in it]
        np.testing.assert_array_equal(first, [0, 1])
        assert len(rest) == 31
    assert ahead[jmx] == 64
    assert ahead[tmx] <= 2 * 2 * 2 + 2


def test_dataloader_builds_on_the_context_current_at_iter():
    x, y = _arrays(6)
    loader = tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(x, y),
                                       batch_size=3, num_workers=2)
    with tmx.cpu():
        batches = list(loader)
    assert all(b.context == CPU for pair in batches for b in pair)
    assert batches[0][0].dtype == "float32" and batches[0][1].dtype == "int32"


# -- datasets from files the tests write ----------------------------------
def _write_mnist(root, n=6, gz=False):
    r = np.random.RandomState(1)
    images = r.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = r.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    os.makedirs(root, exist_ok=True)
    with op(os.path.join(root, "t10k-images-idx3-ubyte" + sfx), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with op(os.path.join(root, "t10k-labels-idx1-ubyte" + sfx), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, fine=False):
    r = np.random.RandomState(2)
    os.makedirs(root, exist_ok=True)
    data = r.randint(0, 256, (5, 3072)).astype(np.uint8)
    batch = {"data": data}
    if fine:
        batch.update(fine_labels=list(r.randint(0, 100, 5)),
                     coarse_labels=list(r.randint(0, 20, 5)))
        name = "test"
    else:
        batch["labels"] = list(r.randint(0, 10, 5))
        name = "test_batch"
    with open(os.path.join(root, name), "wb") as f:
        pickle.dump(batch, f)


def _samples(mx, ds):
    with tmx.cpu():
        return [(_host(d), np.asarray(lab)) for d, lab in
                (ds[i] for i in range(len(ds)))]


@pytest.mark.parametrize("kind", ["mnist", "mnist_gz", "fashion", "cifar10",
                                  "cifar100_fine", "cifar100_coarse"])
def test_vision_datasets_read_local_files_as_the_jax_package(kind, tmp_path):
    root = str(tmp_path / kind)
    if kind.startswith("mnist") or kind == "fashion":
        _write_mnist(root, gz=kind == "mnist_gz")

        def make(mx):
            cls = mx.gluon.data.vision.FashionMNIST if kind == "fashion" \
                else mx.gluon.data.vision.MNIST
            return cls(root=root, train=False)
    else:
        _write_cifar(root, fine=kind.startswith("cifar100"))

        def make(mx):
            if kind == "cifar10":
                return mx.gluon.data.vision.CIFAR10(root=root, train=False)
            return mx.gluon.data.vision.CIFAR100(
                root=root, train=False, fine_label=kind.endswith("fine"))
    want = _samples(jmx, make(jmx))
    with tmx.cpu():
        got = _samples(tmx, make(tmx))
    assert len(got) == len(want) > 0
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.dtype == np.uint8
        np.testing.assert_array_equal(gd, wd)
        assert gl == wl


def test_vision_datasets_raise_naming_a_missing_file(tmp_path):
    for mx in (jmx, tmx):
        with tmx.cpu():
            with pytest.raises(mx.base.MXNetError, match="train-labels"):
                mx.gluon.data.vision.MNIST(root=str(tmp_path / "m"))
            with pytest.raises(mx.base.MXNetError, match="data_batch_1"):
                mx.gluon.data.vision.CIFAR10(root=str(tmp_path / "c"))


def _write_rec(prefix, n=5):
    r = np.random.RandomState(4)
    rec = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    for i in range(n):
        img = r.randint(0, 256, (10 + i, 12, 3)).astype(np.uint8)
        rec.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i % 3), i, 0), img, quality=95))
    rec.close()
    return prefix + ".rec"


def test_record_datasets_match_the_jax_package(tmp_path):
    path = _write_rec(str(tmp_path / "d"))
    for mx in (jmx, tmx):
        raw = mx.gluon.data.RecordFileDataset(path)
        assert len(raw) == 5
    assert tmx.gluon.data.RecordFileDataset(path)[3] == \
        jmx.gluon.data.RecordFileDataset(path)[3]
    want = _samples(jmx, jmx.gluon.data.vision.ImageRecordDataset(path))
    got = _samples(tmx, tmx.gluon.data.vision.ImageRecordDataset(path))
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        assert float(gl) == float(wl)


def test_record_dataset_reads_are_safe_across_threads(tmp_path):
    """A record is a seek and a read on one handle.  With a pause between
    the two, two threads reading at once get each other's record from the
    JAX package's dataset; the port's reads under a lock."""
    path = _write_rec(str(tmp_path / "d"))
    results = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        ds = mx.gluon.data.RecordFileDataset(path)
        seek = ds._record.seek

        def slow_seek(idx, seek=seek):
            seek(idx)
            time.sleep(0.05)

        ds._record.seek = slow_seek
        got = {}
        threads = [threading.Thread(target=lambda i=i: got.update(
            {i: ds[i]})) for i in (1, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        ds._record.seek = seek
        results[name] = [got[i] == ds[i] for i in (1, 4)]
    assert results["port"] == [True, True]
    assert results["jax"] != [True, True]


def test_image_folder_dataset_matches_the_jax_package(tmp_path):
    from PIL import Image
    r = np.random.RandomState(5)
    for label in ("cat", "dog"):
        os.makedirs(tmp_path / label)
        for i in range(2):
            Image.fromarray(r.randint(0, 256, (6, 7, 3)).astype(np.uint8)) \
                .save(str(tmp_path / label / ("%d.png" % i)))
    (tmp_path / "dog" / "notes.txt").write_text("skip")
    out = {}
    for mx in (jmx, tmx):
        ds = mx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
        out[mx] = (ds.synsets, [os.path.basename(f) for f, _ in ds.items],
                   _samples(mx, ds))
    assert out[tmx][:2] == out[jmx][:2] == (["cat", "dog"],
                                            ["0.png", "1.png"] * 2)
    for (gd, gl), (wd, wl) in zip(out[tmx][2], out[jmx][2]):
        np.testing.assert_array_equal(gd, wd)
        assert gl == wl


def test_transform_first_and_lazy_transforms_match_the_jax_package():
    x, y = _arrays(4)
    out = {}
    for mx in (jmx, tmx):
        ds = mx.gluon.data.ArrayDataset(x, y)
        a = ds.transform_first(lambda v: v * 2)
        b = ds.transform(lambda v, lab: (v + lab, lab), lazy=False)
        assert isinstance(b, mx.gluon.data.SimpleDataset)
        out[mx] = [a[i] for i in range(4)] + [b[i] for i in range(4)]
    for g, w in zip(out[tmx], out[jmx]):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1]


# -- transforms and the image ops -----------------------------------------
def _image(seed=6, shape=(9, 11, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape) \
        .astype(np.uint8)


TRANSFORMS = {
    "to_tensor": lambda t: t.ToTensor(),
    "normalize": lambda t: t.Compose([t.ToTensor(), t.Normalize(
        (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))]),
    "cast": lambda t: t.Cast("float32"),
    "resize": lambda t: t.Resize((5, 7)),
    "center_crop": lambda t: t.CenterCrop(6),
    "center_crop_up": lambda t: t.CenterCrop((13, 4)),
    "random_resized_crop": lambda t: t.RandomResizedCrop(8),
    "flip_lr": lambda t: t.RandomFlipLeftRight(),
    "flip_tb": lambda t: t.RandomFlipTopBottom(),
    "brightness": lambda t: t.RandomBrightness(0.4),
    "contrast": lambda t: t.RandomContrast(0.4),
    "saturation": lambda t: t.RandomSaturation(0.4),
    "hue": lambda t: t.RandomHue(0.3),
    "lighting": lambda t: t.RandomLighting(0.1),
    "color_jitter": lambda t: t.RandomColorJitter(0.3, 0.3, 0.3, 0.1),
    "color_jitter_alias": lambda t: t.ColorJitter(0.2, 0.2),
    "compose_fn": lambda t: t.Compose([t.RandomResizedCrop(6),
                                       lambda a: a * 1, t.ToTensor()]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_jax_package(name):
    out = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            t = TRANSFORMS[name](mx.gluon.data.vision.transforms)
            res = []
            for seed in range(4):
                np.random.seed(seed)
                res.append(_host(t(mx.nd.array(_image(seed), dtype="uint8"))))
        out[mx] = res
    for g, w in zip(out[tmx], out[jmx]):
        assert g.shape == w.shape
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("op", ["_image_to_tensor", "to_tensor",
                                "_image_normalize", "image_normalize"])
@pytest.mark.parametrize("batched", [False, True], ids=["chw", "nchw"])
def test_image_op_matches_the_jax_package(op, batched):
    shape = (2, 5, 6, 3) if batched else (5, 6, 3)
    img = _image(shape=shape)
    attrs = {}
    if "normalize" in op:
        img = np.random.RandomState(8).rand(
            *((2, 3, 5, 6) if batched else (3, 5, 6))).astype(np.float32)
        attrs = {"mean": (0.1, 0.2, 0.3), "std": (0.5, 0.6, 0.7)}
    out = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            out[mx] = getattr(mx.nd, op)(mx.nd.array(img, dtype=img.dtype),
                                         **attrs).asnumpy()
    assert out[tmx].shape == out[jmx].shape
    assert out[tmx].dtype == np.float32
    assert rel(out[tmx], out[jmx]) <= TOL
