"""The port's compile cache and warmup manifest, on the CPU.

What the port compiles is its CUDA kernels: ``ops/_build.py`` runs one
``nvcc`` per source into ``libmxtt_<name>.so`` in the compile cache's
directory.  There is no ``nvcc`` here, so a stand-in compiler (a script
that copies the C library into the ``-o`` path) builds loadable
stand-in libraries, and the cache is held to its contract over them: a
library whose hash matches is a hit and runs no compiler, a stale or
missing one is a miss, a library that fails to load is an error and is
rebuilt, a rebuild that fails raises, ``MXNET_COMPILE_CACHE_DIR`` moves
the directory, an unwritable one degrades to a temporary directory, and
``sweep`` evicts the least recently used libraries over the cap.  The
knobs and the ``stats()`` keys are the JAX package's.

Then the warmup manifest (``serving/manifest.py``) and the server's
warm paths, as in the JAX package's ``tests/test_compile_cache.py``: the
manifest round-trips atomically and tolerates corruption, a server
records its bound keys and a restarted one replays them, a manifest
entry off the ladder or of another backend (the JAX package's ``tpu``)
is skipped, the checkpoint watcher warms a version before promoting it,
and ``mxnet_serving_warmup_seconds`` splits warm and cold plans.
"""
import ctypes.util
import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile_cache, telemetry
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.serving import ExecutorCache, ModelServer, WarmupManifest

torch.set_num_threads(1)

CPU = tmx.cpu()
IN_DIM = 6
HID = 4


@pytest.fixture(autouse=True)
def _isolated_cache(monkeypatch):
    """Every test starts from an unconfigured cache and an empty set of
    loaded libraries, and leaves the default configuration behind."""
    compile_cache.reset()
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_COUNTED", set())
    yield
    compile_cache.reset()


def _libc():
    path = ctypes.util.find_library("c")
    for cand in (path, "/lib/x86_64-linux-gnu/libc.so.6",
                 "/usr/lib/x86_64-linux-gnu/libc.so.6", "/lib64/libc.so.6"):
        if cand and os.path.isabs(cand) and os.path.exists(cand):
            return cand
    pytest.skip("no C library file to stand in for a kernel library")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler: copies the C library to its ``-o`` path, or
    fails when ``FAKE_NVCC_FAIL`` is set; returns the log of its runs
    (the source each was given)."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!%s\nimport os, shutil, sys\n"
        "args = sys.argv[1:]\n"
        "open(%r, 'a').write(args[-1] + '\\n')\n"
        "if os.environ.get('FAKE_NVCC_FAIL'):\n"
        "    sys.exit('nvcc: error')\n"
        "shutil.copyfile(%r, args[args.index('-o') + 1])\n"
        % (sys.executable, str(log), _libc()))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))

    def runs():
        return log.read_text().split() if log.exists() else []
    return runs


def _fresh_process(monkeypatch):
    """What a new process sees: nothing loaded or counted, the cache
    configured anew from the environment."""
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_COUNTED", set())
    compile_cache.reset()


# ---------------------------------------------------------------------------
# the knobs and the surface, against the JAX package's
# ---------------------------------------------------------------------------
def test_knobs_and_stats_keys_are_the_jax_packages():
    from mxnet_tpu import compile_cache as jcc
    from mxnet_tpu import config as jconfig
    for name in ("MXNET_COMPILE_CACHE_DIR", "MXNET_COMPILE_CACHE_MAX_BYTES",
                 "MXNET_COMPILE_CACHE_MIN_COMPILE_SECS",
                 "MXNET_COMPILE_CACHE_MIN_ENTRY_BYTES",
                 "MXNET_COMPILE_CACHE_MANIFEST"):
        assert tmx.config.get(name) == jconfig.get(name), name
    assert set(compile_cache.stats()) == set(jcc.stats())


# ---------------------------------------------------------------------------
# hits, misses, errors over stand-in libraries
# ---------------------------------------------------------------------------
def test_a_fresh_directory_misses_then_a_restart_hits(tmp_path, monkeypatch,
                                                      fake_nvcc):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    lib = _build.library("softmax")
    assert lib is not None
    assert _build.build_dir() == str(tmp_path / "cc")
    assert sorted(os.path.basename(p) for p in fake_nvcc()) == sorted(
        n + ".cu" for n in _build.SOURCES)
    st = compile_cache.stats()
    n = len(_build.SOURCES)
    assert (st["requests"], st["hits"], st["misses"], st["errors"]) == \
        (n, 0, n, 0)
    assert st["entries"] == n and st["size_bytes"] > 0
    for name in _build.SOURCES:
        so = os.path.join(str(tmp_path / "cc"), "libmxtt_%s.so" % name)
        assert os.path.exists(so + ".hash")
    runs = len(fake_nvcc())
    _fresh_process(monkeypatch)
    _build.library("layernorm")
    st = compile_cache.stats()
    assert len(fake_nvcc()) == runs, "a warm restart ran the compiler"
    assert (st["requests"], st["hits"], st["misses"]) == (n, n, 0)


def test_a_changed_source_hash_rebuilds_that_library(tmp_path, monkeypatch,
                                                     fake_nvcc):
    compile_cache.configure(str(tmp_path / "cc"))
    _build.build_all()
    with open(os.path.join(str(tmp_path / "cc"),
                           "libmxtt_softmax.so.hash"), "w") as f:
        f.write("stale")
    _fresh_process(monkeypatch)
    compile_cache.configure(str(tmp_path / "cc"))
    report = _build.build_all()
    assert sorted(report) == ["softmax"]
    st = compile_cache.stats()
    assert st["misses"] == 1 and st["hits"] == len(_build.SOURCES) - 1


def test_a_corrupt_library_is_an_error_and_is_rebuilt(tmp_path, monkeypatch,
                                                      fake_nvcc):
    compile_cache.configure(str(tmp_path / "cc"))
    _build.build_all()
    so = os.path.join(str(tmp_path / "cc"), "libmxtt_softmax.so")
    with open(so, "wb") as f:
        f.write(b"\x7fELF truncated")
    _fresh_process(monkeypatch)
    compile_cache.configure(str(tmp_path / "cc"))
    before = len(fake_nvcc())
    assert _build.library("softmax") is not None
    st = compile_cache.stats()
    assert st["errors"] == 1
    assert len(fake_nvcc()) == before + 1
    assert st["misses"] == 1


def test_a_failed_rebuild_raises(tmp_path, monkeypatch, fake_nvcc):
    compile_cache.configure(str(tmp_path / "cc"))
    _build.build_all()
    with open(os.path.join(str(tmp_path / "cc"), "libmxtt_softmax.so"),
              "wb") as f:
        f.write(b"garbage")
    _fresh_process(monkeypatch)
    compile_cache.configure(str(tmp_path / "cc"))
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(tmx.MXNetError, match="nvcc failed on csrc/softmax"):
        _build.library("softmax")
    assert compile_cache.stats()["errors"] == 1


def test_an_unwritable_directory_degrades_to_a_cold_temporary_build(
        tmp_path, monkeypatch, fake_nvcc, caplog):
    blocker = tmp_path / "a-file"
    blocker.write_text("x")
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(blocker / "cc"))
    assert compile_cache.ensure_initialized() is False
    assert "compile cache disabled" in caplog.text
    st = compile_cache.stats()
    assert st["errors"] == 1 and not st["enabled"]
    assert st["dir"] != str(blocker / "cc") and os.path.isdir(st["dir"])
    assert _build.library("softmax") is not None
    assert compile_cache.stats()["misses"] == len(_build.SOURCES)


def test_sweep_evicts_least_recently_used_libraries(tmp_path):
    d = tmp_path / "cc"
    d.mkdir()
    for i, name in enumerate(("a", "b", "c", "d")):
        so = d / ("libmxtt_%s.so" % name)
        so.write_bytes(b"x" * 1000)
        (d / ("libmxtt_%s.so.hash" % name)).write_text("h" * 24)
        os.utime(str(so), (1000 + i, 1000 + i))
    (d / "variants").mkdir()               # not a cache entry
    telemetry.enable()
    try:
        compile_cache.configure(str(d), max_bytes=10 ** 9)
        assert compile_cache.stats()["entries"] == 4
        compile_cache.touch(str(d / "libmxtt_a.so"))   # a is now newest
        assert compile_cache.sweep(max_bytes=2100) == 2
        left = sorted(os.listdir(str(d)))
        assert left == ["libmxtt_a.so", "libmxtt_a.so.hash", "libmxtt_d.so",
                        "libmxtt_d.so.hash", "variants"]
        st = compile_cache.stats()
        assert st["evictions"] == 2 and st["size_bytes"] == 2048
        snap = telemetry.snapshot()
        assert snap["mxnet_compile_cache_size_bytes"]["values"][0][
            "value"] == 2048
        for kind in ("requests", "hits", "misses", "errors", "evictions"):
            assert "mxnet_compile_cache_%s_total" % kind in snap, kind
    finally:
        telemetry.disable()


# ---------------------------------------------------------------------------
# the warmup manifest
# ---------------------------------------------------------------------------
def _make_model(mx, seed=0):
    data = mx.sym.Variable("data")
    out = mx.sym.softmax(mx.sym.FullyConnected(data, num_hidden=HID,
                                               name="fc"), name="prob")
    rng = np.random.RandomState(seed)
    w = rng.randn(HID, IN_DIM).astype(np.float32)
    b = rng.randn(HID).astype(np.float32)
    if mx is tmx:
        return out, {"fc_weight": tmx.nd.array(w, ctx=CPU),
                     "fc_bias": tmx.nd.array(b, ctx=CPU)}
    return out, {"fc_weight": mx.nd.array(w), "fc_bias": mx.nd.array(b)}


def test_manifest_roundtrip_atomic_and_corrupt_tolerant(tmp_path):
    from mxnet_tpu_torch.serving.registry import ModelVersion
    symb, args = _make_model(tmx)
    entry = ModelVersion("m", 1, symb, args, {}, {"data": (1, IN_DIM)})
    path = tmp_path / "warmup.json"
    man = WarmupManifest(str(path))
    assert man.record(entry, 4, backend="cpu") is True
    assert man.record(entry, 4, backend="cpu") is False
    assert man.record(entry, 8, backend="cpu") is True
    assert not [f for f in os.listdir(str(tmp_path)) if f.startswith(".")]
    man2 = WarmupManifest(str(path))
    assert man2.buckets_for("m", entry.symbol_sha) == [4, 8]
    assert man2.buckets_for("m", entry.symbol_sha, backend="gpu") == []
    entry_v2 = ModelVersion("m", 2, symb, args, {}, {"data": (1, IN_DIM)})
    assert entry_v2.symbol_sha == entry.symbol_sha
    man2.record(entry_v2, 4, backend="cpu")
    assert len(man2) == 2
    for text in ("{ not json !!!", "[1, 2, 3]",
                 '{"schema": 1, "entries": ["x", 7]}'):
        path.write_text(text)
        assert len(WarmupManifest(str(path))) == 0


def test_manifest_files_and_program_identity_equal_the_jax_packages(
        tmp_path):
    """The same records give the same file in both packages, and the
    program identity (the symbol's sha256) is the same."""
    from mxnet_tpu.serving import WarmupManifest as JManifest
    from mxnet_tpu.serving.registry import ModelVersion as JVersion
    from mxnet_tpu_torch.serving.registry import ModelVersion
    docs = []
    for mx, Man, Ver in ((tmx, WarmupManifest, ModelVersion),
                         (jmx, JManifest, JVersion)):
        symb, args = _make_model(mx)
        entry = Ver("m", 3, symb, args, {}, {"data": (1, IN_DIM)})
        path = str(tmp_path / ("%s.json" % mx.__name__))
        man = Man(path)
        for b in (8, 1, 4):
            man.record(entry, b, backend="cpu")
        docs.append(open(path).read())
    assert docs[0] == docs[1]


def test_server_records_manifest_and_replays_it(tmp_path):
    symb, args = _make_model(tmx)
    manifest = str(tmp_path / "warmup.json")
    srv = ModelServer(max_batch=4, manifest_path=manifest, ctx=CPU)
    srv.add_model("m", symb, args, {}, {"data": (1, IN_DIM)})
    assert [b for (_n, _v, b) in srv.warmup("m")] == [1, 2, 4]
    doc = json.loads(open(manifest).read())
    assert sorted(e["bucket"] for e in doc["entries"]) == [1, 2, 4]
    assert {e["backend"] for e in doc["entries"]} == {"cpu"}
    srv2 = ModelServer(max_batch=4, manifest_path=manifest, ctx=CPU)
    srv2.add_model("m", symb, args, {}, {"data": (1, IN_DIM)})
    assert [b for (_n, _v, b) in srv2.warmup_from_manifest()] == [1, 2, 4]
    assert srv2.cache.stats()["misses"] == 3
    srv3 = ModelServer(max_batch=8, manifest_path=manifest, ctx=CPU)
    srv3.add_model("m", symb, args, {}, {"data": (1, IN_DIM)})
    srv3.start()
    try:
        srv3.infer("m", {"data": np.zeros((5, IN_DIM), np.float32)},
                   timeout_ms=60000.0)
    finally:
        srv3.stop(drain=False)
    man = WarmupManifest(manifest)
    assert 8 in man.buckets_for("m", srv3.registry.get("m").symbol_sha)
    stats = srv3.stats()
    assert stats["warmup_manifest"]["entries"] == len(man)
    assert set(stats["compile_cache"]) == set(compile_cache.stats())


@pytest.mark.parametrize("backend, want", [("cpu", [1, 2]), ("tpu", [])])
def test_a_jax_written_manifest_replays_only_its_own_backend(tmp_path,
                                                             backend, want):
    from mxnet_tpu.serving import WarmupManifest as JManifest
    from mxnet_tpu.serving.registry import ModelVersion as JVersion
    jsym, jargs = _make_model(jmx)
    path = str(tmp_path / "warmup.json")
    jman = JManifest(path)
    for b in (1, 2, 16):
        jman.record(JVersion("m", 1, jsym, jargs, {}, {"data": (1, IN_DIM)}),
                    b, backend=backend)
    symb, args = _make_model(tmx)
    srv = ModelServer(max_batch=4, manifest_path=path, ctx=CPU)
    srv.add_model("m", symb, args, {}, {"data": (1, IN_DIM)})
    assert [b for (_n, _v, b) in srv.warmup_from_manifest()] == want
    assert srv.cache.stats()["misses"] == len(want)


def test_watcher_warms_new_version_before_promoting(tmp_path, monkeypatch):
    X = np.random.RandomState(0).rand(32, IN_DIM).astype(np.float32)
    y = (np.arange(32) % 2).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, y, batch_size=8)
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=2, name="fc"), name="softmax")
    mod = tmx.mod.Module(net, context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(tmx.init.Xavier())
    mgr = tmx.checkpoint.CheckpointManager(str(tmp_path / "ckpts"),
                                           async_save=False)
    mgr.save_module(mod, epoch=0, nbatch=1)
    manifest = str(tmp_path / "warmup.json")
    srv = ModelServer(max_batch=2, manifest_path=manifest, ctx=CPU)
    events = []
    real_warm = srv.warmup_version
    monkeypatch.setattr(
        srv, "warmup_version",
        lambda name, version, **kw: (events.append(("warm", version)),
                                     real_warm(name, version, **kw))[1])
    real_promote = srv.registry.set_default
    monkeypatch.setattr(
        srv.registry, "set_default",
        lambda name, version: (events.append(("promote", version)),
                               real_promote(name, version))[1])
    watcher = srv.watch_checkpoints(str(tmp_path / "ckpts"), "clf",
                                    start=False)
    step1 = watcher.poll_once()
    assert events == [("warm", step1), ("promote", step1)]
    assert srv.cache.stats()["misses"] == 2
    mgr.save_module(mod, epoch=0, nbatch=2)
    step2 = watcher.poll_once()
    assert step2 > step1 and srv.registry.get("clf").version == step2
    assert srv.cache.stats()["misses"] == 4
    assert len(WarmupManifest(manifest)) == 2


def test_serving_cache_evictions_mirrored_to_registry():
    from mxnet_tpu_torch.serving.registry import ModelVersion
    symb, args = _make_model(tmx)
    entry = ModelVersion("m", 1, symb, args, {}, {"data": (1, IN_DIM)})
    cache = ExecutorCache(1, None, ctx=CPU)
    fam = telemetry.counter("mxnet_serving_cache_evictions_total")
    before = fam.labels().value
    cache.get(entry, 1)
    cache.get(entry, 2)
    assert cache.stats()["evictions"] == 1
    assert fam.labels().value == before + 1


def test_warmup_seconds_histogram_warm_and_cold(monkeypatch):
    symb, args = _make_model(tmx)
    srv = ModelServer(max_batch=2, ctx=CPU)
    srv.add_model("m", symb, args, {}, {"data": (1, IN_DIM)})
    real_get = srv.cache.get

    def building_get(entry, bucket, binder=None):
        compile_cache.record("miss")     # a kernel build during the plan
        return real_get(entry, bucket, binder)

    monkeypatch.setattr(srv.cache, "get", building_get)
    srv.warmup("m")                      # cold
    monkeypatch.setattr(srv.cache, "get", real_get)
    srv2 = ModelServer(max_batch=2, ctx=CPU)
    srv2.add_model("m", symb, args, {}, {"data": (1, IN_DIM)})
    srv2.warmup("m")                     # warm: no build
    text = telemetry.prometheus_text()
    assert 'mxnet_serving_warmup_seconds_count{mode="cold"}' in text
    assert 'mxnet_serving_warmup_seconds_count{mode="warm"}' in text
