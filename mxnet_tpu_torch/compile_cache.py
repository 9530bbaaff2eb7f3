"""Persistent compile cache — the built CUDA kernel libraries, kept
across processes (counterpart of ``mxnet_tpu/compile_cache.py``).

What this package compiles is its hand-written kernels: ``ops/_build.py``
runs one ``nvcc`` per ``ops/csrc/<name>.cu`` into ``libmxtt_<name>.so``
beside a ``.hash`` of its source and flags.  That build directory IS the
cache: a process whose hashes match loads the libraries and runs no
``nvcc`` (a hit); a stale or missing library is built (a miss).  The
JAX package's cache holds XLA executables instead; its public surface is
kept here, pointed at the libraries:

- ``MXNET_COMPILE_CACHE_DIR`` moves the build directory (unset, the
  package's own ``_build/``, which ``.gitignore`` lists);
  :func:`ensure_initialized` reads it once, from the first build;
- **hygiene** — a size cap (``MXNET_COMPILE_CACHE_MAX_BYTES``) with LRU
  eviction of whole libraries (the ``.so`` and its ``.hash``) by
  recency, the library's mtime, which every load refreshes; swept at
  initialization and on demand (:func:`sweep`);
- **degradation** — an unwritable directory is counted as an error and
  the build goes to a private temporary directory instead (a cold
  build, every process); a library that fails to load is counted as an
  error and rebuilt from its source.  A rebuild that fails raises: the
  package never runs on without its kernel;
- **telemetry** — ``mxnet_compile_cache_{requests,hits,misses,errors,
  evictions}_total`` counters and the ``mxnet_compile_cache_size_bytes``
  gauge, while telemetry is on; :func:`stats` always.

The serving layer pairs this with the warmup manifest
(``serving.WarmupManifest``): the cache keeps the kernels built, the
manifest remembers which (model, bucket) forwards a replica needs, so a
restarted server warms exactly its last working set.

Nothing here imports torch or the rest of the package at import time.
"""
from __future__ import annotations

import logging
import os
import tempfile
import threading

__all__ = ["ensure_initialized", "configure", "enabled", "cache_dir",
           "stats", "sweep", "reset"]

_LOCK = threading.Lock()
_INIT_LOCK = threading.Lock()   # a concurrent first build waits for the
#                               # configuration instead of racing it
_STATE = {                      # guarded-by: _LOCK
    "checked": False,           # configuration committed (terminal)
    "enabled": False,
    "dir": None,
    "max_bytes": 0,
    "entries": 0,               # as of the last sweep()/stats(refresh=True)
    "size_bytes": 0,            # as of the last sweep()/stats(refresh=True)
}
_COUNTS = {"requests": 0, "hits": 0, "misses": 0, "errors": 0,
           "evictions": 0}
#                               # guarded-by: _LOCK

_HELP = {
    "requests": "kernel libraries looked up in the compile cache "
                "(requests - hits == nvcc runs)",
    "hits": "compile-cache hits (a built kernel library whose source "
            "hash matches, loaded without running nvcc)",
    "misses": "compile-cache misses (a kernel library built by nvcc)",
    "errors": "compile-cache failures (unwritable directory, a library "
              "that failed to load) — each degraded to a cold build, "
              "never to running without the kernel",
    "evictions": "kernel libraries LRU-evicted by the size cap "
                 "(MXNET_COMPILE_CACHE_MAX_BYTES)",
}

_SUFFIX = ".so"
_PREFIX = "libmxtt_"


def _declare_counters():
    """Create every mxnet_compile_cache_*_total family up front, so the
    exposition shows an explicit 0 (a warm restart's zero misses) rather
    than an absent family."""
    from . import telemetry
    if not telemetry.enabled():
        return
    for kind in _COUNTS:
        telemetry.counter("mxnet_compile_cache_%s_total" % kind,
                          _HELP[kind])


def _set_size_gauge(total):
    from . import telemetry
    if telemetry.enabled():
        telemetry.gauge(
            "mxnet_compile_cache_size_bytes",
            "bytes of built kernel libraries in the compile cache "
            "directory (updated by hygiene sweeps)").set(total)


def _bump(kind, n=1):
    if not n:
        return
    with _LOCK:
        _COUNTS[kind] += n
    from . import telemetry
    if telemetry.enabled():
        telemetry.counter("mxnet_compile_cache_%s_total" % kind,
                          _HELP[kind]).inc(n)


def record(outcome):
    """One library lookup by ``ops/_build.py``: ``"hit"`` (loaded as
    built) or ``"miss"`` (built by nvcc)."""
    _bump("requests")
    _bump("hits" if outcome == "hit" else "misses")


def record_error():
    """A cache failure that was degraded to a cold build."""
    _bump("errors")


def touch(path):
    """Refresh a library's recency (its mtime) on load."""
    try:
        os.utime(path)
    except OSError:
        pass


def ensure_initialized():
    """Read the ``MXNET_COMPILE_CACHE_*`` knobs once per process —
    called by the first kernel build — and return whether the cache is
    enabled.  After the first call this is one dict read."""
    if _STATE["checked"]:
        return _STATE["enabled"]
    with _INIT_LOCK:
        if _STATE["checked"]:
            return _STATE["enabled"]
        from . import config as _config
        return configure(_config.get("MXNET_COMPILE_CACHE_DIR"))


def _default_dir():
    from .ops._build import BUILD_DIR
    return BUILD_DIR


def configure(directory, min_compile_secs=None, min_entry_bytes=None,
              max_bytes=None):
    """Point the kernel build at ``directory`` (None or empty: the
    package's ``_build/``).  A directory that cannot be created or
    written is counted as an error and replaced by a private temporary
    directory, so every build there is cold.  ``min_compile_secs`` and
    ``min_entry_bytes`` are accepted for the JAX package's call shape:
    every build is kept.  Returns whether the cache is enabled (False
    only in the degraded case)."""
    from . import config as _config
    del min_compile_secs, min_entry_bytes
    if max_bytes is None:
        max_bytes = _config.get("MXNET_COMPILE_CACHE_MAX_BYTES")
    directory = os.path.abspath(directory or _default_dir())
    ok = True
    try:
        os.makedirs(directory, exist_ok=True)
        probe = os.path.join(directory, ".mxnet-cache-probe-%d" % os.getpid())
        with open(probe, "wb") as f:
            f.write(b"probe")
        os.remove(probe)
    except OSError as exc:
        _bump("errors")
        logging.warning(
            "compile cache disabled: %r is not a writable directory (%s); "
            "the kernels build cold into a temporary directory",
            directory, exc)
        directory = tempfile.mkdtemp(prefix="mxnet-kernels-")
        ok = False
    _declare_counters()
    with _LOCK:        # checked last: the commit marker the fast path reads
        _STATE["enabled"] = ok
        _STATE["dir"] = directory
        _STATE["max_bytes"] = int(max_bytes)
        _STATE["checked"] = True
    sweep()
    return ok


def enabled():
    return _STATE["enabled"]


def cache_dir():
    """The build directory (configuring it from the knobs first)."""
    ensure_initialized()
    return _STATE["dir"]


def _entries(directory):
    """[(library path, size, recency)] for each built library; the size
    counts its ``.hash`` too."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
            continue
        path = os.path.join(directory, name)
        try:
            size = os.path.getsize(path)
            recency = os.path.getmtime(path)
        except OSError:
            continue        # concurrently evicted by another process
        try:
            size += os.path.getsize(path + ".hash")
        except OSError:
            pass
        out.append((path, size, recency))
    return out


def sweep(max_bytes=None):
    """Enforce the size cap: evict least-recently-used libraries until
    the cache fits.  A process that loses an evicted library rebuilds
    it.  Returns the number of libraries evicted."""
    with _LOCK:
        directory = _STATE["dir"]
        if max_bytes is None:
            max_bytes = _STATE["max_bytes"]
    if not directory:
        return 0
    entries = _entries(directory)
    total = sum(size for _p, size, _r in entries)
    evicted = 0
    if max_bytes and max_bytes > 0 and total > max_bytes:
        entries.sort(key=lambda e: e[2])        # oldest recency first
        for path, size, _recency in entries:
            if total <= max_bytes:
                break
            try:
                os.remove(path + ".hash")
            except OSError:
                pass
            try:
                os.remove(path)
            except OSError:
                continue    # another process won the eviction race
            total -= size
            evicted += 1
    with _LOCK:
        _STATE["entries"] = len(entries) - evicted
        _STATE["size_bytes"] = total
    _bump("evictions", evicted)
    _set_size_gauge(total)
    return evicted


def stats(refresh=True):
    """Snapshot for /stats surfaces: the counters, and the entries and
    bytes on disk (rescanned with ``refresh``, else as of the last
    sweep — the cheap form the serving ``stats()`` poll uses)."""
    with _LOCK:
        snap = dict(_COUNTS)
        snap["enabled"] = _STATE["enabled"]
        snap["dir"] = _STATE["dir"]
        snap["max_bytes"] = _STATE["max_bytes"]
        snap["entries"] = _STATE["entries"]
        snap["size_bytes"] = _STATE["size_bytes"]
    if refresh and snap["dir"]:
        entries = _entries(snap["dir"])
        snap["entries"] = len(entries)
        snap["size_bytes"] = sum(size for _p, size, _r in entries)
        with _LOCK:
            _STATE["entries"] = snap["entries"]
            _STATE["size_bytes"] = snap["size_bytes"]
        _set_size_gauge(snap["size_bytes"])
    return snap


def reset():
    """Test hook: forget the configuration and zero the counters, so the
    next :func:`ensure_initialized` re-reads the environment."""
    with _LOCK:
        _STATE["checked"] = False
        _STATE["enabled"] = False
        _STATE["dir"] = None
        _STATE["entries"] = 0
        _STATE["size_bytes"] = 0
        for k in _COUNTS:
            _COUNTS[k] = 0
