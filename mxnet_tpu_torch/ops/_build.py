"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
its own ``nvcc`` call into ``libmxtt_<name>.so`` in the build directory;
all the stale sources compile in parallel at first use.  A library is
rebuilt only when the hash of its source and flags changes (kept beside
it in ``libmxtt_<name>.so.hash``), and each is loaded with ``ctypes``.

The build directory is the compile cache's (``compile_cache.cache_dir``:
``MXNET_COMPILE_CACHE_DIR``, else ``_build/`` beside the package,
``BUILD_DIR``).  Each source's first lookup in a process counts as a
cache hit (its library was fresh) or a miss (nvcc ran); a library that
fails to load counts as an error and is rebuilt from its source once,
and a failed rebuild raises.

The build runs on the machine with the card, never at import: this
module only computes paths until :func:`library` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["SOURCES", "library", "build_all", "build_dir", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("scale_bias_relu", "softmax", "optimizer_sweep", "layernorm",
           "flash_attention")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS = {}      # guarded-by: _LOCK — name -> ctypes.CDLL
_COUNTED = set()    # sources whose first lookup was counted


def build_dir():
    """Where the libraries are built and loaded from."""
    from .. import compile_cache
    return compile_cache.cache_dir()


def nvcc_path():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                     "kernels are built from csrc/ with the CUDA toolkit")


def _paths(name):
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(build_dir(), "libmxtt_%s.so" % name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return src, so, digest.hexdigest()


def _fresh(so, digest):
    try:
        with open(so + ".hash") as f:
            return f.read().strip() == digest and os.path.exists(so)
    except OSError:
        return False


def _count(name, outcome):
    from .. import compile_cache
    if name not in _COUNTED:
        _COUNTED.add(name)
        compile_cache.record(outcome)


def build_all(verbose=False, force=()):
    """Compile every stale source (and those named in ``force``), one
    ``nvcc`` each, all started together.  Returns ``{name: compiler
    output}`` for the sources built (with ``verbose`` the ptxas register
    and spill report is included).  Raises MXNetError naming the source
    on a failed compile."""
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = None
    procs = {}
    for name in SOURCES:
        src, so, digest = _paths(name)
        if name not in force and _fresh(so, digest):
            _count(name, "hit")
            continue
        nvcc = nvcc or nvcc_path()
        tmp = "%s.%d.tmp" % (so, os.getpid())
        cmd = [nvcc] + FLAGS + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", tmp, src]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so, digest)
    report = {}
    for name, (proc, tmp, so, digest) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise MXNetError("nvcc failed on csrc/%s.cu (exit %d):\n%s"
                             % (name, proc.returncode, out))
        os.replace(tmp, so)
        with open(so + ".hash", "w") as f:
            f.write(digest)
        _count(name, "miss")
        report[name] = out
    return report


def library(name):
    """The loaded ``libmxtt_<name>.so``, building the sources first if
    any is stale.  A library that fails to load (a corrupt or truncated
    file) is counted as a compile-cache error and rebuilt once."""
    from .. import compile_cache
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            path = _paths(name)[1]
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                compile_cache.record_error()
                logging.warning("kernel library %s failed to load (%s); "
                                "rebuilding it from its source", path, exc)
                _COUNTED.discard(name)
                build_all(force=(name,))
                lib = ctypes.CDLL(path)
            compile_cache.touch(path)
            _LIBS[name] = lib
        return lib
