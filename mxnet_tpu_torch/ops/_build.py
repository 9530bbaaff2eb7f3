"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled by
its own ``nvcc`` call into ``_build/libmxtt_<name>.so``; all the
sources compile in parallel at first use.  A library is rebuilt only
when the hash of its source and flags changes (kept beside it in
``libmxtt_<name>.so.hash``), and each is loaded with ``ctypes``.

The build runs on the machine with the card, never at import: this
module only computes paths until :func:`library` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["SOURCES", "library", "build_all", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("scale_bias_relu", "softmax", "optimizer_sweep", "layernorm",
           "flash_attention")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS = {}      # guarded-by: _LOCK — name -> ctypes.CDLL


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
    so = os.path.join(BUILD_DIR, "libmxtt_%s.so" % name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return src, so, digest.hexdigest()


def _fresh(so, digest):
    try:
        with open(so + ".hash") as f:
            return f.read().strip() == digest and os.path.exists(so)
    except OSError:
        return False


def build_all(verbose=False):
    """Compile every stale source, one ``nvcc`` each, all started
    together.  Returns ``{name: compiler output}`` for the sources built
    (with ``verbose`` the ptxas register and spill report is included).
    Raises MXNetError naming the source on a failed compile."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in SOURCES:
        src, so, digest = _paths(name)
        if _fresh(so, digest):
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
        report[name] = out
    return report


def library(name):
    """The loaded ``libmxtt_<name>.so``, building the sources first if
    any is stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(_paths(name)[1])
            _LIBS[name] = lib
        return lib
