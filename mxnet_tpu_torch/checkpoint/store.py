"""On-disk checkpoint layout — sharded, integrity-checked, atomic
(counterpart of ``mxnet_tpu/checkpoint/store.py``; the layout is the
same, so a checkpoint moves between the two packages both ways).

Layout under one checkpoint root::

    <root>/
      ckpt-00000007/              # one COMMITTED checkpoint
        manifest.json             # schema below; written last, inside tmp
        arg.fc1_weight.bin        # one raw little-endian shard per array
        aux.bn_moving_mean.bin
        optimizer.pkl             # opaque blobs (optimizer state, symbol)
        symbol.json
      .tmp-ckpt-00000008-<pid>-<nonce>/   # an in-flight or crashed write

Commit protocol (the crash-safety core): every shard and finally the
manifest are written into a hidden ``.tmp-*`` sibling directory; the
commit is ONE ``os.replace(tmp, final)``.  Directory rename is atomic
on POSIX, so a reader can never observe a half-written checkpoint at a
``ckpt-*`` name — a crash at any instant leaves either no ``ckpt-N``
or a complete one, plus possibly an orphan ``.tmp-*`` that
:meth:`CheckpointStore.gc_orphans` reaps.  ``latest()`` therefore only
ever resolves COMPLETE checkpoints, with no lock between writer and
reader processes (the serving watcher polls the same directory).

Manifest schema (``manifest.json``, version 1)::

    {"format": "mxnet-tpu-checkpoint", "version": 1, "step": 7,
     "meta":   {...caller state: epoch/nbatch/rng/iter/...},
     "shards": {"arg/fc1_weight": {"file": "arg.fc1_weight.bin",
                "dtype": "float32", "shape": [8, 64],
                "bytes": 2048, "sha256": "..."}, ...},
     "blobs":  {"optimizer": {"file": "optimizer.pkl",
                "bytes": 123, "sha256": "..."}, ...}}

Every shard/blob carries its byte size and sha256; :meth:`read`
verifies both before handing data back, so bit rot or a torn disk is an
:class:`IntegrityError` instead of NaNs three epochs later.

An array to write is a numpy array or a CPU ``torch.Tensor``.  bfloat16
has no numpy dtype without ``ml_dtypes``: a bfloat16 tensor is written
as its raw 16-bit words under the dtype name ``"bfloat16"`` (the bytes
the JAX package writes for an ``ml_dtypes.bfloat16`` array), and such a
shard reads back as a ``torch.bfloat16`` tensor; every other shard reads
back as a numpy array.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import threading
import uuid

import numpy as np
import torch

from ..base import MXNetError
from ..fault import hooks as _fault
from ..telemetry import tracing as _tracing

__all__ = ["CheckpointError", "IntegrityError", "CheckpointStore",
           "RetentionPolicy", "MANIFEST_NAME", "MANIFEST_FORMAT",
           "MANIFEST_VERSION"]

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "mxnet-tpu-checkpoint"
MANIFEST_VERSION = 1

_CKPT_RE = re.compile(r"^ckpt-(\d{8})$")
_TMP_PREFIX = ".tmp-"
_TMP_RE = re.compile(r"^\.tmp-ckpt-\d{8}-(?P<pid>\d+)-[0-9a-f]+$")

# temp dirs any store in THIS process is actively writing: gc must never
# reap a live in-flight save, and two managers over the same directory
# (explicit + process-default) share this one exclusion set
_ACTIVE_LOCK = threading.Lock()
_ACTIVE_TMP = set()   # guarded-by: _ACTIVE_LOCK


class CheckpointError(MXNetError):
    """A checkpoint could not be written or resolved."""


class IntegrityError(CheckpointError):
    """Stored bytes disagree with the manifest (size or sha256)."""


def _sha256(data):
    return hashlib.sha256(data).hexdigest()


def _shard_file(name, kind="bin", used=None):
    """Array/blob name -> filename: path separators and anything exotic
    flattened so a shard never escapes its checkpoint directory.

    Flattening can collide (``fc1/weight`` vs ``fc1.weight``); when a
    ``used`` set is supplied, a colliding name gets a sha-derived
    disambiguator — the manifest records the final filename, so readers
    never care."""
    base = re.sub(r"[^A-Za-z0-9_.-]", ".", name)
    fname = "%s.%s" % (base, kind)
    if used is not None:
        if fname in used:
            fname = "%s.%s.%s" % (
                base, hashlib.sha256(name.encode()).hexdigest()[:8], kind)
        used.add(fname)
    return fname


def _host_bytes(arr):
    """``(raw bytes, dtype name, shape)`` of a numpy array or a CPU
    tensor; bfloat16 as its 16-bit words under the name "bfloat16".  The
    bytes are a view of a contiguous array (no copy when it already is
    one): hashing and writing them take no second copy of a shard."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return (_byte_view(t.view(torch.int16).numpy()), "bfloat16",
                    list(t.shape))
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return _byte_view(arr), str(arr.dtype), list(arr.shape)


def _byte_view(arr):
    """The bytes of a contiguous numpy array as a flat uint8 view."""
    return arr.reshape(-1).view(np.uint8)


def _from_bytes(data, dtype, shape):
    """Inverse of :func:`_host_bytes`: a numpy array, or a
    ``torch.bfloat16`` tensor for "bfloat16" shards."""
    if dtype == "bfloat16":
        words = np.frombuffer(data, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)


class CheckpointStore:
    """All filesystem knowledge of the checkpoint subsystem: shard and
    manifest encoding, the atomic directory commit, completeness
    resolution, and orphan garbage collection.  Policy (when to save,
    what to keep) lives above, in the manager/retention layer."""

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    # -- naming --------------------------------------------------------------
    def path(self, step):
        return os.path.join(self.root, "ckpt-%08d" % int(step))

    # -- write / commit ------------------------------------------------------
    def write(self, step, arrays, blobs=None, meta=None):
        """Write one checkpoint and atomically commit it; returns the
        committed directory path.

        ``arrays``: ``{name: numpy array or CPU tensor}`` — one raw
        shard each.
        ``blobs``: ``{name: bytes}`` — opaque payloads (optimizer pickle,
        symbol JSON).  On ANY failure the temp directory is left in
        place for :meth:`gc_orphans` — a failed save and a crashed save
        look identical on disk, so recovery is one code path."""
        step = int(step)
        final = self.path(step)
        if os.path.isdir(final):
            raise CheckpointError("checkpoint step %d already committed at %s"
                                  % (step, final))
        tmp = os.path.join(self.root, "%sckpt-%08d-%d-%s" % (
            _TMP_PREFIX, step, os.getpid(), uuid.uuid4().hex[:8]))
        with _ACTIVE_LOCK:
            _ACTIVE_TMP.add(tmp)
        try:
            os.makedirs(tmp)
            manifest = {"format": MANIFEST_FORMAT,
                        "version": MANIFEST_VERSION,
                        "step": step,
                        "meta": dict(meta or {}),
                        "shards": {},
                        "blobs": {}}
            used_names = set()
            for name, arr in arrays.items():
                data, dtype, shape = _host_bytes(arr)
                fname = _shard_file(name, used=used_names)
                with _tracing.span("checkpoint.store.shard_write",
                                   shard=name, step=step), \
                        open(os.path.join(tmp, fname), "wb") as f:
                    f.write(data)
                    # a torn write or ENOSPC while the shard is
                    # still inside .tmp-* — the temp dir must stay
                    # invisible and gc-able, never half-committed
                    if _fault.ACTIVE[0]:
                        _fault.fire("checkpoint.store.shard_write",
                                    file=f, shard=name)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["shards"][name] = {
                    "file": fname, "dtype": dtype,
                    "shape": shape, "bytes": len(data),
                    "sha256": _sha256(data)}
            for name, data in (blobs or {}).items():
                data = bytes(data)
                fname = _shard_file(name, kind="blob", used=used_names)
                with open(os.path.join(tmp, fname), "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["blobs"][name] = {
                    "file": fname, "bytes": len(data),
                    "sha256": _sha256(data)}
            # manifest last: inside the temp dir it is still invisible
            # to readers; its presence after the rename is what makes
            # the directory a checkpoint
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            # a fault here (crash, transient IO error,
            # SIGKILL) lands in the widest window — everything written,
            # nothing committed; recovery must see no ckpt-N and one
            # orphan temp dir
            with _tracing.span("checkpoint.store.commit", step=step):
                if _fault.ACTIVE[0]:
                    _fault.fire("checkpoint.store.commit", step=step,
                                tmp=tmp)
                os.replace(tmp, final)
                self._fsync_root()
            return final
        finally:
            with _ACTIVE_LOCK:
                _ACTIVE_TMP.discard(tmp)

    def _fsync_root(self):
        """Persist the rename itself (the directory entry) so a machine
        crash right after commit cannot un-commit."""
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    # -- resolution ----------------------------------------------------------
    def steps(self):
        """Sorted steps of every COMPLETE checkpoint: a ``ckpt-N``
        directory whose manifest exists and parses.  ``.tmp-*`` dirs —
        in-flight or crashed writes — are invisible here by
        construction."""
        out = []
        for name in os.listdir(self.root):
            m = _CKPT_RE.match(name)
            if not m:
                continue
            try:
                with open(os.path.join(self.root, name, MANIFEST_NAME)) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                continue
            if manifest.get("format") == MANIFEST_FORMAT:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self):
        """Newest complete step, or None."""
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step):
        path = os.path.join(self.path(step), MANIFEST_NAME)
        try:
            # transient manifest-read failures (flaky NFS,
            # mid-rename rack move) — consumers (watcher, restore walk,
            # elastic runner) must retry or fall back, never crash
            with _tracing.span("checkpoint.store.manifest_read",
                               step=int(step)):
                if _fault.ACTIVE[0]:
                    _fault.fire("checkpoint.store.manifest_read",
                                step=step)
                with open(path) as f:
                    return json.load(f)
        except (OSError, ValueError) as exc:
            raise CheckpointError("checkpoint step %d has no readable "
                                  "manifest (%s)" % (int(step), exc))

    def read(self, step, verify=True):
        """Load one checkpoint -> ``(manifest, arrays, blobs)``.

        With ``verify`` every shard/blob is size- and sha256-checked
        against the manifest; a mismatch raises :class:`IntegrityError`
        naming the offending shard."""
        manifest = self.manifest(step)
        base = self.path(step)
        arrays, blobs = {}, {}
        for name, spec in manifest.get("shards", {}).items():
            with open(os.path.join(base, spec["file"]), "rb") as f:
                data = f.read()
            if verify and (len(data) != spec["bytes"]
                           or _sha256(data) != spec["sha256"]):
                raise IntegrityError(
                    "checkpoint step %d shard %r fails verification "
                    "(%d bytes on disk vs %d in manifest)"
                    % (int(step), name, len(data), spec["bytes"]))
            arrays[name] = _from_bytes(data, spec["dtype"], spec["shape"])
        for name, spec in manifest.get("blobs", {}).items():
            with open(os.path.join(base, spec["file"]), "rb") as f:
                data = f.read()
            if verify and (len(data) != spec["bytes"]
                           or _sha256(data) != spec["sha256"]):
                raise IntegrityError(
                    "checkpoint step %d blob %r fails verification"
                    % (int(step), name))
            blobs[name] = data
        return manifest, arrays, blobs

    # -- lifecycle -----------------------------------------------------------
    def delete(self, step):
        shutil.rmtree(self.path(step), ignore_errors=True)

    def gc_orphans(self):
        """Remove ``.tmp-*`` residue of crashed or failed writes; never
        a temp dir a live writer still owns — in-process writers via the
        shared active set (one set for ALL stores, so two managers on
        one directory cannot reap each other's in-flight save), writers
        in OTHER processes on this host via the pid embedded in the
        temp name.  Returns the removed paths."""
        with _ACTIVE_LOCK:
            active = set(_ACTIVE_TMP)
        removed = []
        for name in os.listdir(self.root):
            if not name.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self.root, name)
            if path in active or self._writer_alive(name):
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        if removed:
            logging.info("checkpoint: collected %d orphan temp dir(s) in %s",
                         len(removed), self.root)
        return removed

    @staticmethod
    def _writer_alive(tmp_name):
        """Does the process that owns this temp dir still run (on this
        host)?  Our own pid does not count — our live writes are covered
        exactly by the active set, so anything of ours NOT in it is a
        failed write awaiting collection."""
        m = _TMP_RE.match(tmp_name)
        if not m:
            return False   # unrecognized residue: collect
        pid = int(m.group("pid"))
        if pid == os.getpid():
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except OSError:
            pass   # EPERM: exists under another uid
        return True

    def total_bytes(self, step):
        """Committed payload size of one checkpoint per its manifest."""
        manifest = self.manifest(step)
        return (sum(s["bytes"] for s in manifest.get("shards", {}).values())
                + sum(b["bytes"] for b in manifest.get("blobs", {}).values()))


class RetentionPolicy:
    """keep-last-N / keep-every-K pruning over COMPLETE checkpoints.

    ``keep_last`` most recent steps always survive; additionally any
    step divisible by ``keep_every`` (when > 0) is pinned forever — the
    classic "hourly forever, every-step for the last hour" ladder.  The
    newest complete checkpoint is unconditionally exempt: retention can
    never race a writer into leaving zero restorable state.
    ``keep_last <= 0`` disables pruning entirely."""

    def __init__(self, keep_last=5, keep_every=0):
        self.keep_last = int(keep_last)
        self.keep_every = int(keep_every)

    def victims(self, steps):
        """Which of ``steps`` (sorted ascending) to delete."""
        if not steps or self.keep_last <= 0:
            return []
        keep = set(steps[-self.keep_last:])
        keep.add(steps[-1])
        if self.keep_every > 0:
            keep.update(s for s in steps if s % self.keep_every == 0)
        return [s for s in steps if s not in keep]

    def apply(self, store):
        """Prune ``store`` in place; returns the deleted steps."""
        victims = self.victims(store.steps())
        for step in victims:
            store.delete(step)
        return victims
