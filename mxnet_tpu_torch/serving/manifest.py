"""Warmup manifest — the executor cache's key set, persisted
(counterpart of ``mxnet_tpu/serving/manifest.py``; the file format is
the same).

The compile cache (``mxnet_tpu_torch.compile_cache``) keeps the kernel
libraries built; this manifest remembers *which* forwards a serving
replica needs: every (model, symbol sha256, shape bucket, dtype,
backend) the ``ExecutorCache`` ever bound.  A restarted replica replays
the manifest (``ModelServer.warmup_from_manifest``) so its warmup binds
exactly last run's working set and runs each bucket's first forward —
where cuDNN picks its engines for that shape — before live traffic.

The backend is ``"gpu"`` for a server on the card and ``"cpu"``
otherwise; a restarted server replays only its own backend's entries, so
a manifest written by the JAX package on a TPU (backend ``"tpu"``)
replays nothing here.

The key deliberately hashes the SYMBOL, not the weights: a hot-swapped
checkpoint version of the same architecture produces the same program,
so the manifest (and the disk cache behind it) stays valid across
``CheckpointWatcher`` promotions — that is what makes pre-warm-then-
promote cheap.

Commits reuse ``_atomic_io.atomic_write``: a crash mid-write leaves
the previous complete manifest, never a torn one.  Reads of a corrupt
or foreign file degrade to an empty manifest with a warning — warmup
then falls back to the full bucket ladder, it never crashes.
"""
from __future__ import annotations

import json
import logging
import os
import threading

from .._atomic_io import atomic_write

__all__ = ["WarmupManifest"]

_SCHEMA = 1


def _default_backend():
    import torch
    return "gpu" if torch.cuda.is_available() else "cpu"


class WarmupManifest:
    """Atomically-committed record of the serving executor key set."""

    def __init__(self, path):
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        self._entries = {}     # key -> entry dict   guarded-by: _lock
        self._loaded = False   # guarded-by: _lock
        self._load_locked_deferred()

    def _load_locked_deferred(self):
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
            try:
                with open(self.path, encoding="utf-8") as f:
                    doc = json.load(f)
                entries = doc["entries"] if isinstance(doc, dict) \
                    and doc.get("schema") == _SCHEMA else []
                for e in entries:
                    self._entries[self._key(e)] = dict(e)
            except FileNotFoundError:
                pass            # first run: manifest grows from empty
            except (OSError, ValueError, KeyError, TypeError) as exc:
                logging.warning(
                    "warmup manifest %r unreadable (%s); starting empty — "
                    "warmup falls back to the full bucket ladder",
                    self.path, exc)

    @staticmethod
    def _bucket(value):
        """Bucket keys mirror the executor cache's: an int batch rung,
        or an int tuple for the generative prefill grid's (batch,
        length) cells (serialized as a JSON list)."""
        if isinstance(value, (tuple, list)):
            return tuple(int(v) for v in value)
        return int(value)

    @classmethod
    def _key(cls, entry):
        return (entry["model"], entry["symbol_sha256"],
                cls._bucket(entry["bucket"]),
                entry.get("dtype", "float32"), entry.get("backend", ""))

    def record(self, entry, bucket, backend=None, dtype="float32"):
        """Add one executor-cache key (``entry`` is a ModelVersion);
        commits the file only when the key is new.  Returns whether it
        was."""
        if backend is None:
            backend = _default_backend()
        bucket = self._bucket(bucket)
        rec = {
            "model": entry.name,
            "version": entry.version,
            "symbol_sha256": entry.symbol_sha,
            "bucket": list(bucket) if isinstance(bucket, tuple)
                      else bucket,
            "batch": bucket[0] if isinstance(bucket, tuple) else bucket,
            "dtype": dtype,
            "backend": backend,
            "sample_shapes": {k: list(s)
                              for k, s in entry.sample_shapes.items()},
        }
        key = self._key(rec)
        with self._lock:
            known = self._entries.get(key)
            if known is not None:
                if known.get("version") == rec["version"]:
                    return False
                known["version"] = rec["version"]   # refresh info only
            else:
                self._entries[key] = rec
            self._commit_locked()
        return known is None

    def _commit_locked(self):
        doc = {"schema": _SCHEMA,
               "entries": sorted(
                   self._entries.values(),
                   key=lambda e: (e["model"], self._sort_bucket(e["bucket"]),
                                  e["backend"]))}
        try:
            atomic_write(self.path,
                         json.dumps(doc, indent=1).encode("utf-8"))
        except OSError as exc:
            logging.warning("warmup manifest %r not writable (%s); keys "
                            "recorded in memory only", self.path, exc)

    def entries(self):
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    @classmethod
    def _sort_bucket(cls, value):
        """Total order over mixed bucket kinds: int rungs first, then
        grid cells, each in natural order."""
        b = cls._bucket(value)
        return (1, b) if isinstance(b, tuple) else (0, (b,))

    def buckets_for(self, name, symbol_sha, backend=None):
        """Sorted INT buckets recorded for this (model name, program) —
        what a restarted replica should warm.  ``backend`` narrows to
        entries recorded on that backend (None accepts any; the server
        passes its own).  Generative (batch, length) grid cells
        live in :meth:`grid_for`."""
        with self._lock:
            return sorted({self._bucket(e["bucket"])
                           for e in self._entries.values()
                           if e["model"] == name
                           and e["symbol_sha256"] == symbol_sha
                           and not isinstance(e["bucket"], (tuple, list))
                           and (backend is None
                                or e["backend"] == backend)})

    def grid_for(self, name, symbol_sha, backend=None):
        """Sorted (batch, length) grid cells recorded for this (model
        name, program) — the prefill working set a restarted generative
        replica should warm."""
        with self._lock:
            return sorted({self._bucket(e["bucket"])
                           for e in self._entries.values()
                           if e["model"] == name
                           and e["symbol_sha256"] == symbol_sha
                           and isinstance(e["bucket"], (tuple, list))
                           and (backend is None
                                or e["backend"] == backend)})

    def ladders(self):
        """Every recorded INT working set as a ladder:
        ``{"model@sha12": sorted buckets}`` — the graftplan feed
        (``ModelServer.plan_spec``), so bucket-plan-waste judges the
        ladders a restarted replica will actually warm, not just the
        configured default.  Grid cells are the generative working set,
        reported separately by :meth:`grid_ladders`."""
        with self._lock:
            out = {}
            for e in self._entries.values():
                if isinstance(e["bucket"], (tuple, list)):
                    continue
                key = "%s@%s" % (e["model"],
                                 str(e["symbol_sha256"])[:12])
                out.setdefault(key, set()).add(int(e["bucket"]))
        return {k: sorted(v) for k, v in sorted(out.items())}

    def grid_ladders(self):
        """Every recorded (batch, length) working set:
        ``{"model@sha12": sorted [batch, length] cells}`` — the
        generative counterpart of :meth:`ladders`, judged by the plan
        checkers' generative economics pass."""
        with self._lock:
            out = {}
            for e in self._entries.values():
                if not isinstance(e["bucket"], (tuple, list)):
                    continue
                key = "%s@%s" % (e["model"],
                                 str(e["symbol_sha256"])[:12])
                out.setdefault(key, set()).add(self._bucket(e["bucket"]))
        return {k: [list(c) for c in sorted(v)]
                for k, v in sorted(out.items())}

    def __len__(self):
        with self._lock:
            return len(self._entries)
