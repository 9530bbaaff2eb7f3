"""Crash-safe single-file writes: write to a temp file, then ``os.replace``.

Counterpart of ``mxnet_tpu/_atomic_io.py``.  A file written in place is,
for the whole write, a readable but corrupt file at its final name: a
trainer killed between two ``write()`` calls would leave a truncated
``.params`` container that ``nd.load`` opens and fails in halfway.  So
every persistence path (``nd.save``, ``Symbol.save``, the optimizer-state
files) writes through here: the bytes land in a hidden sibling temp file,
are flushed and fsync'd, and only then renamed over the target.  A crash
at any point leaves the old complete file or the new complete file.

While tracing is on, each commit (flush, fsync, rename) is an
``atomic_io.commit`` span; under an armed fault plan the commit is the
``atomic_io.commit`` site, where a torn write truncates the temp file
and fails the save with the target untouched.
"""
from __future__ import annotations

import contextlib
import os
import sys
import uuid

from .fault import hooks as _fault

__all__ = ["atomic_writer", "atomic_write"]


def _span(name, **tags):
    """A tracing span without importing telemetry: this module stays a
    leaf, and tracing can only be on after someone imported it, so an
    absent module means a no-op."""
    tracing = sys.modules.get(__package__ + ".telemetry.tracing")
    if tracing is None or not tracing.ACTIVE[0]:
        return contextlib.nullcontext()
    return tracing.span(name, **tags)


def _temp_name(path):
    """A hidden sibling of ``path``: the same directory, so ``os.replace``
    is a same-filesystem rename; unique, so two writers of one target
    never share a temp file."""
    head, tail = os.path.split(path)
    return os.path.join(head, ".%s.tmp-%d-%s"
                        % (tail, os.getpid(), uuid.uuid4().hex[:8]))


@contextlib.contextmanager
def atomic_writer(path, mode="wb"):
    """Yield a file object whose contents appear at ``path`` only on a
    clean exit (flush, fsync, ``os.replace``); on an exception the temp
    file is removed and ``path`` is left as it was."""
    tmp = _temp_name(path)
    f = open(tmp, mode)
    committed = False
    try:
        yield f
        with _span("atomic_io.commit", path=path):
            if _fault.ACTIVE[0]:
                _fault.fire("atomic_io.commit", file=f, path=path)
            f.flush()
            os.fsync(f.fileno())
            f.close()
            os.replace(tmp, path)
        committed = True
    finally:
        if not committed:
            if not f.closed:
                f.close()
            with contextlib.suppress(OSError):
                os.remove(tmp)


def atomic_write(path, data, mode="wb"):
    """Write ``data`` to ``path`` atomically (see :func:`atomic_writer`)."""
    with atomic_writer(path, mode) as f:
        f.write(data)
