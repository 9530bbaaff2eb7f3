"""SpoolTransport — the message seam between processes that faults can bite.

Counterpart of ``mxnet_tpu/parallel/transport.py`` (reference precedent:
the MXNet parameter server, arxiv 1512.01274, treats worker/server
communication as lossy; the TensorFlow paper, arxiv 1605.08695 §4.3,
designs for hosts dying mid-send).  One small message transport with
NAMED INJECTION SITES, so an armed :class:`~..fault.FaultPlan` can
partition, slow, lose the ack of or reorder a link exactly when a drill
says so, per (site, peer) through the plan's ``where`` matching on the
``peer`` key.  The dist_async push spool (``kvstore.KVStoreDistAsync``)
and the fleet front door (``serving.fleet``) ride it.

Framing is the JAX package's, byte for byte in layout, so a message one
package writes is read by the other:

- each rank owns an inbox directory under a shared root (``inbox-%03d``
  unless the caller maps ranks to other names);
- a message is one ``.npz`` file named
  ``<ms>-<sender>-<epoch>-<seq>-<kind>.npz`` (arrival-ordered scan; the
  epoch keeps a respawned sender's frames from colliding with its dead
  predecessor's), its header a JSON string under ``_meta`` and its
  arrays numpy arrays under their names;
- writes go to a ``.``-prefixed ``*.tmp.npz`` temp the scan filters out,
  then ``os.replace`` publishes atomically, so no reader sees a torn
  message;
- an optional exact capacity per inbox is kept by ``fcntl.flock``
  admission (the kernel releases the lock when a holder dies).

Arrays cross the spool as numpy: a torch tensor (or an ``NDArray``) is
copied to the host once, at ``send``; ``recv`` hands numpy arrays back.

Delivery: :meth:`SpoolTransport.send` is ONE attempt (at-most-once).
:meth:`SpoolTransport.send_reliable` retries ``ConnectionError`` and
``OSError`` on a :class:`~..fault.BackoffPolicy` under the SAME message
id, and :meth:`SpoolTransport.recv` drops duplicate ids: exactly-once on
top of a lossy link, which is what the ``lost_ack`` fault kind drills.

Injection sites: ``transport.send`` (pre-publish: ``partition`` drops,
``slow_link`` delays, ``reorder`` swaps with the next send),
``transport.send.ack`` (post-publish: ``lost_ack``) and
``transport.recv`` (per received message; a raise leaves it spooled for
the next poll).
"""
from __future__ import annotations

import contextlib
import errno
import json
import os
import threading
import time
import zipfile
import zlib

import numpy as np

from ..fault import hooks as _fault
from ..fault.plan import Reorder
from ..telemetry import tracing as _trace

__all__ = ["InboxFull", "Message", "SpoolTransport"]


class InboxFull(ConnectionError):
    """Destination inbox pinned at capacity past the backpressure
    timeout.  A ``ConnectionError`` (callers treating the link as lossy
    stay correct), but :meth:`SpoolTransport.send_reliable` does NOT
    retry it: admission already blocked for the full timeout, and a
    receiver that far behind is dead, not slow."""


def _san(s):
    """Filesystem-safe token (the kvstore spool's encoding)."""
    s = str(s)
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in s)
    return "%s-%08x" % (safe, zlib.crc32(s.encode()))


def _now_ms():
    return int(time.time() * 1000)


def _host(a):
    """A payload array as numpy: a torch tensor or an NDArray is copied
    to the host once, here."""
    data = getattr(a, "_data", a)
    if hasattr(data, "detach"):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class Message:
    """One delivered message: ``sender``/``epoch``/``seq`` (the dedup
    id; ``epoch`` tells a restarted sender's fresh seq counter from its
    dead predecessor's), ``kind`` (routing tag), ``meta`` (JSON-able
    dict), ``arrays`` (name -> numpy array payload)."""

    __slots__ = ("sender", "seq", "kind", "meta", "arrays", "epoch")

    def __init__(self, sender, seq, kind, meta, arrays, epoch=0):
        self.sender = int(sender)
        self.seq = int(seq)
        self.kind = str(kind)
        self.meta = meta
        self.arrays = arrays
        self.epoch = int(epoch)

    def __repr__(self):
        return "Message(%d:%d %s %s)" % (self.sender, self.seq,
                                         self.kind, sorted(self.arrays))


class SpoolTransport:
    """Spool-backed point-to-point transport over a shared directory.

    ``root`` is the shared directory (one per fleet); ``rank`` this
    process's address, ``world`` the fleet size.  ``inbox`` maps a rank
    to its inbox directory name (default ``inbox-%03d``; the kvstore
    maps its coordinator to ``push``).  ``cap``/``admit_timeout`` bound a
    DESTINATION inbox exactly (the flock admission); ``cap=None``
    disables backpressure.  ``epoch`` defaults to the pid."""

    def __init__(self, root, rank, world, cap=None, admit_timeout=None,
                 inbox=None, send_retries=None, backoff=None, epoch=None):
        from .. import config as _config
        self.root = str(root)
        self.rank = int(rank)
        self.world = int(world)
        # incarnation nonce: a respawned rank restarts its seq counter at
        # 1, which must NOT dedup against its dead predecessor's messages
        self.epoch = int(os.getpid() if epoch is None else epoch)
        self.cap = int(cap) if cap else 0
        self.admit_timeout = float(
            admit_timeout if admit_timeout is not None else
            _config.get("MXNET_KVSTORE_ASYNC_BACKPRESSURE_TIMEOUT"))
        self._inbox_name = inbox or (lambda r: "inbox-%03d" % r)
        self._send_retries = int(
            _config.get("MXNET_TRANSPORT_SEND_RETRIES")
            if send_retries is None else send_retries)
        self._poll_s = float(_config.get("MXNET_TRANSPORT_POLL_S"))
        if backoff is None:
            from ..fault.backoff import BackoffPolicy
            # millisecond-scale link retries; the seed derives from the
            # armed plan's chain when a drill runs
            backoff = BackoffPolicy(base_s=0.002, max_s=0.05)
        self._backoff = backoff
        self._lock = threading.Lock()
        self._seq = 0
        self._seen = {}      # guarded-by: _lock — (sender, epoch) -> seqs
        self._held = {}      # guarded-by: _lock — peer -> [parked sends]
        self._stats = {"sent": 0, "resent": 0, "received": 0,
                       "duplicates_dropped": 0, "reordered": 0,
                       "send_failures": 0}
        os.makedirs(self.inbox_dir(self.rank), exist_ok=True)

    # -- layout --------------------------------------------------------------
    def inbox_dir(self, rank):
        return os.path.join(self.root, self._inbox_name(int(rank)))

    def _spool_files(self, rank):
        """Completed message files in arrival order (temp names are
        dot-prefixed ``.tmp.npz``)."""
        try:
            return sorted(n for n in os.listdir(self.inbox_dir(rank))
                          if n.endswith(".npz")
                          and not n.startswith(".")
                          and not n.endswith(".tmp.npz"))
        except OSError:
            return []

    def pending(self, rank=None):
        """Undelivered message count in ``rank``'s inbox (default: own)."""
        return len(self._spool_files(self.rank if rank is None else rank))

    def stats(self):
        with self._lock:
            return dict(self._stats)

    # -- send ----------------------------------------------------------------
    def next_seq(self):
        with self._lock:
            self._seq += 1
            return self._seq

    def send(self, peer, kind, meta=None, arrays=None, _seq=None,
             _fresh=False):
        """ONE delivery attempt (at-most-once); returns the message seq.

        Raises ``ConnectionError`` when the link faults (``partition``
        before delivery, ``lost_ack`` after it; the caller cannot tell
        which).  A ``reorder`` fault parks the message and delivers it
        after this sender's NEXT send to the same peer."""
        seq = self.next_seq() if _seq is None else int(_seq)
        if _seq is not None and not _fresh:
            with self._lock:
                self._stats["resent"] += 1
        record = (peer, kind, dict(meta or {}),
                  {k: _host(v) for k, v in (arrays or {}).items()}, seq)
        # the frame carries the sender's trace context (the "_trace"
        # header), so the receiving process stitches its spans into it
        _trace.inject(record[2])
        with _trace.span("transport.send", peer=str(peer), kind=kind,
                         seq=seq) as _sp:
            try:
                if _fault.ACTIVE[0]:
                    _fault.fire("transport.send", peer=str(peer),
                                kind=kind, sender=self.rank, seq=seq)
            except Reorder:
                with self._lock:
                    self._held.setdefault(int(peer), []).append(record)
                    self._stats["reordered"] += 1
                _sp.tag(reordered=True)
                return seq
            except ConnectionError:
                with self._lock:
                    self._stats["send_failures"] += 1
                raise
            self._publish(record)
            with self._lock:
                self._stats["sent"] += 1
                held = self._held.pop(int(peer), [])
            # adjacent swap: a parked message goes out right AFTER the
            # one that overtook it, stamped strictly later, or the
            # receiver's (ms, sender, seq) sort would undo the swap
            late = _now_ms() + 1
            for i, rec in enumerate(held):
                self._publish(rec, ms=late + i)
                with self._lock:
                    self._stats["sent"] += 1
            try:
                if _fault.ACTIVE[0]:
                    _fault.fire("transport.send.ack", peer=str(peer),
                                kind=kind, sender=self.rank, seq=seq)
            except ConnectionError:
                with self._lock:
                    self._stats["send_failures"] += 1
                raise
            return seq

    def send_reliable(self, peer, kind, meta=None, arrays=None,
                      retries=None):
        """At-least-once send: retries link faults on the shared
        :class:`~..fault.BackoffPolicy` under ONE message id, so the
        receiver's dedup makes delivery exactly-once.  The final failure
        propagates (``ConnectionError``)."""
        seq = self.next_seq()
        budget = self._send_retries if retries is None else int(retries)
        # the host copy happens once, not once an attempt
        arrays = {k: _host(v) for k, v in (arrays or {}).items()}
        state = {"first": True}

        def _attempt():
            fresh, state["first"] = state["first"], False
            return self.send(peer, kind, meta=meta, arrays=arrays,
                             _seq=seq, _fresh=fresh)

        return self._backoff.call(
            _attempt, retry_on=(ConnectionError, OSError),
            abort_on=(InboxFull,), retries=budget)

    def flush_held(self):
        """Deliver every parked (reordered) message: the drain and
        shutdown path, so a reorder fault on the LAST message cannot
        lose it."""
        with self._lock:
            held = self._held
            self._held = {}
        for recs in held.values():
            for rec in recs:
                self._publish(rec)
                with self._lock:
                    self._stats["sent"] += 1

    def _publish(self, record, ms=None):
        """Write and atomically publish one message file under the
        destination's exact capacity.  ``ms`` overrides the arrival-order
        timestamp (the reorder path stamps parked messages late)."""
        peer, kind, meta, arrays, seq = record
        dest = self.inbox_dir(peer)
        os.makedirs(dest, exist_ok=True)
        header = dict(meta)
        header.update({"sender": self.rank, "seq": seq, "kind": kind,
                       "epoch": self.epoch})
        # the epoch is part of the name: two incarnations publishing the
        # same (ms, rank, seq, kind) would otherwise share one file
        name = "%013d-%03d-%07d-%06d-%s" % (
            _now_ms() if ms is None else ms, self.rank, self.epoch,
            seq, _san(kind))
        tmp = os.path.join(dest, "." + name + ".tmp")
        np.savez(tmp, _meta=np.str_(json.dumps(header)), **arrays)
        try:
            self._admit(peer, tmp + ".npz",
                        os.path.join(dest, name + ".npz"))
        except Exception:
            try:
                os.unlink(tmp + ".npz")
            except OSError:
                pass
            raise

    def _admit_lock(self, peer, deadline):
        """flock admission lock on the destination inbox (released by the
        kernel when its holder dies, so the cap stays exact)."""
        import fcntl
        lock_path = os.path.join(self.inbox_dir(peer), ".spool.lock")

        @contextlib.contextmanager
        def _held():
            fd = os.open(lock_path, os.O_CREAT | os.O_WRONLY)
            try:
                while True:
                    try:
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except OSError:
                        if time.time() > deadline:
                            raise InboxFull(
                                "transport: inbox lock held past the "
                                "backpressure timeout")
                        time.sleep(0.002)
                try:
                    yield
                finally:
                    fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

        return _held()

    def _admit(self, peer, tmp, final):
        if not self.cap:
            os.replace(tmp, final)
            return
        deadline = time.time() + self.admit_timeout
        while True:
            with self._admit_lock(peer, deadline):
                if len(self._spool_files(peer)) < self.cap:
                    os.replace(tmp, final)
                    return
            if time.time() > deadline:
                raise InboxFull(
                    "transport: inbox for rank %s held %d pending "
                    "messages past the backpressure timeout — is the "
                    "receiver alive?" % (peer, self.pending(peer)))
            time.sleep(0.005)

    # -- recv ----------------------------------------------------------------
    def recv(self, max_messages=0):
        """Drain the own inbox: new messages in arrival order, duplicate
        ids dropped (and deleted).  A message whose ``transport.recv``
        site raises stays spooled for the next poll."""
        out = []
        for name in self._spool_files(self.rank):
            if max_messages and len(out) >= max_messages:
                break
            path = os.path.join(self.inbox_dir(self.rank), name)
            try:
                with np.load(path, allow_pickle=False) as z:
                    header = json.loads(str(z["_meta"]))
                    arrays = {k: z[k] for k in z.files if k != "_meta"}
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile):
                continue  # partially written; the next scan gets it
            sender, seq = int(header.pop("sender")), int(header.pop("seq"))
            kind = str(header.pop("kind"))
            incarnation = (sender, int(header.pop("epoch", 0)))
            with self._lock:
                dup = seq in self._seen.setdefault(incarnation, set())
            if dup:
                with self._lock:
                    self._stats["duplicates_dropped"] += 1
                self._remove(path)
                continue
            # the delivery span's parent is the SENDER's context (the
            # frame's "_trace" header): the cross-process stitch
            with _trace.span("transport.recv", ctx=_trace.extract(header),
                             peer=str(sender), kind=kind, seq=seq) as _sp:
                try:
                    if _fault.ACTIVE[0]:
                        _fault.fire("transport.recv", peer=str(sender),
                                    kind=kind, seq=seq)
                except Reorder:
                    # skipped THIS scan: later arrivals overtake it
                    with self._lock:
                        self._stats["reordered"] += 1
                    _sp.tag(reordered=True)
                    continue
                except ConnectionError:
                    # receive-side partition: end this poll; the rest
                    # stays spooled
                    _sp.tag(partition=True)
                    break
                with self._lock:
                    self._seen[incarnation].add(seq)
                    self._stats["received"] += 1
                self._remove(path)
                out.append(Message(sender, seq, kind, header, arrays,
                                   epoch=incarnation[1]))
        return out

    def recv_wait(self, timeout_s=5.0, max_messages=0, poll_s=None):
        """Poll :meth:`recv` until at least one message or the timeout;
        returns a possibly empty list."""
        poll_s = self._poll_s if poll_s is None else float(poll_s)
        deadline = time.monotonic() + float(timeout_s)
        while True:
            msgs = self.recv(max_messages=max_messages)
            if msgs or time.monotonic() >= deadline:
                return msgs
            time.sleep(poll_s)

    @staticmethod
    def _remove(path):
        try:
            os.remove(path)
        except OSError as exc:
            if exc.errno != errno.ENOENT:
                pass  # shared-fs hiccup; dedup absorbs a re-scan

    def close(self):
        self.flush_held()
