"""Model registry — named, versioned, hot-swappable checkpoints
(counterpart of ``mxnet_tpu/serving/registry.py``).

Reference: TF-Serving's servable manager (one name -> many versions,
an aliasable "default" version, load/unload without restarting the
server) over this framework's checkpoint format (``model.save_checkpoint``
prefix convention loaded through the ``Predictor`` path).

A registered version holds the loaded symbol + param NDArrays and the
per-input SAMPLE shapes (the declared shapes minus the batch axis);
the batch axis is owned by the serving layer's shape buckets.  The
registry itself never binds executors — that is the executor cache's
job — so a load is cheap and a hot swap is: ``load()`` the new
version, ``set_default()``, optionally ``unload()`` the old one.

``watch_checkpoints`` closes the train-to-serve loop: a
:class:`CheckpointWatcher` polls a ``checkpoint.CheckpointManager``
directory and registers each newly committed checkpoint, its parameters
read onto the server's device (or ``ctx``).
"""
from __future__ import annotations

import logging
import threading

from .errors import BadRequest, ModelNotFound

__all__ = ["ModelVersion", "ModelRegistry", "CheckpointWatcher"]


class ModelVersion:
    """One immutable loaded checkpoint: symbol, params, input signature."""

    __slots__ = ("name", "version", "symbol", "arg_params", "aux_params",
                 "sample_shapes", "input_names", "num_outputs",
                 "_symbol_sha")

    def __init__(self, name, version, symbol, arg_params, aux_params,
                 input_shapes):
        self.name = name
        self.version = int(version)
        self.symbol = symbol
        self.arg_params = dict(arg_params or {})
        self.aux_params = dict(aux_params or {})
        if not input_shapes:
            raise BadRequest(
                "model %r needs at least one declared input" % (name,))
        self.sample_shapes = {}
        for k, shp in input_shapes.items():
            shp = tuple(int(d) for d in shp)
            if len(shp) < 1:
                raise BadRequest(
                    "input %r of model %r needs a batch axis; got shape %r"
                    % (k, name, shp))
            self.sample_shapes[k] = shp[1:]
        self.input_names = list(self.sample_shapes)
        self.num_outputs = len(symbol.list_outputs())
        self._symbol_sha = None

    @property
    def symbol_sha(self):
        """sha256 of the symbol JSON — the PROGRAM identity the warmup
        manifest keys on: two versions of the same architecture share it
        (weights are runtime inputs, not part of the program)."""
        if self._symbol_sha is None:
            import hashlib
            self._symbol_sha = hashlib.sha256(
                self.symbol.tojson().encode("utf-8")).hexdigest()
        return self._symbol_sha

    def full_shapes(self, batch):
        """Declared input shapes with the batch axis set to ``batch``."""
        return {k: (int(batch),) + s for k, s in self.sample_shapes.items()}


class ModelRegistry:
    """Thread-safe name -> {version -> ModelVersion} store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models = {}      # guarded-by: _lock — name -> {version: entry}
        self._default = {}     # guarded-by: _lock — name -> version

    # -- registration -------------------------------------------------------
    def load(self, name, symbol_file, param_file, input_shapes,
             version=None, ctx=None):
        """Load a checkpoint (path or in-memory JSON/bytes, exactly the
        ``Predictor`` contract) under ``name``, the parameters on ``ctx``
        (default the current context); returns the version number
        (auto-incremented when not given)."""
        from ..predictor import _load_params, _load_symbol
        sym = _load_symbol(symbol_file)
        arg_params, aux_params = _load_params(param_file, ctx)
        return self.add(name, sym, arg_params, aux_params, input_shapes,
                        version=version)

    def add(self, name, symbol, arg_params, aux_params, input_shapes,
            version=None):
        """Register an already-loaded symbol + params (the programmatic
        path ``Module.export_serving`` uses).  The FIRST registered
        version of a name becomes its default; later versions only
        serve once ``set_default`` promotes them (hot swap is an
        explicit, atomic step, not a side effect of loading)."""
        with self._lock:
            versions = self._models.setdefault(name, {})
            if version is None:
                version = max(versions) + 1 if versions else 1
            version = int(version)
            if version in versions:
                raise BadRequest("model %r version %d already registered"
                                 % (name, version))
            versions[version] = ModelVersion(
                name, version, symbol, arg_params, aux_params, input_shapes)
            self._default.setdefault(name, version)
            return version

    def set_default(self, name, version):
        """Promote ``version`` to what unversioned requests resolve to."""
        with self._lock:
            if name not in self._models or \
                    int(version) not in self._models[name]:
                raise ModelNotFound("model %r version %r is not registered"
                                    % (name, version))
            self._default[name] = int(version)

    def unload(self, name, version=None):
        """Drop one version (or the whole model when version is None)."""
        with self._lock:
            if name not in self._models:
                raise ModelNotFound("model %r is not registered" % (name,))
            if version is None:
                del self._models[name]
                del self._default[name]
                return
            version = int(version)
            versions = self._models[name]
            if version not in versions:
                raise ModelNotFound("model %r version %d is not registered"
                                    % (name, version))
            del versions[version]
            if not versions:
                del self._models[name]
                del self._default[name]
            elif self._default[name] == version:
                self._default[name] = max(versions)

    # -- lookup -------------------------------------------------------------
    def get(self, name, version=None):
        """Resolve (name, version) -> ModelVersion; None version means
        the current default.  Raises ModelNotFound."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFound("model %r is not registered" % (name,))
            if version is None:
                version = self._default[name]
            entry = versions.get(int(version))
            if entry is None:
                raise ModelNotFound("model %r version %r is not registered"
                                    % (name, version))
            return entry

    def describe(self):
        """Snapshot for the /stats surface: name -> versions + default."""
        with self._lock:
            return {name: {"versions": sorted(vs),
                           "default": self._default[name]}
                    for name, vs in self._models.items()}

    # -- checkpoint hot-swap -------------------------------------------------
    def watch_checkpoints(self, directory, name, poll_interval=None,
                          set_default=True, start=True, server=None,
                          ctx=None):
        """Hot-swap committed training checkpoints into this registry —
        the train→serve loop closed: as ``checkpoint.CheckpointManager``
        commits new versions into ``directory``, a watcher registers
        each (version = checkpoint step id) and promotes it to the
        serving default.  With ``server`` (a ModelServer), the new
        version is WARMED before promotion — its bucket predictors bound
        (manifest-recorded buckets when available, the server's ladder
        otherwise) and each bucket's first forward run, so the swap never
        exposes live traffic to a cold bucket.  The parameters land on the
        server's device, or without a server on ``ctx`` (default the
        current context).  Returns the :class:`CheckpointWatcher`; call
        ``stop()`` (or use it as a context manager) to end the watch,
        ``poll_once()`` to drive it manually (``start=False``)."""
        return CheckpointWatcher(self, directory, name,
                                 poll_interval=poll_interval,
                                 set_default=set_default, start=start,
                                 server=server, ctx=ctx)


class CheckpointWatcher:
    """Background poller binding a checkpoint directory to a registry
    name.

    Relies on the checkpoint store's commit atomicity: a directory that
    ``latest()`` resolves is complete by construction, so the watcher
    can read it with no coordination with the (possibly remote) trainer
    process.  Checkpoints without a symbol or bound input shapes (saved
    from an unbound module) are skipped with a warning."""

    def __init__(self, registry, directory, name, poll_interval=None,
                 set_default=True, start=True, server=None, ctx=None):
        from ..checkpoint import CheckpointStore
        from ..context import resolve
        from ..fault.backoff import BackoffPolicy
        if poll_interval is None:
            from .. import config as _config
            poll_interval = _config.get("MXNET_CKPT_WATCH_INTERVAL_S")
        self.registry = registry
        self.server = server
        self.device = server.device if server is not None else resolve(ctx)
        self.name = name
        self.poll_interval = float(poll_interval)
        self.set_default = bool(set_default)
        # transient-read retries ride the SHARED backoff policy
        # (fault/backoff.py) instead of the old retry-next-poll-only
        # loop: a flaky read usually clears in milliseconds, and a
        # finished run's final checkpoint should not wait a whole poll
        # interval per hiccup.  Delays stay well inside one poll.
        base = min(0.1, max(self.poll_interval / 20.0, 0.005))
        self._read_backoff = BackoffPolicy(
            retries=2, base_s=base, max_s=max(base, self.poll_interval / 4.0))
        self._store = CheckpointStore(directory)
        self._last_step = 0
        self._stop = threading.Event()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="ckpt-watch-%s" % name, daemon=True)
            self._thread.start()

    def poll_once(self):
        """Check for a newer complete checkpoint; load + register +
        (optionally) promote it.  Returns the newly served version, or
        None when nothing new (or the newest checkpoint is unservable)."""
        from ..checkpoint import CheckpointError, IntegrityError, TrainState
        from ..checkpoint.state import _to_nd
        from ..fault import hooks as _fault
        from ..telemetry import tracing as _tracing
        from ..symbol import load_json
        # a poll-time fault must leave the watcher alive and
        # the CURRENT serving default untouched (worker_scope in _loop
        # logs it; a transient read below retries on the shared backoff)
        with _tracing.span("checkpoint.watcher.poll", model=self.name):
            if _fault.ACTIVE[0]:
                _fault.fire("checkpoint.watcher.poll", name=self.name)
            step = self._store.latest()
        if step is None or step <= self._last_step:
            return None
        try:
            manifest, arrays, blobs = self._read_backoff.call(
                lambda: self._store.read(step, verify=True),
                retry_on=(OSError, ValueError, CheckpointError),
                abort_on=(IntegrityError,),
                on_retry=lambda exc, attempt: logging.info(
                    "checkpoint watcher %r: step %d read failed (%s); "
                    "backoff retry %d", self.name, step, exc, attempt + 1))
        except IntegrityError as exc:
            # permanent (bit rot): one attempt per committed version
            self._last_step = step
            logging.warning("checkpoint watcher %r: step %d corrupt (%s); "
                            "skipped", self.name, step, exc)
            return None
        except (OSError, ValueError, CheckpointError) as exc:
            # still failing past the in-poll backoff budget: leave
            # _last_step so the NEXT poll retries — the final checkpoint
            # of a finished run must not be skippable forever
            logging.warning("checkpoint watcher %r: step %d unreadable "
                            "(%s); will retry", self.name, step, exc)
            return None
        self._last_step = step
        state = TrainState.from_payload(arrays, blobs,
                                        manifest.get("meta", {}))
        input_shapes = state.meta.get("input_shapes")
        if not state.symbol_json or not input_shapes:
            logging.warning(
                "checkpoint watcher %r: step %d lacks symbol/input shapes "
                "(saved from an unbound module?); not servable",
                self.name, step)
            return None
        symbol = load_json(state.symbol_json)
        args = {k: _to_nd(v, self.device)
                for k, v in state.arg_params.items()}
        auxs = {k: _to_nd(v, self.device)
                for k, v in state.aux_params.items()}
        try:
            self.registry.add(self.name, symbol, args, auxs,
                              {k: tuple(v) for k, v in input_shapes.items()},
                              version=step)
        except BadRequest:
            pass   # another watcher won the race; still promote below
        if self.server is not None:
            # pre-warm THEN promote: bind the new version's bucket
            # predictors and run each bucket's first forward before any
            # live traffic can resolve to it.  Failures are logged and
            # promotion proceeds: a version that cannot warm binds
            # lazily — blocking the swap would pin traffic to stale
            # weights
            try:
                self.server.warmup_version(self.name, step)
            except Exception as exc:   # noqa: BLE001 — logged, promoted
                logging.warning(
                    "checkpoint watcher %r: warmup of version %d failed "
                    "(%s: %s); promoting anyway (lazy bind)",
                    self.name, step, type(exc).__name__, exc)
        if self.set_default:
            if self.server is not None:
                # staged promotion: with a canary fraction configured
                # the new version receives only that fraction of
                # traffic until the server's health gate (error rate,
                # p99 vs baseline, non-finite sentinel) promotes it —
                # or rolls it back, leaving the CURRENT default
                # serving.  Fraction 0 (default) is a direct
                # set_default.
                self.server.promote_version(self.name, step)
            else:
                self.registry.set_default(self.name, step)
        logging.info("checkpoint watcher %r: now serving version %d "
                     "(staged=%s)", self.name, step,
                     self.server is not None and self.set_default)
        return step

    def _loop(self):
        from .. import engine
        while not self._stop.is_set():
            # errors are logged, never fatal: the watcher must outlive a
            # transiently unreadable filesystem
            with engine.worker_scope(deliver=self._log_error):
                self.poll_once()
            if self.server is not None:
                # time-based canary gates (budget timeout) must fire
                # even when the model gets no traffic at all
                self.server.tick_canaries()
            self._stop.wait(self.poll_interval)

    def _log_error(self, exc):
        logging.warning("checkpoint watcher %r: poll failed (%s: %s)",
                        self.name, type(exc).__name__, exc)
        return True

    @property
    def last_step(self):
        return self._last_step

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.stop()
