"""Monitor — per-op output statistics during training.

Counterpart of ``mxnet_tpu/monitor.py`` (reference: python/mxnet/
monitor.py): the executor's monitor callback (graph_executor.cc:121,
1444) hands over node outputs, ``stat_func(output)`` is collected for
every node whose name matches ``pattern``, and the batch of stats is
printed at ``toc_print``.  The port's graph runs eagerly, so the tap is
each node's output as the executor's graph function computes it
(``Executor.set_monitor_callback``), with no second program.
"""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray

__all__ = ["Monitor"]


def _mean_abs(arr):
    """Default statistic: mean |x| over the tensor."""
    return arr.abs().sum() / arr.size


def _render_stat(value):
    """Stringify one collected statistic (NDArray, list, or scalar)."""
    items = value if isinstance(value, list) else [value]
    return ",".join(
        str(v.asnumpy()) if isinstance(v, NDArray) else str(v)
        for v in items)


class Monitor:
    """Collect per-node output/weight statistics every ``interval`` steps.

    Parameters
    ----------
    interval : int
        Collect on steps where ``step % interval == 0``.
    stat_func : callable, optional
        ``NDArray -> NDArray`` statistic; defaults to mean absolute value.
    pattern : str
        Regex; only node/array names matching it are recorded.
    sort : bool
        Sort the per-step report by name before returning it.
    monitor_all : bool
        Default for :meth:`install`: tap every internal node output
        (reference monitor.py's monitor_all), not just the graph heads.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.interval = int(interval)
        self.stat_func = stat_func or _mean_abs
        self.sort = sort
        self.monitor_all = bool(monitor_all)
        self._name_filter = re.compile(pattern)
        self._records = []      # (step, name, raw stat) collected this window
        self._collecting = False
        self._step = 0
        self._executors = []

    # -- executor-facing surface ------------------------------------
    def stat_helper(self, name, arr):
        """Tap callback the executor invokes with each node output."""
        if self._collecting and self._name_filter.match(name):
            self._records.append((self._step, name, self.stat_func(arr)))

    def install(self, exe, monitor_all=False):
        """Attach to an executor (reference signature:
        ``python/mxnet/monitor.py`` ``install(exe, monitor_all=False)``).

        With the default ``monitor_all=False`` only graph-head outputs
        reach ``stat_helper`` (plus the argument snapshot ``toc`` takes
        itself).  ``monitor_all=True`` — here or on the constructor —
        reproduces the reference's per-op engine tap
        (graph_executor.cc:1444): every internal node output is
        reported, with ``pattern`` deciding what is kept."""
        exe.set_monitor_callback(self.stat_helper,
                                 monitor_all=monitor_all or self.monitor_all)
        self._executors.append(exe)

    # -- user-facing step protocol ----------------------------------
    def tic(self):
        """Open a collection window if this step is due."""
        if self._step % self.interval == 0:
            self._sync_args()
            self._records = []
            self._collecting = True
        self._step += 1

    def toc(self):
        """Close the window; return ``[(step, name, stat_string), ...]``."""
        if not self._collecting:
            return []
        self._sync_args()
        self._snapshot_args()
        self._collecting = False
        report = [(step, name, _render_stat(stat))
                  for step, name, stat in self._records]
        self._records = []
        if self.sort:
            report.sort(key=lambda item: item[1])
        return report

    def toc_print(self):
        """Log the window's stats (one line per node)."""
        for step, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, stat)

    # -- internals ---------------------------------------------------
    def _sync_args(self):
        """Block until installed executors' argument arrays are readable."""
        for exe in self._executors:
            for arr in exe.arg_arrays:
                arr.wait_to_read()

    def _snapshot_args(self):
        """Record weight/input statistics alongside the node outputs."""
        for exe in self._executors:
            for name, arr in zip(exe.arg_names, exe.arg_arrays):
                if self._name_filter.match(name):
                    self._records.append(
                        (self._step, name, self.stat_func(arr)))


# old attribute spellings kept as properties for callers that poked at
# the reference Monitor's internals
def _alias(old, new):
    def get(self):
        return getattr(self, new)

    def set_(self, value):
        setattr(self, new, value)

    setattr(Monitor, old, property(get, set_))


_alias("activated", "_collecting")
_alias("queue", "_records")
_alias("step", "_step")
_alias("exes", "_executors")
_alias("re_prog", "_name_filter")
