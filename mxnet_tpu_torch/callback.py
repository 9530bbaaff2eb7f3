"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (reference:
python/mxnet/callback.py): ``Speedometer``.
The checkpoint callbacks wait for the V2 ``save``/``load`` container.
Its log line (``Epoch[%d] Batch [%d]\\tSpeed: %.2f samples/sec`` and the
metric) has the reference's shape, which tools parse.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer"]


class Speedometer:
    """Log samples/sec and the metric every ``frequent`` batches
    (reference: callback.py:115).  Reading the metric waits for the
    device, so each window measures finished work."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._tick = None
        self._last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if count < self._last_count:       # a new epoch restarts the window
            self._tick = None
        self._last_count = count
        if self._tick is None:
            self._tick = time.time()
            return
        if count % self.frequent:
            return
        metric_parts = []
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                metric_parts.append("%s=%f" % (name, value))
            if self.auto_reset:
                param.eval_metric.reset()
        speed = self.frequent * self.batch_size / (time.time() - self._tick)
        head = ("Epoch[%d]" % param.epoch) if metric_parts \
            else ("Iter[%d]" % param.epoch)
        logging.info("\t".join(
            ["%s Batch [%d]" % (head, count),
             "Speed: %.2f samples/sec" % speed] + metric_parts))
        self._tick = time.time()
