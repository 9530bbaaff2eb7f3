"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (reference:
python/mxnet/callback.py): the checkpoint callbacks ``module_checkpoint``
and ``do_checkpoint``, and ``Speedometer``, whose log line
(``Epoch[%d] Batch [%d]\\tSpeed: %.2f samples/sec`` and the metric) has
the reference's shape, which tools parse.
"""
from __future__ import annotations

import logging
import time

from .model import _refuse_manager, save_checkpoint

__all__ = ["module_checkpoint", "do_checkpoint", "Speedometer"]


def module_checkpoint(mod, prefix=None, period=1, save_optimizer_states=False,
                      manager=None):
    """An epoch-end callback that checkpoints ``mod`` under ``prefix``
    every ``period`` epochs (reference: callback.py:28), the period
    counted from the last successful save: a save that fails is logged
    and tried again at the next epoch.  ``manager=`` and
    ``MXNET_CKPT_DIR`` raise here: the checkpoint manager is not
    ported."""
    _refuse_manager(manager)
    if prefix is None:
        raise ValueError("module_checkpoint needs a prefix")
    period = int(max(1, period))
    last_saved = [0]    # epochs completed at the last successful save

    def _callback(iter_no, sym=None, arg=None, aux=None):
        done = iter_no + 1
        if done - last_saved[0] < period:
            return
        try:
            mod.save_checkpoint(prefix, done, save_optimizer_states)
        except Exception:   # noqa: BLE001 — logged, retried next epoch
            logging.warning("checkpoint at epoch %d failed; retrying next "
                            "epoch", done, exc_info=True)
            return
        last_saved[0] = done
    return _callback


def do_checkpoint(prefix, period=1):
    """An epoch-end callback that writes ``save_checkpoint``'s two files
    every ``period`` epochs (reference: callback.py:56)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


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
