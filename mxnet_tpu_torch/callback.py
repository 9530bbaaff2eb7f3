"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (reference:
python/mxnet/callback.py): the checkpoint callbacks ``module_checkpoint``
and ``do_checkpoint``, and the logging ones, ``log_train_metric``,
``Speedometer``, ``ProgressBar`` and ``LogValidationMetricsCallback``,
whose lines (``Epoch[%d] Batch [%d]\\tSpeed: %.2f samples/sec`` and the
metric, ``Iter[%d] Batch[%d] Train-<metric>=``, ``Epoch[%d]
Validation-<metric>=``) have the reference's shapes, which tools parse.
While telemetry is on, ``Speedometer`` also sets the
``mxnet_speed_samples_per_sec`` gauge at each report.
"""
from __future__ import annotations

import logging
import time

from . import telemetry
from .model import save_checkpoint

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix=None, period=1, save_optimizer_states=False,
                      manager=None):
    """An epoch-end callback that checkpoints ``mod`` under ``prefix``
    every ``period`` epochs (reference: callback.py:28), the period
    counted from the last successful save: a save that fails (or that a
    busy async writer refuses) is logged and tried again at the next
    epoch.  ``manager``: route saves through a
    ``checkpoint.CheckpointManager`` instead of — when ``prefix`` is
    None — or in addition to the prefix files."""
    if prefix is None and manager is None:
        raise ValueError("module_checkpoint needs a prefix, a manager, "
                         "or both")
    period = int(max(1, period))
    last_saved = [0]    # epochs completed at the last successful save

    def _callback(iter_no, sym=None, arg=None, aux=None):
        done = iter_no + 1
        if done - last_saved[0] < period:
            return
        try:
            if manager is not None:
                if not manager.save_module(mod, epoch=done):
                    return   # writer busy — retry next epoch
                if prefix is not None:
                    # manager=False: the managed save just happened, so
                    # MXNET_CKPT_DIR must not route a second one
                    mod.save_checkpoint(prefix, done, save_optimizer_states,
                                        manager=False)
            else:
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


def log_train_metric(period, auto_reset=False):
    """A batch-end callback that logs the metric every ``period`` batches
    (reference: callback.py:84)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
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
        if telemetry.enabled():
            telemetry.gauge(
                "mxnet_speed_samples_per_sec",
                "Speedometer window throughput").set(round(speed, 3))
        head = ("Epoch[%d]" % param.epoch) if metric_parts \
            else ("Iter[%d]" % param.epoch)
        logging.info("\t".join(
            ["%s Batch [%d]" % (head, count),
             "Speed: %.2f samples/sec" % speed] + metric_parts))
        self._tick = time.time()


class ProgressBar:
    """Log an ASCII progress bar of ``nbatch`` out of ``total`` batches
    (reference: callback.py:187)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.bar_len * frac))
        bar = "=" * filled + "-" * (self.bar_len - filled)
        logging.info("[%s] %d%%\r", bar, int(frac * 100 + 0.999))


class LogValidationMetricsCallback:
    """An eval-end callback that logs the validation metrics (reference:
    callback.py:211)."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
