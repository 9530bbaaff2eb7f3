"""Logging utilities (counterpart of ``mxnet_tpu/log.py``; reference:
python/mxnet/log.py): ``get_logger`` with MXNet's line format."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger"]

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

PY3 = True


class _Formatter(logging.Formatter):
    """Customized log formatter (reference: log.py:36)."""

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def _get_color(self, level):
        if logging.WARNING <= level:
            return "\x1b[31m"
        if logging.INFO <= level:
            return "\x1b[32m"
        return "\x1b[34m"

    def format(self, record):
        fmt = ""
        if self.colored:
            fmt = self._get_color(record.levelno)
        fmt += record.levelname[0]
        fmt += "%(asctime)s %(process)d %(pathname)s:%(funcName)s:%(lineno)d"
        if self.colored:
            fmt += "\x1b[0m"
        fmt += " %(message)s"
        self._style._fmt = fmt
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Get a customized logger (reference: log.py:71)."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", None):
        logger._init_done = True
        if filename:
            mode = filemode if filemode else "a"
            hdlr = logging.FileHandler(filename, mode)
        else:
            hdlr = logging.StreamHandler()
        hdlr.setFormatter(_Formatter(colored=filename is None and
                                     sys.stderr.isatty()))
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger
