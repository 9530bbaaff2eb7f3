"""RNN checkpoint helpers.

Counterpart of ``mxnet_tpu/rnn/rnn.py`` (reference: ``python/mxnet/rnn/
rnn.py``): ``save_rnn_checkpoint``, ``load_rnn_checkpoint`` and
``do_rnn_checkpoint``, which save and load through the cells'
``unpack_weights``/``pack_weights``; the files are the JAX package's,
byte for byte.
"""
from __future__ import annotations

from .. import model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Reference: rnn.py save_rnn_checkpoint."""
    args = dict(arg_params)
    for cell in _as_list(cells):
        args = cell.unpack_weights(args)
    model.save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Reference: rnn.py load_rnn_checkpoint."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    for cell in _as_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback (reference: rnn.py do_rnn_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
