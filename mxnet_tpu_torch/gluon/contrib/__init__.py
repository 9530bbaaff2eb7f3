"""Experimental gluon blocks (reference: python/mxnet/gluon/contrib/;
this package carries ``rnn`` and ``transformer``)."""
from . import rnn  # noqa: F401
from . import transformer  # noqa: F401
