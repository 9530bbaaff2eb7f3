"""Experimental gluon blocks (reference: python/mxnet/gluon/contrib/;
this package carries ``transformer``)."""
from . import transformer  # noqa: F401
