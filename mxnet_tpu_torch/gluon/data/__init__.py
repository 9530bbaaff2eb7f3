"""Gluon data (reference: python/mxnet/gluon/data/; counterpart of
``mxnet_tpu/gluon/data``): datasets, samplers, the DataLoader and the
vision datasets and transforms."""
from .dataset import (  # noqa: F401
    Dataset, SimpleDataset, ArrayDataset, RecordFileDataset)
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
