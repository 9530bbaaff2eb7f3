"""Flat-bucket planning.

Counterpart of ``mxnet_tpu/parallel/collectives.py:32-125``: the plan
that groups parameters into contiguous 1-D fp32 buckets, and the
flatten/unflatten pair.  The executor's fused optimizer step keeps its
weights and optimizer slots in such buckets and updates each bucket with
one kernel launch; the collectives that give the JAX module its name
come with the multi-GPU slice.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Bucket", "build_bucket_plan", "flatten_bucket",
           "unflatten_bucket"]


class Bucket:
    """One bucket: a contiguous 1-D buffer over a fixed list of
    parameters, padded to ``pad_multiple`` elements."""

    __slots__ = ("index", "names", "shapes", "sizes", "offsets",
                 "n", "padded_n")

    def __init__(self, index, names, shapes, pad_multiple):
        self.index = index
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.cumsum([0] + self.sizes).tolist()
        self.n = int(self.offsets[-1])
        pad = (-self.n) % max(int(pad_multiple), 1)
        self.padded_n = self.n + pad

    @property
    def nbytes(self):
        """Unpadded fp32 payload bytes of this bucket."""
        return 4 * self.n

    def __repr__(self):
        return "Bucket(%d: %d params, %d elems, %d padded)" % (
            self.index, len(self.names), self.n, self.padded_n)


def build_bucket_plan(names, shapes, bucket_bytes, first_bucket_bytes=None,
                      pad_multiple=1):
    """Partition ``names`` (registration order) into buckets of at most
    ``bucket_bytes``, walking in reverse so bucket 0 holds the parameters
    whose gradients a backward pass finishes first.  ``bucket_bytes <= 0``
    gives one bucket of everything."""
    names = list(names)
    shapes = [tuple(s) for s in shapes]
    if not names:
        return []
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes <= 0:
        groups = [list(range(len(names)))[::-1]]
    else:
        first = int(first_bucket_bytes or bucket_bytes)
        groups, cur, cur_bytes = [], [], 0
        cap = max(first, 4)
        for i in reversed(range(len(names))):
            sz = 4 * (int(np.prod(shapes[i])) if shapes[i] else 1)
            if cur and cur_bytes + sz > cap:
                groups.append(cur)
                cur, cur_bytes = [], 0
                cap = max(bucket_bytes, 4)
            cur.append(i)
            cur_bytes += sz
        if cur:
            groups.append(cur)
    return [Bucket(bi, [names[i] for i in idxs],
                   [shapes[i] for i in idxs], pad_multiple)
            for bi, idxs in enumerate(groups)]


def flatten_bucket(values, bucket):
    """One bucket's tensors (in ``bucket.names`` order) as its padded
    1-D fp32 buffer (a new tensor)."""
    if values:
        flat = torch.cat([v.reshape(-1).to(torch.float32) for v in values])
    else:
        flat = torch.zeros((0,), dtype=torch.float32)
    if bucket.padded_n != bucket.n:
        flat = torch.cat([flat, flat.new_zeros(bucket.padded_n - bucket.n)])
    return flat


def unflatten_bucket(flat, bucket):
    """``{name: view}``: each parameter's slice of ``flat`` in its shape
    (views, so writing into ``flat`` writes into them)."""
    out = {}
    for name, shape, off, sz in zip(bucket.names, bucket.shapes,
                                    bucket.offsets, bucket.sizes):
        out[name] = flat[off:off + sz].view(shape)
    return out
