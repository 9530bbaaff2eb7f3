"""Shape buckets (counterpart of ``mxnet_tpu/serving/bucketing.py``).

The serving layer quantises the batch dimension to a ladder of powers of
two up to ``max_batch``: a coalesced batch of ``n`` rows is padded up to
the smallest bucket >= n and sliced back after the forward, so the
server keeps one bound predictor per rung.  Generative serving adds the
sequence-length ladder (``seq_buckets``) and the prefill grid of (batch,
length) cells over both ladders (``prefill_grid``, ``pick_grid_bucket``).
"""
from __future__ import annotations

__all__ = ["shape_buckets", "pick_bucket", "seq_buckets", "prefill_grid",
           "pick_grid_bucket"]


def shape_buckets(max_batch):
    """The batch-size ladder ``1, 2, 4, ..., max_batch``; ``max_batch`` is
    always the last rung, a power of two or not."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %d" % max_batch)
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def pick_bucket(rows, buckets):
    """Smallest bucket >= rows; None when rows exceeds the ladder."""
    for b in buckets:
        if b >= rows:
            return b
    return None


def seq_buckets(max_len, min_len=1):
    """The sequence-length ladder for variable-length prompts (the
    reference ``BucketingModule``'s bucket keys): powers of two from
    ``min_len``, ``max_len`` always the last rung.  A prompt pads up to the
    smallest rung >= its length; each rung is one prefill grid column."""
    max_len = int(max_len)
    min_len = int(min_len)
    if min_len < 1 or max_len < min_len:
        raise ValueError("need 1 <= min_len <= max_len, got %d..%d"
                         % (min_len, max_len))
    out = []
    b = min_len
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def prefill_grid(batch_ladder, len_ladder):
    """The prefill working set: every (batch rung, length rung) pair.  Each
    cell is one executor-cache entry; warmup binds the grid, so
    variable-length traffic binds nothing in steady state."""
    return [(int(b), int(t)) for b in batch_ladder for t in len_ladder]


def pick_grid_bucket(rows, length, batch_ladder, len_ladder):
    """Smallest (batch, length) grid cell covering a coalesced prefill of
    ``rows`` prompts padded to ``length`` tokens; None when either axis
    exceeds its ladder."""
    b = pick_bucket(rows, batch_ladder)
    t = pick_bucket(length, len_ladder)
    if b is None or t is None:
        return None
    return (b, t)
