"""Ring-buffer KV-cache state — the fixed shapes behind decode.

Counterpart of ``mxnet_tpu/serving/generate/kv_cache.py``.  The decode
loop must never see a novel shape: growing the KV tensor by one position
per emitted token would reallocate the cache every step.
``DecodeState`` therefore preallocates the cache at ``[layers, slots,
kv_heads, max_len, head_dim]`` on the model's device and tracks
per-slot progress in three tiny host-side vectors:

- ``cursor[s]`` — total tokens ever written to slot ``s`` (monotonic;
  the ring write index is ``cursor % max_len``);
- ``tokens[s]`` — the slot's last emitted token, i.e. the next decode
  step's input;
- ``active[s]`` — whether the slot holds a live generation.

``k`` and ``v`` are torch tensors written IN PLACE by the admit and
decode paths of ``model.py`` (index assignment on the device; the cache
is never copied).  The cursors stay host-side numpy: they are a few
bytes, mutated every step by the scheduler, and fed to each step as one
small host-to-device copy.

Ring semantics past capacity: writes wrap (``cursor % max_len``) and
attention masks to ``min(cursor + 1, max_len)`` valid positions, so a
generation longer than the window attends to the most recent
``max_len`` tokens — sliding-window attention by construction, never a
reallocation.  Positional embeddings clamp at the table's last row past
the window (prompts themselves are capped at ``max_len`` at admission).
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import dtype_torch
from ...context import resolve

__all__ = ["DecodeState"]


class DecodeState:
    """Preallocated decode state for a fixed slot pool, the cache on
    ``ctx`` (default the current context)."""

    def __init__(self, slots, num_layers, num_kv_heads, max_len, head_dim,
                 dtype="float32", ctx=None):
        if slots < 1 or max_len < 1:
            raise ValueError("need slots >= 1 and max_len >= 1, got "
                             "%d slots x %d positions" % (slots, max_len))
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.device = resolve(ctx)
        shape = (int(num_layers), int(slots), int(num_kv_heads),
                 int(max_len), int(head_dim))
        self.k = torch.zeros(shape, dtype=dtype_torch(dtype),
                             device=self.device)
        self.v = torch.zeros(shape, dtype=dtype_torch(dtype),
                             device=self.device)
        self.cursor = np.zeros(self.slots, np.int32)
        self.tokens = np.zeros(self.slots, np.int32)
        self.active = np.zeros(self.slots, bool)

    @staticmethod
    def kv_bytes(num_layers, num_kv_heads, max_len, head_dim,
                 dtype_size=4, slots=1):
        """Cache footprint in bytes (K and V) of ``slots`` decode
        slots."""
        return (2 * int(num_layers) * int(slots) * int(num_kv_heads)
                * int(max_len) * int(head_dim) * int(dtype_size))

    def free_slots(self):
        """Indices of slots not holding a live generation."""
        return [int(i) for i in np.flatnonzero(~self.active)]

    def busy(self):
        """Number of slots holding a live generation."""
        return int(self.active.sum())

    def occupy(self, slot, prompt_len, first_token):
        """Host-side bookkeeping after an admit wrote the prompt's K/V
        into ``slot``: ``prompt_len`` history positions are valid and the
        next decode input is ``first_token``."""
        if self.active[slot]:
            raise RuntimeError("slot %d is already occupied" % slot)
        if prompt_len > self.max_len:
            raise ValueError("prompt of %d tokens exceeds the KV window "
                             "(%d)" % (prompt_len, self.max_len))
        self.cursor[slot] = int(prompt_len)
        self.tokens[slot] = int(first_token)
        self.active[slot] = True

    def advance(self, slot, token):
        """Commit one decoded token on ``slot``: the step wrote its K/V
        at ``cursor % max_len`` and emitted ``token``."""
        self.cursor[slot] += 1
        self.tokens[slot] = int(token)

    def release(self, slot):
        """Return ``slot`` to the free pool (EOS / cap / deadline /
        fault).  The cache rows stay in place — the next admit
        overwrites them and the validity mask hides them meanwhile."""
        self.active[slot] = False
        self.cursor[slot] = 0
        self.tokens[slot] = 0

    def n_generated(self, slot, prompt_len):
        return int(self.cursor[slot]) - int(prompt_len)
