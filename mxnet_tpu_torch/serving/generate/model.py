"""GenerativeModel — the device-side surface of generation.

Counterpart of ``mxnet_tpu/serving/generate/model.py``.  Three program
families, each fixed-shape, in plain torch on the model's device (the
JAX package runs them as plain jnp with no Pallas kernel, so no
hand-written kernel runs here either):

- **prefill** — full causal forward over a padded ``(batch, length)``
  grid cell, returning the first greedy token and the prompt's
  per-layer K/V history.  One program per grid cell
  (``bucketing.prefill_grid``), bound THROUGH the server's
  ``ExecutorCache`` via the ``binder`` seam: prefill cells share the
  same LRU, per-model quota, miss counter and ``WarmupManifest`` miss
  hook as the one-shot models' predictors — a restarted replica re-warms
  exactly the grid cells live traffic used.
- **admit** — copy one prompt's K/V rows into a decode slot: an in-place
  write of positions ``0..t-1`` of that slot (one writer per LENGTH rung;
  the slot index is data, not shape).
- **decode** — ONE step for the whole slot pool: embed the last token of
  every slot, write this position's K/V in place at ``cursor %
  max_len``, attend via
  ``gluon.contrib.transformer.cached_attention_step`` (validity-masked
  ring), greedy-sample the next token.  Sequence position is data (the
  ``cursor`` vector), so the step's shapes never change as generations
  advance.

Only ``first`` (``[b]``) of a prefill and the next tokens (``[slots]``)
of a decode step cross to the host; the K/V histories stay on the
device.  A torch program has no jit cache, so ``compile_stats`` counts
what would make a new program: the distinct input signatures (shapes,
dtype, device) the decode and admit paths have run.  After warmup that
count stays flat in steady state.

Weights are arguments (a nested dict of tensors), not closed-over
constants, and ``symbol_sha`` hashes the ARCHITECTURE, not the weights —
the same manifest identity as ``serving/manifest.py``.
"""
from __future__ import annotations

import functools
import hashlib
import json
import threading

import numpy as np
import torch

from ...context import resolve
from ...gluon.contrib.transformer import (cached_attention_step,
                                          causal_attention)
from ..bucketing import (pick_grid_bucket, prefill_grid, seq_buckets,
                         shape_buckets)
from .kv_cache import DecodeState

__all__ = ["GenerativeModel"]


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def _signature(*tensors):
    return tuple((tuple(t.shape), str(t.dtype), str(t.device))
                 for t in tensors)


class GenerativeModel:
    """One generative deployment: weights + ladders + programs.

    ``spec`` is ``TransformerLM.generative_spec()`` (or a block, which
    is exported on the spot); its tensors are moved to ``ctx`` (default
    the current context) where they are not already there.  Duck-types
    the slice of ``ModelVersion`` the executor cache and warmup manifest
    key on (``name``, ``version``, ``symbol_sha``, ``sample_shapes``).
    """

    def __init__(self, name, spec, max_len=None, prefill_batch=None,
                 eos_id=None, version=1, ctx=None):
        from ... import config as _cfg
        if hasattr(spec, "generative_spec"):
            spec = spec.generative_spec()
        self.name = str(name)
        self.version = int(version)
        self.device = resolve(ctx)
        self.config = dict(spec["config"])
        self.params = self._to_device(spec["params"])
        self.eos_id = eos_id
        # the KV window: prompts and attention history are capped here;
        # defaults to the model's positional table so ring wrap-around
        # is opt-in (a window shorter than the table slides)
        self.max_len = int(max_len if max_len is not None
                           else self.config["max_len"])
        if prefill_batch is None:
            prefill_batch = _cfg.get("MXNET_SERVING_GEN_PREFILL_BATCH")
        self.batch_ladder = shape_buckets(int(prefill_batch))
        self.len_ladder = seq_buckets(self.max_len)
        self.symbol_sha = self._arch_sha(self.config)
        self.sample_shapes = {"tokens": (1, 1)}
        self._decode_sigs = set()       # guarded-by: _lock
        self._admit_sigs = {}           # guarded-by: _lock — rung -> set
        self._index = {}                # guarded-by: _lock — slots -> idx
        self._lock = threading.Lock()

    def _to_device(self, tree):
        if isinstance(tree, dict):
            return {k: self._to_device(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._to_device(v) for v in tree]
        return torch.as_tensor(tree).detach().to(self.device)

    @staticmethod
    def _arch_sha(config):
        doc = json.dumps(config, sort_keys=True).encode("utf-8")
        return hashlib.sha256(doc).hexdigest()

    # -- geometry ----------------------------------------------------

    @property
    def head_dim(self):
        return self.config["units"] // self.config["num_heads"]

    def make_state(self, slots):
        return DecodeState(slots, self.config["num_layers"],
                           self.config["num_kv_heads"], self.max_len,
                           self.head_dim, ctx=self.device)

    def kv_bytes_per_slot(self):
        return DecodeState.kv_bytes(self.config["num_layers"],
                                    self.config["num_kv_heads"],
                                    self.max_len, self.head_dim)

    def param_bytes(self):
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in self._leaves(self.params))

    @classmethod
    def _leaves(cls, tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from cls._leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from cls._leaves(v)
        else:
            yield tree

    def grid(self):
        return prefill_grid(self.batch_ladder, self.len_ladder)

    def pick_cell(self, rows, length):
        return pick_grid_bucket(rows, length, self.batch_ladder,
                                self.len_ladder)

    def _ids(self, host):
        """Host int arrays -> one int64 tensor on the device (one copy)."""
        return torch.from_numpy(np.asarray(host, np.int64)).to(self.device)

    # -- prefill (through the ExecutorCache) -------------------------

    def prefill(self, exec_cache, cell, tokens_padded, lengths):
        """Run one padded prefill through the server's executor cache.

        ``tokens_padded``: int ``[cell_b, cell_t]``; ``lengths``: int
        ``[cell_b]`` (real prompt lengths; padded rows carry 0s and a
        length of 1 so their values stay finite and ignored).  Returns
        ``(first_tokens [b], k_hist, v_hist)`` as tensors on the device,
        the histories ``[layers, b, kv_heads, cell_t, head_dim]``."""
        cell = tuple(int(c) for c in cell)
        fn = exec_cache.get(self, cell,
                            binder=functools.partial(self._bind_prefill,
                                                     cell))
        return fn(self.params, tokens_padded, lengths)

    def _bind_prefill(self, cell):
        """The program of one grid cell: the prefill held to that cell's
        shape (the cache entry owns it; eviction drops it)."""
        def program(params, tokens, lengths):
            tokens = np.asarray(tokens)
            if tuple(tokens.shape) != cell:
                raise ValueError("prefill cell %s got tokens of shape %s"
                                 % (cell, tokens.shape))
            with torch.no_grad():
                return self._prefill_impl(params, self._ids(tokens),
                                          self._ids(lengths))
        return program

    def _prefill_impl(self, params, tokens, lengths):
        cfg = self.config
        H, Hkv = cfg["num_heads"], cfg["num_kv_heads"]
        D = self.head_dim
        B, T = tokens.shape
        pos = torch.arange(T, device=self.device).clamp(
            max=cfg["max_len"] - 1)
        x = params["embed"][tokens] + params["pos_embed"][pos][None]
        ks, vs = [], []
        for L in params["layers"]:
            h = _ln(x, L["ln1_g"], L["ln1_b"])
            q = (h @ L["wq"].T).reshape(B, T, H, D)
            k = (h @ L["wk"].T).reshape(B, T, Hkv, D)
            v = (h @ L["wv"].T).reshape(B, T, Hkv, D)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
            o = causal_attention(q, k, v).reshape(B, T, -1)
            x = x + o @ L["wo"].T
            h = _ln(x, L["ln2_g"], L["ln2_b"])
            h = torch.relu(h @ L["w1"].T + L["b1"])
            x = x + h @ L["w2"].T + L["b2"]
        x = _ln(x, params["ln_f_g"], params["ln_f_b"])
        last = x[torch.arange(B, device=self.device), lengths - 1]
        logits = last @ params["head_w"].T + params["head_b"]
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        return first, torch.stack(ks), torch.stack(vs)

    # -- admit -------------------------------------------------------

    def admit(self, state, slot, k_row, v_row):
        """Write one prompt's K/V history (``[layers, kv_heads, t,
        head_dim]`` tensors) into positions ``0..t-1`` of decode slot
        ``slot``, in place — one writer per length rung ``t``."""
        rung = int(k_row.shape[2])
        with self._lock:
            self._admit_sigs.setdefault(rung, set()).add(
                _signature(state.k, k_row))
        with torch.no_grad():
            state.k[:, int(slot), :, :rung] = k_row
            state.v[:, int(slot), :, :rung] = v_row

    # -- decode ------------------------------------------------------

    def _slot_index(self, slots):
        with self._lock:
            idx = self._index.get(slots)
            if idx is None:
                idx = (torch.arange(slots, device=self.device)[:, None],
                       torch.arange(self.config["num_kv_heads"],
                                    device=self.device)[None, :])
                self._index[slots] = idx
            return idx

    def decode_step(self, state):
        """One continuous-batching step over the WHOLE slot pool: every
        active slot advances one token; free slots ride along as lanes
        whose results are ignored (keeping them in the batch is what
        keeps the step's shapes fixed).  Returns the next token per slot
        as int32 numpy ``[slots]``; host-side cursor commits are the
        scheduler's job (per-slot fault isolation decides which lanes
        actually advance)."""
        with self._lock:
            self._decode_sigs.add(_signature(state.k, state.v))
        s_idx, h_idx = self._slot_index(state.slots)
        ids = self._ids(np.stack([state.tokens, state.cursor]))
        with torch.no_grad():
            nxt = self._decode_impl(self.params, state.k, state.v, ids[0],
                                    ids[1], s_idx, h_idx)
        return nxt.cpu().numpy()

    def _decode_impl(self, params, k, v, tokens, cursor, s_idx, h_idx):
        cfg = self.config
        H, Hkv = cfg["num_heads"], cfg["num_kv_heads"]
        D = self.head_dim
        M = self.max_len
        S = tokens.shape[0]
        x = params["embed"][tokens]
        # position is DATA: clamp at the table edge past the window (the
        # ring approximation documented in kv_cache.py)
        x = x + params["pos_embed"][cursor.clamp(max=cfg["max_len"] - 1)]
        w_idx = (cursor % M)[:, None]
        n_valid = (cursor + 1).clamp(max=M)
        for li, L in enumerate(params["layers"]):
            h = _ln(x, L["ln1_g"], L["ln1_b"])
            q = (h @ L["wq"].T).reshape(S, H, D)
            kn = (h @ L["wk"].T).reshape(S, Hkv, D)
            vn = (h @ L["wv"].T).reshape(S, Hkv, D)
            k[li][s_idx, h_idx, w_idx] = kn
            v[li][s_idx, h_idx, w_idx] = vn
            o = cached_attention_step(q, k[li], v[li], n_valid)
            x = x + o.reshape(S, -1) @ L["wo"].T
            h = _ln(x, L["ln2_g"], L["ln2_b"])
            h = torch.relu(h @ L["w1"].T + L["b1"])
            x = x + h @ L["w2"].T + L["b2"]
        x = _ln(x, params["ln_f_g"], params["ln_f_b"])
        logits = x @ params["head_w"].T + params["head_b"]
        return torch.argmax(logits, dim=-1).to(torch.int32)

    # -- warmup + accounting -----------------------------------------

    def warmup(self, exec_cache, state, grid=None):
        """Bind and run the full working set up front: every prefill grid
        cell (through the executor cache, so the manifest records them),
        one admit per length rung, and the decode step.  ``grid`` narrows
        to a manifest-replayed working set.

        The admits and the decode step run on a scratch ``DecodeState``
        of ``state``'s geometry, made for the warmup and dropped after:
        the live state is never written, so a warmup while slots hold
        live generations leaves their K/V rows, cursors and bookkeeping
        as they were (the JAX package's warmup admits into slot 0 of the
        live state and releases it)."""
        cells = list(grid) if grid is not None else self.grid()
        scratch = self.make_state(state.slots)
        for (b, t) in cells:
            toks = np.zeros((b, t), np.int32)
            lens = np.ones(b, np.int32)
            _first, k_hist, v_hist = self.prefill(exec_cache, (b, t),
                                                  toks, lens)
            self.admit(scratch, 0, k_hist[:, 0], v_hist[:, 0])
        self.decode_step(scratch)
        return len(cells)

    def compile_stats(self):
        """Counts of the distinct input signatures the decode and admit
        paths have run (the JAX package's compiled-variant counts, under
        its keys) — what stays flat across steady-state steps (prefill
        binds are the executor cache's miss counter)."""
        with self._lock:
            return {"decode_compiles": len(self._decode_sigs),
                    "admit_compiles": sum(len(s) for s in
                                          self._admit_sigs.values()),
                    "admit_programs": len(self._admit_sigs)}
