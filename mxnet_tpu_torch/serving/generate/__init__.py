"""Generative inference (counterpart of ``mxnet_tpu.serving.generate``).

Turns the one-shot ``ModelServer`` into an autoregressive token service:

- ``kv_cache.DecodeState`` — the preallocated ring-buffer KV-cache on the
  model's device, written in place, so every decode step has one shape;
- ``model.GenerativeModel`` — the prefill grid / admit / decode paths
  over a ``TransformerLM.generative_spec()`` export, prefill cells bound
  through the server's ``ExecutorCache`` + ``WarmupManifest``;
- ``scheduler.DecodeScheduler`` — continuous batching (slots join and
  leave every step), priority classes, per-tenant slot quotas,
  token-priced brownout, per-tenant exactly-once ledgers;
- ``stream.TokenStream`` — the ``infer_stream`` handle: iterate tokens
  as they decode, with TTFT / per-token stamps.

Entry points on ``ModelServer``: ``add_generative_model(...)``, then
``warmup_generative()`` and ``infer_stream(...)``.
"""
from .kv_cache import DecodeState  # noqa: F401
from .model import GenerativeModel  # noqa: F401
from .scheduler import DecodeScheduler  # noqa: F401
from .stream import TokenStream  # noqa: F401

__all__ = ["DecodeState", "GenerativeModel", "DecodeScheduler",
           "TokenStream"]
