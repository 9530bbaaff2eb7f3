"""Model serving: registry, shape buckets, executor cache and the
micro-batching ``ModelServer`` (counterpart of ``mxnet_tpu/serving``),
with per-model quotas, priority-classed load-shedding and brownout,
canary promotion with health-gated rollback (``canary.py``), the warmup
manifest (``manifest.py``) and the ``CheckpointWatcher`` that hot-swaps
committed training checkpoints, and generative serving (``generate/``:
the ring KV-cache, the prefill grid, the continuous-batching decode
scheduler and token streams behind ``ModelServer.infer_stream``).  The
multi-replica front door (``fleet.py``) comes with multi-GPU."""
from .bucketing import (pick_bucket, pick_grid_bucket,  # noqa: F401
                        prefill_grid, seq_buckets, shape_buckets)
from .cache import ExecutorCache  # noqa: F401
from .canary import CanaryState  # noqa: F401
from .errors import (  # noqa: F401
    BadRequest, DeadlineExceeded, ModelNotFound, QueueFull, ServerClosed,
    ServingError,
)
from .generate import (DecodeScheduler, DecodeState,  # noqa: F401
                       GenerativeModel, TokenStream)
from .manifest import WarmupManifest  # noqa: F401
from .registry import (CheckpointWatcher, ModelRegistry,  # noqa: F401
                       ModelVersion)
from .server import InferenceFuture, ModelServer  # noqa: F401

__all__ = ["ModelServer", "ModelRegistry", "ModelVersion", "ExecutorCache",
           "InferenceFuture", "CanaryState", "ServingError",
           "ModelNotFound", "QueueFull", "DeadlineExceeded", "ServerClosed",
           "BadRequest", "CheckpointWatcher", "WarmupManifest",
           "shape_buckets", "pick_bucket", "seq_buckets", "prefill_grid",
           "pick_grid_bucket", "GenerativeModel", "DecodeScheduler",
           "DecodeState", "TokenStream"]
