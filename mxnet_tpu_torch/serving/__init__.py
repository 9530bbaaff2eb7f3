"""Model serving: registry, shape buckets, executor cache and the
micro-batching ``ModelServer`` (counterpart of ``mxnet_tpu/serving``),
with per-model quotas, priority-classed load-shedding and brownout,
canary promotion with health-gated rollback (``canary.py``), the warmup
manifest (``manifest.py``) and the ``CheckpointWatcher`` that hot-swaps
committed training checkpoints.  Generative serving (``generate/``) and
the multi-replica front door (``fleet.py``) come with later slices."""
from .bucketing import pick_bucket, shape_buckets  # noqa: F401
from .cache import ExecutorCache  # noqa: F401
from .canary import CanaryState  # noqa: F401
from .errors import (  # noqa: F401
    BadRequest, DeadlineExceeded, ModelNotFound, QueueFull, ServerClosed,
    ServingError,
)
from .manifest import WarmupManifest  # noqa: F401
from .registry import (CheckpointWatcher, ModelRegistry,  # noqa: F401
                       ModelVersion)
from .server import InferenceFuture, ModelServer  # noqa: F401

__all__ = ["ModelServer", "ModelRegistry", "ModelVersion", "ExecutorCache",
           "InferenceFuture", "CanaryState", "ServingError",
           "ModelNotFound", "QueueFull", "DeadlineExceeded", "ServerClosed",
           "BadRequest", "CheckpointWatcher", "WarmupManifest",
           "shape_buckets", "pick_bucket"]
