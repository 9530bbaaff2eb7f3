"""The scale-out layer (counterpart of ``mxnet_tpu/parallel``): the
process group (``distributed``), the mesh of ranks over the axes dp,
fsdp, tp, pp, sp and ep (``mesh``), the bucketed gradient collectives and
the differentiable exchanges of a sharded region (``collectives``), the
ZeRO optimizers (``optimizer``), ``ParallelTrainer`` (``trainer``) for
training with the batch and the parameters sharded across GPUs, ring and
Ulysses attention (``attention``), pipelines (``pipeline``) and experts
(``moe``), and the fault-addressable message spool that the dist_async
store and the serving fleet ride (``transport``)."""
from . import collectives  # noqa: F401
from . import attention  # noqa: F401
from .attention import (  # noqa: F401
    ring_attention, ulysses_attention, local_attention,
)
from .distributed import (  # noqa: F401
    init_distributed, rank, num_workers, is_initialized,
)
from .mesh import (  # noqa: F401
    make_mesh, current_mesh, mesh_scope, replicated, batch_sharded, Mesh,
)
from .optimizer import PureSGD, PureAdam, make_optimizer  # noqa: F401
from .trainer import ParallelTrainer, pure_block_apply  # noqa: F401
from .pipeline import pipeline_apply, stack_stages  # noqa: F401
from .moe import switch_moe, stack_experts  # noqa: F401
from .transport import InboxFull, Message, SpoolTransport  # noqa: F401
