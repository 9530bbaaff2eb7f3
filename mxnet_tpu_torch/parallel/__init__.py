"""The scale-out layer (counterpart of ``mxnet_tpu/parallel``): the
process group (``distributed``), the mesh of ranks (``mesh``), the
bucketed gradient collectives (``collectives``), the ZeRO optimizers
(``optimizer``) and ``ParallelTrainer`` (``trainer``) for data-parallel
training across GPUs, and single-device ``attention``.  Model-axis
sharding, ring and Ulysses attention, pipelines and experts come with the
next multi-GPU slice."""
from . import collectives  # noqa: F401
from . import attention  # noqa: F401
from .attention import local_attention  # noqa: F401
from .distributed import (  # noqa: F401
    init_distributed, rank, num_workers, is_initialized,
)
from .mesh import (  # noqa: F401
    make_mesh, current_mesh, mesh_scope, replicated, batch_sharded, Mesh,
)
from .optimizer import PureSGD, PureAdam, make_optimizer  # noqa: F401
from .trainer import ParallelTrainer, pure_block_apply  # noqa: F401
