"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` is the reference; this package keeps its
module names and API (``import mxnet_tpu_torch as mx``) and runs on an
NVIDIA GPU, with the JAX package's Pallas kernels rewritten by hand in
CUDA (``ops/csrc/``, built by ``ops/_build.py`` at first use).  It
imports neither ``jax`` nor ``mxnet_tpu``.

Entry points run on the current context: ``gpu(0)`` unless given
``ctx=cpu()`` or called inside ``with mx.cpu():``; without a GPU they
raise rather than fall back to the CPU.  PyTorch is imported as
``_torch``: ``mx.torch`` is not PyTorch (in the JAX package it names the
bridge module, which the port does not have yet).

Precision: float32 convolutions and matmuls run in full float32, not
TF32 (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` are set to False at import),
because the reference forward is float32.

The port carries five paths so far: inference (symbols and their JSON,
the ops of a ResNet, ``simple_bind``/``forward``, ``Predictor`` and the
micro-batching ``ModelServer``), training through ``Module.fit``
(autograd backward, BatchNorm's batch statistics, SGD/Adam, the
executor's fused optimizer step, ``NDArrayIter``, metrics,
initializers and the ``local``/``device``/``tpu`` kvstores), the gluon
transformer forward (``gluon.contrib.transformer.TransformerLM``:
Block/HybridBlock, Parameter, the ``nd`` op namespace, LayerNorm and
attention), gluon training of that transformer (``autograd.record``
/ ``backward`` / ``grad`` over imperative ops, ``gluon.loss``,
``gluon.Trainer``, and the backward kernels of LayerNorm, flash
attention and the masked softmax), and checkpoints: ``nd.save``/``load``,
``sym.save``/``load``, ``model.save_checkpoint``/``load_checkpoint``,
``Module.load``/``save_checkpoint`` with optimizer states, the
checkpoint callbacks, gluon's ``save_parameters``/``load_parameters`` and
``Trainer.save_states``/``load_states``, and ``Predictor`` and
``ModelServer.load_model`` from files.  ``.params`` and ``-symbol.json``
files are the JAX package's, byte for byte; ``.states`` files pickle each
package's own classes.  The operator library is the JAX package's but for
the detection, quantization, CTC and spatial-transformer ops
(ROADMAP.md), with NDArray's and Symbol's methods.  The training-loop API
is the JAX package's: its sixteen optimizers, metrics, initializers and
schedulers, the callbacks, ``engine`` (``naive``, ``bulk``, deferred
worker exceptions), ``Monitor`` (the executor's taps), ``viz``,
``registry``, ``misc`` and ``log``.
``telemetry`` (the metrics registry, the step log, tracing, the flight
recorder) and ``profiler`` record at the JAX package's sites under its
family names; ``gluon.rnn`` holds the recurrent layers and cells.  The
train-to-serve loop is the JAX package's: ``checkpoint`` (sharded,
sha256-checked, atomically committed training state, saved by ``fit``
through a ``CheckpointManager``), ``fault`` (the fault-plan runtime and
its sites), ``compile_cache`` (the built CUDA kernel libraries) and
serving's quotas, priorities, shedding, brownout, canaries, warmup
manifest and ``CheckpointWatcher``.  Across processes and GPUs:
``parallel`` (data- and model-parallel training, the message spool
``parallel.transport``), the ``dist_sync`` and ``dist_async`` kvstores
(``kvstore_server`` for launchers' server roles), ``Module`` on a list of
contexts, the replica front door ``serving.FleetFrontDoor`` and the fault
drills (``fault.drill``).  Sparse storage: ``nd.sparse`` (``CSRNDArray``,
``RowSparseNDArray``, the CSR ``dot``, ``retain``), the lazy row updates
of SGD and Adam, ``KVStore.row_sparse_pull``, ``io.LibSVMIter`` and
gluon's ``Embedding(sparse_grad=True)``.
"""
import torch as _torch

from .libinfo import __version__  # noqa: F401
from .base import MXNetError  # noqa: F401
from . import config  # noqa: F401
from . import telemetry  # noqa: F401
from . import profiler  # noqa: F401
from .context import (Context, cpu, gpu, tpu, current_context,  # noqa: F401
                      num_gpus, num_tpus)
from . import autograd  # noqa: F401
from . import attribute  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import ops  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from .symbol import Symbol  # noqa: F401
from . import name  # noqa: F401
from .name import NameManager, Prefix  # noqa: F401
from . import executor  # noqa: F401
from .executor import Executor  # noqa: F401
from .predictor import Predictor  # noqa: F401
from . import io  # noqa: F401
from . import recordio  # noqa: F401
from . import engine  # noqa: F401
from . import convert  # noqa: F401
from . import serving  # noqa: F401
from . import random  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from . import metric  # noqa: F401
from . import gradient_compression  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import kvstore_server  # noqa: F401
from . import callback  # noqa: F401
from . import model  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import executor_manager  # noqa: F401
from . import image  # noqa: F401
from . import rnn  # noqa: F401
from . import parallel  # noqa: F401
from . import gluon  # noqa: F401
from . import registry  # noqa: F401
from . import misc  # noqa: F401
from . import monitor  # noqa: F401
from .monitor import Monitor  # noqa: F401
from . import visualization  # noqa: F401
from . import visualization as viz  # noqa: F401
from . import log  # noqa: F401
from . import compile_cache  # noqa: F401
from . import checkpoint  # noqa: F401
from . import fault  # noqa: F401

_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False

# arm the fault-injection plan at import when MXNET_FAULT_PLAN is set, so
# a drilled child process is configured through its environment alone;
# unset, every instrumented site costs one boolean
if config.get("MXNET_FAULT_PLAN"):
    fault.install()
