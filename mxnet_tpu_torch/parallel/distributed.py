"""Multi-process bootstrap.

Counterpart of ``mxnet_tpu/parallel/distributed.py`` (reference: the
ps-lite scheduler and the ``DMLC_*`` topology of ``tools/launch.py``).
The JAX package initialises ``jax.distributed``; here one process drives
one card, PyTorch's idiom, and ``torch.distributed``'s process group is
the scheduler: every process runs the same program on its own device and
the data plane is NCCL collectives between them.

Where the group comes from, first match wins:

- the arguments (``coordinator_address`` "host:port", ``num_processes``,
  ``process_id``, or a ready ``init_method`` URL such as a
  ``file://`` store);
- ``tools/launch.py``'s ``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT``,
  ``DMLC_WORKER_ID`` and ``DMLC_NUM_WORKER``;
- ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE`` and ``LOCAL_RANK``.

A lone process with none of them stays a world of one, as in the JAX
package, and creates no group.  Each rank computes on
``cuda:{local_rank}``, set with ``torch.cuda.set_device`` (the local rank
is ``LOCAL_RANK``, else the first of ``local_device_ids``, else the
process id modulo the cards of this host), and the group's backend is
NCCL; gloo only where the caller asks for the CPU (``ctx=mx.cpu()`` or
inside ``with mx.cpu():``), as the tests do.  Without a card and without
that request, init raises: there is no quiet CPU world.  The group gets
a timeout (``timeout`` seconds, default 300), so a collective whose peer
is gone raises instead of hanging.
"""
from __future__ import annotations

import datetime
import os

import torch

from ..base import MXNetError
from ..context import resolve

__all__ = ["init_distributed", "rank", "num_workers", "is_initialized",
           "device", "shutdown"]

# process-wide by nature: one process group per process
_STATE = {"initialized": False, "device": None}
# how long a collective waits for a peer before it raises
_TIMEOUT_S = 300


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, ctx=None,
                     init_method=None, timeout=None):
    """Join the process group (reference: ps-lite Postoffice::Start).
    A second call is a no-op.  ``ctx`` picks the device type (default
    the current context); see the module docstring for the rest."""
    import torch.distributed as dist

    if _STATE["initialized"]:
        return
    env = os.environ
    if coordinator_address is None and init_method is None:
        uri = env.get("DMLC_PS_ROOT_URI")
        if uri:
            coordinator_address = "%s:%s" % (
                uri, env.get("DMLC_PS_ROOT_PORT", "9000"))
    if num_processes is None:
        num_processes = _env_int("DMLC_NUM_WORKER", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("DMLC_WORKER_ID", "RANK")
    if init_method is None:
        if coordinator_address is not None:
            init_method = "tcp://" + coordinator_address
        elif env.get("MASTER_ADDR") and process_id is not None:
            init_method = "env://"
    if init_method is None:
        # single process: nothing to join, collectives stay local; the
        # device is the context current where it is asked for
        _STATE.update(initialized=True,
                      device=None if ctx is None else resolve(ctx))
        return
    device = resolve(ctx)
    if num_processes is None or process_id is None:
        raise MXNetError(
            "init_distributed: %s names no world size and rank (give "
            "num_processes and process_id, or the DMLC_*/torchrun "
            "environment)" % init_method)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "init_distributed: no CUDA device for the NCCL group; ask "
                "for the CPU (ctx=mx.cpu()) to train over gloo")
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = (local_device_ids[0] if local_device_ids
                     else process_id % torch.cuda.device_count())
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout or _TIMEOUT_S))
    _STATE.update(initialized=True, device=device)


def is_initialized():
    return _STATE["initialized"]


def _group_up():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank():
    """Reference: KVStore::get_rank (kvstore.h:319)."""
    import torch.distributed as dist
    return dist.get_rank() if _group_up() else 0


def num_workers():
    """Reference: KVStore::get_group_size (kvstore.h:326)."""
    import torch.distributed as dist
    return dist.get_world_size() if _group_up() else 1


def device():
    """This rank's ``torch.device``: ``cuda:{local_rank}`` in an NCCL
    world, the CPU in a gloo one; before init, the current context's."""
    return _STATE["device"] if _STATE["device"] is not None \
        else resolve(None)


def shutdown():
    """Leave the process group so this process may join another (a lone
    process just forgets its state).  Collective: every rank meets at a
    barrier first, so none tears its group down while a peer's last
    collective is still in flight (gloo aborts the process then), and the
    meshes built on the group are forgotten: the trainers and meshes that
    are garbage now (a trainer's hooks hold it in a cycle) go before their
    groups do, not at interpreter exit, where a gloo group's destructor
    aborts the process."""
    import gc
    import torch.distributed as dist
    from . import mesh
    if _group_up():
        dist.barrier()
        mesh._DEVICE_MESHES.clear()
        gc.collect()
        dist.destroy_process_group()
    _STATE.update(initialized=False, device=None)
