"""Expert parallelism (MoE) over the ``ep`` mesh axis.

Counterpart of ``mxnet_tpu/parallel/moe.py`` (``switch_moe``,
``stack_experts``): experts sharded over ``ep``, tokens routed top-1 with
a capacity limit, the dispatch and return trips two all-to-alls
(Switch Transformer / GShard).  Each rank of ``ep`` is one process here:
it takes its 1/ep of the tokens (``collectives.take_block``), routes
them, exchanges the queues (``collectives.all_to_all``, whose backward is
the inverse exchange), runs its E/ep local experts one after another,
exchanges back, and the ranks' outputs are gathered into the global
(T, D) result (``collectives.gather_blocks``).

Routing math (per source rank, capacity C = max(int(cf * T_local / E),
1)):
  gate      = softmax(x @ gate_w)              (T_local, E)
  expert_id = argmax(gate)                     top-1; a tie goes to the
                                               lowest expert id
  position  = rank of the token within its expert's queue; tokens
              beyond C are dropped (their combine weight is zero)
  dispatch  : scatter-add the kept tokens into an (E, C, D) send buffer
              -> all_to_all -> each rank holds its experts' queues from
              every source
  combine   : all_to_all back, gather each token's expert output, scale
              by its gate probability.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .collectives import all_to_all, gather_blocks, take_block
from .pipeline import stack_stages as stack_experts  # same stacking helper
from .pipeline import tree_map

__all__ = ["switch_moe", "stack_experts"]


def switch_moe(x, gate_w, expert_params, expert_fn, mesh,
               capacity_factor=2.0, axis="ep"):
    """Top-1 routed mixture of experts, experts sharded over ``axis``.

    x: (T, D) tokens (global; each rank routes its 1/ep); gate_w: (D, E);
    expert_params: pytree with leading expert dim E == ep * E_local;
    expert_fn(params, tokens) -> tokens, for one expert.

    Returns the (T, D) combined outputs on every rank; dropped
    (over-capacity) tokens give zero, as capacity-limited switch routing
    does."""
    ep = mesh.shape[axis]
    E = gate_w.shape[1]
    if E % ep:
        raise MXNetError("num experts %d not divisible by ep=%d" % (E, ep))
    T = x.shape[0]
    if T % ep:
        raise MXNetError("token count %d not divisible by ep=%d" % (T, ep))
    T_local = T // ep
    C = max(int(capacity_factor * T_local / E), 1)
    x_l = take_block(x, 0, mesh, axis)
    params_l = tree_map(lambda a: take_block(a, 0, mesh, axis),
                        expert_params)
    D = x_l.shape[-1]
    probs = torch.softmax(x_l @ gate_w, dim=-1)
    eid = torch.argmax(probs, dim=-1)                        # (T_l,)
    gate = probs.gather(1, eid[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(eid, E)             # (T_l, E)
    pos_t = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = (pos_t < C).to(x_l.dtype)
    slot = pos_t.clamp(0, C - 1)
    send = x_l.new_zeros((E, C, D)).index_put(
        (eid, slot), x_l * keep[:, None], accumulate=True)
    # (E, C, D) -> (E_local, ep*C, D): this rank's experts' queues from
    # every source
    recv = all_to_all(send, 0, 1, mesh, axis)
    y = torch.stack([expert_fn(tree_map(lambda a, e=e: a[e], params_l),
                               recv[e]) for e in range(recv.shape[0])])
    back = all_to_all(y, 1, 0, mesh, axis)                   # (E, C, D)
    out = back[eid, slot] * (gate * keep)[:, None]
    return gather_blocks(out, 0, mesh, axis)
