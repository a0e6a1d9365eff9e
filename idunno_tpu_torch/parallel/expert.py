"""Switch-style top-1 dispatch of tokens to experts, a port of the
single-device half of ``idunno_tpu/parallel/expert.py``.

Tokens are routed to one expert each and packed into fixed ``[E, C, d]``
capacity buffers (static shapes; overflow tokens are dropped, the standard
switch trade-off). ``switch_dispatch`` builds the one-hot dispatch and the
gate-weighted combine tensors that `models/moe.py:SwitchFFN` contracts on
its dense path, where every expert lives on the one device.

Every op here is shape-static and reads nothing back to the host, so a
routed decode step can be recorded as a CUDA graph: one-hots are
comparisons against an ``arange``, never ``F.one_hot`` with an inferred
class count.

``expert_parallel_apply``, the all-to-all exchange over a mesh axis, comes
with expert parallelism (ROADMAP.md §1, step 3e) and raises until then.
"""
from __future__ import annotations

import torch

EXPERT_AXIS = "expert"


def switch_dispatch(gate_idx: torch.Tensor, gate_w: torch.Tensor,
                    n_experts: int, capacity: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 dispatch/combine tensors for local tokens.

    gate_idx [n] int, gate_w [n] float → dispatch one-hot [n, E, C] and
    combine (= dispatch · gate weight) [n, E, C], both f32. A token's slot
    is its rank among the earlier tokens routed to the same expert (a
    cumulative sum of the one-hots); tokens beyond an expert's capacity
    get all-zero rows (dropped).
    """
    dev = gate_idx.device
    experts = torch.arange(n_experts, device=dev)
    onehot = (gate_idx[:, None] == experts).to(torch.float32)       # [n, E]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0                # [n, E]
    in_cap = (pos >= 0) & (pos < capacity)
    slots = torch.arange(capacity, device=dev)
    pos_oh = (pos.to(torch.int64)[..., None] == slots).to(torch.float32)
    dispatch = pos_oh * in_cap[..., None].to(torch.float32)         # [n,E,C]
    combine = dispatch * gate_w.to(torch.float32)[:, None, None]
    return dispatch, combine


def expert_parallel_apply(*args, **kwargs):
    """The MoE layer with its experts sharded over a mesh axis (the JAX
    package's all-to-all dispatch): not ported yet."""
    raise ValueError("expert parallelism (expert_parallel_apply, mesh=) is "
                     "not ported yet: it comes with the parallelism slice, "
                     "ROADMAP.md §1 step 3e")
