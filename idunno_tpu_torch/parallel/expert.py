"""Expert parallelism: switch-style top-1 MoE dispatch by all-to-all, a
port of ``idunno_tpu/parallel/expert.py``.

Tokens are routed to one expert each and packed into fixed ``[E, C, d]``
capacity buffers (static shapes; overflow tokens are dropped, the standard
switch trade-off). ``switch_dispatch`` builds the one-hot dispatch and the
gate-weighted combine tensors that `models/moe.py:SwitchFFN` contracts on
its dense path, where every expert lives on the one device.

``expert_parallel_apply`` runs the layer with its experts sharded over an
axis of a ``parallel/mesh.py:Mesh`` (the JAX package's ``shard_map`` with
two tiled ``all_to_all``\\ s, written out): each shard dispatches its own
block of tokens, one exchange (`all_to_all`) gives every shard the
buffers of the experts it owns, the local expert FFNs run, and the mirror
exchange returns the outputs to the tokens' shards for the combine. Within
one process an exchange is copies between the mesh's devices (none on a
virtual mesh, whose shards share one device); across processes (an
expert axis whose positions belong to several processes) each process
drives its own shards on its own block of tokens and an exchange is
``parallel/transport.py:all_to_all`` (one ``all_to_all_single``, the
mirror one in the backward). Autograd runs through both.

Every op here is shape-static and reads nothing back to the host, so a
routed decode step can be recorded as a CUDA graph: one-hots are
comparisons against an ``arange``, never ``F.one_hot`` with an inferred
class count.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from idunno_tpu_torch.parallel import transport
from idunno_tpu_torch.parallel.mesh import EXPERT_AXIS, Mesh
from idunno_tpu_torch.utils.tracing import annotate

# profiler ranges around the [n, E, C] dispatch (building the tensors and
# packing the expert buffers), the exchanges between expert shards, and
# the combine: the kernels launched inside each, and the backward of the
# ops recorded there, are its device time
DISPATCH_SPAN, EXCHANGE_SPAN, COMBINE_SPAN = ("moe.dispatch",
                                              "moe.all_to_all",
                                              "moe.combine")


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


def all_to_all(parts: list, cells, *, split_axis: int,
               concat_axis: int) -> list:
    """``jax.lax.all_to_all(..., tiled=True)`` over the shards of an expert
    axis (``parallel/mesh.py:AxisCells``): shard ``j`` receives chunk
    ``j`` of every shard's part (cut into ``len(cells)`` equal chunks along
    ``split_axis``) on its device, concatenated along ``concat_axis`` in
    source-shard order; ``parts`` and the result are this process's
    shards' (``parallel/transport.py:all_to_all``)."""
    return transport.all_to_all(parts, cells, split_axis=split_axis,
                                concat_axis=concat_axis)


def _shard_params(stacked_params, cells) -> list[dict]:
    """This process's shards' expert params on their devices: a dict of
    [E, ...] leaves cut into ``len(cells)`` contiguous blocks of experts,
    or a list of per-shard dicts, the p shards' or this process's
    (moved where a leaf lies elsewhere)."""
    p, mine = len(cells), cells.mine
    if isinstance(stacked_params, dict):
        cut = {k: v.tensor_split(p, dim=0) for k, v in stacked_params.items()}
        return [{k: v[s].to(cells.devices[s]) for k, v in cut.items()}
                for s in mine]
    if len(stacked_params) == p and p != len(mine):
        stacked_params = [stacked_params[s] for s in mine]
    if len(stacked_params) != len(mine):
        raise ValueError(f"{len(stacked_params)} expert shards' params for "
                         f"an axis of {p}")
    return [{k: v.to(cells.devices[s]) for k, v in sp.items()}
            for sp, s in zip(stacked_params, mine)]


def expert_parallel_apply(expert_fn: Callable[[Any, torch.Tensor],
                                              torch.Tensor],
                          stacked_params, x: torch.Tensor,
                          gate_idx: torch.Tensor, gate_w: torch.Tensor,
                          mesh: Mesh, *, axis: str = EXPERT_AXIS,
                          capacity: int) -> torch.Tensor:
    """Run the MoE layer with experts sharded over ``axis`` of ``mesh``.

    ``x`` [N, d] and the gates [N] are cut over the axis's shards in
    contiguous blocks, in order (N divisible by the axis size); across
    processes they are this process's rows, cut over its own shards.
    ``stacked_params`` are the experts' params: a dict of [E, ...] leaves,
    shard ``s`` owning experts ``[s·E/p, (s+1)·E/p)`` (E divisible by the
    axis size), or a list of the p shards' dicts of [E/p, ...] leaves
    (across processes: or of this process's shards').
    ``expert_fn(params, buf)`` runs a shard's experts on their buffers
    [E/p, p·C, d] (batched over the leading expert axis: the JAX
    ``vmap(expert_fn)``) and returns them in f32. Each shard dispatches its
    own tokens at ``capacity`` slots an expert, so which tokens drop
    depends on the axis size, as in the JAX package. Returns [N, d] f32 on
    ``x``'s device (this process's rows across processes)."""
    cells = mesh.along(axis)
    p, mine = len(cells), cells.mine
    shards = _shard_params(stacked_params, cells)
    if isinstance(stacked_params, dict):
        n_experts = next(iter(stacked_params.values())).shape[0]
    else:        # the p shards', or this process's shards' of p
        n_experts = sum(next(iter(sp.values())).shape[0]
                        for sp in stacked_params) * p // len(stacked_params)
    if n_experts % p:
        raise ValueError(f"{n_experts} experts not divisible by {axis!r} "
                         f"axis size {p}")
    n = x.shape[0]
    if n % len(mine):
        raise ValueError(f"{n} routing units not divisible by {axis!r} "
                         f"axis size {len(mine)}")
    per = n // len(mine)
    bufs, combines = [], []
    with annotate(DISPATCH_SPAN):
        for b, s in enumerate(mine):
            dev = cells.devices[s]
            rows = slice(b * per, (b + 1) * per)
            dispatch, combine = switch_dispatch(
                gate_idx[rows].to(dev), gate_w[rows].to(dev), n_experts,
                capacity)
            bufs.append(torch.einsum("nec,nd->ecd", dispatch,
                                     x[rows].to(dev, torch.float32)))
            combines.append(combine)
    with annotate(EXCHANGE_SPAN):
        # group tokens by owning shard: [E/p, p·C, d] on each owner
        bufs = all_to_all(bufs, cells, split_axis=0, concat_axis=1)
    outs = [expert_fn(sp, buf) for sp, buf in zip(shards, bufs)]
    with annotate(EXCHANGE_SPAN):
        # and back to the tokens' shards: [E, C, d] on each source
        outs = all_to_all(outs, cells, split_axis=1, concat_axis=0)
    with annotate(COMBINE_SPAN):
        return torch.cat([
            torch.einsum("ecd,nec->nd", out, combine).to(x.device)
            for out, combine in zip(outs, combines)])
