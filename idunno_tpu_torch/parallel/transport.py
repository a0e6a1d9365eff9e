"""The one place where tensors cross processes.

The JAX package moves blocks between the devices of a mesh with XLA's
collectives (``ppermute``, ``all_to_all``, ``psum``); across hosts, after
``jax.distributed.initialize``, the same collectives run over every
process's devices. The port's processes join a ``torch.distributed``
group (``parallel/mesh.py:initialize_distributed``), and every tensor
that leaves a process or arrives in one goes through this module:

- `exchange`: one round of point-to-point transfers
  (``dist.batch_isend_irecv``: every send and receive of the round is
  posted at once and then waited for, so a ring whose processes all send
  cannot deadlock). The ring of ring attention and the pipeline's hops
  use it; a hop between two groups of one process stays a device copy and
  never comes here.
- `all_to_all`: the tiled all-to-all of ``jax.lax.all_to_all(...,
  tiled=True)`` over the positions of a mesh axis, differentiable: across
  processes the forward is one ``dist.all_to_all_single`` and the
  backward the mirror exchange. Ulysses' regroupings and the experts'
  exchange use it; in one process it is the device copies it always was.
- `Backflow`: the gradients of a differentiable forward whose tensors
  crossed processes by `exchange` (the pipeline's activations). An
  arriving tensor is a leaf of its process's graph; after that process's
  backward its gradient goes back to the sender, and the sender's
  backward starts from the gradients of what it sent. Both sides send and
  receive in the hops' key order, so the order never depends on the
  order autograd visits its nodes.
- `all_reduce` and `all_gather`: the data axis's sums and the FSDP gather
  (``parallel/data.py``), and the metrics of a step.

The staging rule: under NCCL a CUDA tensor is sent as it is. Under gloo a
CUDA tensor is copied to a host buffer, the host buffer crosses, and what
arrives in a host buffer is copied to its device, here and nowhere else:
gloo's point-to-point takes the tensor's data pointer as host memory and
does not read device memory. `COUNTS` counts the tensors sent and the
bytes staged (copied device to host or host to device) in this process.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import torch


@dataclass
class TransportCounts:
    """What crossed processes from (or into) this process: ``hops``
    tensors sent point to point, ``exchanges`` all-to-alls, ``reductions``
    sums and gathers, and ``bytes_staged`` through the host."""

    hops: int = 0
    exchanges: int = 0
    reductions: int = 0
    bytes_staged: int = 0

    def reset(self) -> None:
        self.hops = self.exchanges = self.reductions = self.bytes_staged = 0

    def as_dict(self) -> dict:
        return {"hops": self.hops, "exchanges": self.exchanges,
                "reductions": self.reductions,
                "bytes_staged": self.bytes_staged}


COUNTS = TransportCounts()


def _dist():
    import torch.distributed as dist

    return dist


def staged(device: torch.device) -> bool:
    """Whether a tensor on ``device`` crosses through a host buffer: a
    CUDA tensor under gloo (module docstring)."""
    return torch.device(device).type == "cuda" and \
        _dist().get_backend() == "gloo"


def _outbound(t: torch.Tensor) -> torch.Tensor:
    """What goes on the wire for ``t``: its host copy when staged, else
    ``t`` contiguous."""
    t = t.detach()
    if staged(t.device):
        COUNTS.bytes_staged += t.numel() * t.element_size()
        return t.to("cpu").contiguous()
    return t.contiguous()


def _landing(shape, dtype, device) -> torch.Tensor:
    """An empty buffer for what arrives for ``device``: on the host when
    staged."""
    return torch.empty(shape, dtype=dtype,
                       device="cpu" if staged(device) else device)


def _landed(buf: torch.Tensor, device) -> torch.Tensor:
    """An arrived buffer on its device."""
    if buf.device == torch.device(device):
        return buf
    COUNTS.bytes_staged += buf.numel() * buf.element_size()
    return buf.to(device)


def exchange(sends: list, recvs: list) -> list[torch.Tensor]:
    """One round of point-to-point transfers. ``sends`` are ``(tensor,
    rank)`` pairs, ``recvs`` ``((shape, dtype, device), rank)`` pairs; the
    ``i``-th send to a process pairs with that process's ``i``-th receive
    from this one, so both sides list a round's transfers in one agreed
    order. Returns the received tensors, on their devices, in ``recvs``
    order."""
    if not sends and not recvs:
        return []
    dist = _dist()
    ops, wires, landings = [], [], []
    tags: Counter = Counter()
    for t, rank in sends:
        wire = _outbound(t)
        wires.append(wire)
        ops.append(dist.P2POp(dist.isend, wire, rank, tag=tags["s", rank]))
        tags["s", rank] += 1
    for (shape, dtype, device), rank in recvs:
        buf = _landing(shape, dtype, device)
        landings.append((buf, device))
        ops.append(dist.P2POp(dist.irecv, buf, rank, tag=tags["r", rank]))
        tags["r", rank] += 1
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    COUNTS.hops += len(sends)
    return [_landed(buf, device) for buf, device in landings]


# -- the tiled all-to-all ---------------------------------------------------

def all_to_all(parts: list, cells, *, split_axis: int,
               concat_axis: int) -> list:
    """``jax.lax.all_to_all(..., tiled=True)`` over the positions of an
    axis (``parallel/mesh.py:AxisCells``): ``parts`` are this process's
    positions' tensors (of one shape, in axis order); position ``j``
    receives chunk ``j`` of every position's part (cut into ``len(cells)``
    equal chunks along ``split_axis``) on its device, concatenated along
    ``concat_axis`` in source order. Returns this process's positions'
    results, differentiable."""
    if not cells.spans:
        p = len(parts)
        chunks = [part.tensor_split(p, dim=split_axis) for part in parts]
        return [torch.cat([chunks[s][j].to(dev) for s in range(p)],
                          dim=concat_axis)
                for j, dev in enumerate(cells.devices)]
    return list(_AllToAll.apply(cells, split_axis, concat_axis, *parts))


def _tiles(parts, cells, split_axis: int, concat_axis: int) -> list:
    """The cross-process tiled all-to-all: chunks between this process's
    positions stay device copies; the rest cross in one
    ``all_to_all_single`` of their bytes (each process's block holds, for
    each of the receiver's positions in order, the chunk of each of the
    sender's positions in order)."""
    dist = _dist()
    p, mine = len(cells), cells.mine
    world = dist.get_world_size()
    if set(cells.ranks) != set(range(world)):
        raise ValueError(f"an all-to-all over positions of processes "
                         f"{sorted(set(cells.ranks))} needs every process "
                         f"of the group of {world}")
    if len(parts) != len(mine):
        raise ValueError(f"{len(parts)} parts for this process's "
                         f"{len(mine)} positions")
    chunks = {s: part.tensor_split(p, dim=split_axis)
              for s, part in zip(mine, parts)}
    like = chunks[mine[0]][0]
    shape, dtype, nbytes = like.shape, like.dtype, like.numel() * \
        like.element_size()
    owned = {r: [i for i in range(p) if cells.ranks[i] == r]
             for r in range(world)}
    device = parts[0].device
    out_blocks, in_sizes, out_sizes = [], [], []
    for r in range(world):
        if r == cells.rank:
            in_sizes.append(0)
            out_sizes.append(0)
            continue
        for j in owned[r]:
            for s in mine:
                out_blocks.append(chunks[s][j].contiguous().view(-1)
                                  .view(torch.uint8))
        in_sizes.append(len(owned[r]) * len(mine) * nbytes)
        out_sizes.append(len(mine) * len(owned[r]) * nbytes)
    send = _outbound(torch.cat(out_blocks))
    recv = _landing((sum(out_sizes),), torch.uint8, device)
    dist.all_to_all_single(recv, send, output_split_sizes=out_sizes,
                           input_split_sizes=in_sizes)
    COUNTS.exchanges += 1
    recv = _landed(recv, device)
    arrived, off = {}, 0
    for r in range(world):
        if r == cells.rank:
            continue
        for j in mine:
            for s in owned[r]:
                arrived[s, j] = recv[off:off + nbytes].view(dtype).view(shape)
                off += nbytes
    return [torch.cat([chunks[s][j].to(cells.devices[j]) if cells.local(s)
                       else arrived[s, j].to(cells.devices[j])
                       for s in range(p)], dim=concat_axis)
            for j in mine]


class _AllToAll(torch.autograd.Function):
    """The cross-process tiled all-to-all; its backward is the mirror one
    (the split and concatenation axes swapped), which every process runs
    in the same order as its forwards, as autograd visits the same graph
    in each."""

    @staticmethod
    def forward(ctx, cells, split_axis, concat_axis, *parts):
        ctx.cells, ctx.axes = cells, (split_axis, concat_axis)
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in parts]
        return tuple(_tiles(parts, cells, split_axis, concat_axis))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        split_axis, concat_axis = ctx.axes
        outs = [(g if g is not None else torch.zeros(s, dtype=t, device=d))
                for g, (s, t, d) in zip(grads, _out_shapes(ctx))]
        back = _tiles(outs, ctx.cells, concat_axis, split_axis)
        return (None, None, None, *back)


def _out_shapes(ctx) -> list:
    """The shapes of the forward's outputs, on their positions' devices
    (for a gradient autograd left as None)."""
    split_axis, concat_axis = ctx.axes
    shape, dtype, _ = ctx.shapes[0]
    out = list(shape)
    out[split_axis] //= len(ctx.cells)
    out[concat_axis] *= len(ctx.cells)
    return [(tuple(out), dtype, ctx.cells.devices[j]) for j in ctx.cells.mine]


# -- the gradients of hops ----------------------------------------------------

class Backflow:
    """The differentiable hops of one forward (the pipeline's activations
    between stages of different processes), and their backward. `hop`
    moves a round's tensors; each is keyed (the same key on both sides:
    the pipeline's row, stage and microbatch). `backward` runs this
    process's part of the backward (module docstring)."""

    def __init__(self) -> None:
        self.sent: dict = {}         # key → (tensor with its graph, rank)
        self.arrived: dict = {}      # key → (leaf that arrived, rank)

    def hop(self, sends: list, recvs: list) -> list[torch.Tensor]:
        """`exchange` of ``sends`` ``(key, tensor, rank)`` and ``recvs``
        ``(key, (shape, dtype, device), rank)``; with gradients on, the
        sent tensors are kept and the arrived ones are leaves that take
        gradients."""
        got = exchange([(t, r) for _, t, r in sends],
                       [(like, r) for _, like, r in recvs])
        if not torch.is_grad_enabled():
            return got
        for key, t, rank in sends:
            self.sent[key] = (t, rank)
        out = []
        for (key, _, rank), t in zip(recvs, got):
            t.requires_grad_(True)
            self.arrived[key] = (t, rank)
            out.append(t)
        return out

    def backward(self, loss: torch.Tensor | None = None) -> None:
        """This process's backward: the gradients of what it sent, from
        the processes that took it, then one backward from those and from
        ``loss`` (where the loss lives here), then the gradients of what
        arrived, back to their senders, each in key order."""
        keys = sorted(self.sent)
        grads = exchange([], [((t.shape, t.dtype, t.device), r) for t, r in
                              (self.sent[k] for k in keys)])
        roots = [self.sent[k][0] for k in keys]
        if loss is not None:
            roots.append(loss)
            grads.append(torch.ones_like(loss))
        if roots:
            torch.autograd.backward(roots, grads)
        back = []
        for key in sorted(self.arrived):
            t, rank = self.arrived[key]
            back.append((t.grad if t.grad is not None
                         else torch.zeros_like(t), rank))
        exchange(back, [])
        self.sent.clear()
        self.arrived.clear()


# -- sums, gathers, broadcasts ------------------------------------------------

def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process of the group, in place (staged
    through the host under gloo); returns ``t``."""
    dist = _dist()
    wire = _outbound(t)
    dist.all_reduce(wire)
    COUNTS.reductions += 1
    if wire.data_ptr() != t.data_ptr():
        t.copy_(_landed(wire, t.device))
    return t


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``t`` (one shape), in rank order, on ``t``'s
    device."""
    dist = _dist()
    wire = _outbound(t)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, wire)
    COUNTS.reductions += 1
    return [_landed(x, t.device) for x in parts]


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """Process ``src``'s ``t`` on every process (``t`` gives the shape,
    dtype and device elsewhere); returns a new tensor."""
    dist = _dist()
    wire = _outbound(t) if dist.get_rank() == src else \
        _landing(t.shape, t.dtype, t.device)
    dist.broadcast(wire, src)
    COUNTS.reductions += 1
    return _landed(wire, t.device) if dist.get_rank() != src else t.detach()
