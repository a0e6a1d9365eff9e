"""Pipeline parallelism: the GPipe microbatch schedule over a stage axis,
a port of ``idunno_tpu/parallel/pipeline.py``.

A layer stack cut into ``p`` stages, one per group of the mesh's
``stage`` axis (``parallel/mesh.py:STAGE_AXIS``). Microbatches stream
through the stages and each activation hops from one stage's device to
the next one's (a device-to-device copy; on a virtual mesh, the same
card). The schedule is the classic GPipe fill/steady/drain of M + p - 1
slots: at slot ``t`` stage ``s`` takes microbatch ``t - s`` when it is in
range (`gpipe_slots`). The JAX package runs every stage at once as one
SPMD program; a single controller runs a slot's stages one after
another, which changes the order of the work and not its values. The
schedule is plain tensor ops, so autograd differentiates it and the same
function serves inference and training.

Across processes (a stage axis whose columns belong to several
processes, ``parallel/mesh.py:global_mesh(..., across=STAGE_AXIS)``), a
stage runs in the process that owns its cell and each process runs its
own stages of every slot. After a slot's stages, the activations bound
for another process's stage cross in one exchange
(``parallel/transport.py``), every process exchanging at every slot, as
the JAX package's ``ppermute`` does. Their gradients come back through a
``transport.Backflow``: a process's backward starts from the gradients
of what it sent, so the backward runs from the last stage's process to
the first's.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_map

from idunno_tpu_torch.parallel import transport
from idunno_tpu_torch.parallel.mesh import STAGE_AXIS, AxisCells, Mesh


def stack_stage_params(per_stage: list[Any]) -> Any:
    """Stack p structurally identical per-stage param trees (dicts of
    tensors) along a new leading stage dim (leaf [p, ...])."""
    return tree_map(lambda *xs: torch.stack(xs), per_stage[0], *per_stage[1:])


def split_microbatches(x: torch.Tensor, num: int) -> torch.Tensor:
    """[N, ...] → [num, N/num, ...]."""
    if x.shape[0] % num:
        raise ValueError(f"batch {x.shape[0]} not divisible by {num}")
    return x.reshape(num, x.shape[0] // num, *x.shape[1:])


def gpipe_slots(m: int, p: int):
    """The GPipe schedule of ``m`` microbatches over ``p`` stages: (slot,
    stage, microbatch) for every stage that works in a slot, slot by
    slot."""
    for t in range(m + p - 1):
        for s in range(p):
            if 0 <= t - s < m:
                yield t, s, t - s


def _placed(stage_params, p: int, devices: list) -> list:
    """Each stage's params on its stage's device: stage ``s`` of a list of
    p per-stage values (moved where a tensor lies elsewhere), or slice
    ``s`` of every [p, ...] leaf of a stacked dict; None for a stage of
    another process (its device None)."""
    if isinstance(stage_params, (list, tuple, torch.nn.ModuleList)):
        if len(stage_params) != p:
            raise ValueError(f"{len(stage_params)} stages' params for "
                             f"{p} stages")
        return [None if dev is None else
                tree_map(lambda a, dev=dev: a.to(dev)
                         if isinstance(a, torch.Tensor) else a, sp)
                for sp, dev in zip(stage_params, devices)]
    return [None if dev is None else
            tree_map(lambda a, s=s, dev=dev: a[s].to(dev), stage_params)
            for s, dev in enumerate(devices)]


def _hand_on(passed: dict, slot: list, cells: AxisCells, like: tuple,
             flow, key: tuple) -> dict:
    """What each stage of a slot passes to the next one's stage for the
    next slot: a device copy within the process (made where it is used),
    one exchange for the activations that cross processes (through
    ``flow`` when the hops are differentiable). ``like`` is (shape,
    dtype) of an activation; ``key`` tells this row's hops apart."""
    p = len(cells)
    held = {s: y for s, y in passed.items() if cells.local(s + 1)}
    sends, recvs = [], []
    for _, s, i in slot:
        if s == p - 1 or cells.local(s) == cells.local(s + 1):
            continue
        if cells.local(s):
            sends.append((key + (s, i), passed[s], cells.ranks[s + 1]))
        else:
            recvs.append((key + (s, i), like + (cells.devices[s + 1],),
                          cells.ranks[s]))
    if flow is None:
        if (sends or recvs) and torch.is_grad_enabled():
            raise ValueError("activations that cross processes with "
                             "gradients on need a transport.Backflow "
                             "(run_stages(..., flow=))")
        got = transport.exchange([(t, r) for _, t, r in sends],
                                 [(x, r) for _, x, r in recvs])
    else:
        got = flow.hop(sends, recvs)
    held.update({k[-2]: t for (k, _, _), t in zip(recvs, got)})
    return held


def run_stages(stage_fn, stage_params, microbatches: torch.Tensor,
               cells, *, flow=None, key: tuple = ()) -> torch.Tensor | None:
    """One row of stages through the GPipe schedule: stage ``s`` on
    position ``s`` of ``cells`` (``parallel/mesh.py:AxisCells``;
    ``stage_params`` as in `pipeline_apply`). As in the JAX package, the output buffer starts at
    zeros and the last stage writes microbatch ``t - (p - 1)`` at slot
    ``t``. Returns [M, mb, ...] on the microbatches' device (the last
    stage's where they are a ``meta`` tensor, which only gives this
    process the shape and dtype of an activation); None in a process
    without the last stage. Across processes the hops go through the
    transport, their gradients through ``flow`` (a
    ``transport.Backflow``; None: no gradients cross), each keyed by
    ``key`` + (stage, microbatch)."""
    p, m = len(cells), microbatches.shape[0]
    params = _placed(stage_params, p, cells.devices)
    like = (tuple(microbatches.shape[1:]), microbatches.dtype)
    outs: list = [None] * m
    held: dict = {}                  # stage → what it passes on next slot
    for _, entries in itertools.groupby(gpipe_slots(m, p),
                                        key=lambda entry: entry[0]):
        slot, passed = list(entries), {}
        for _, s, i in slot:
            if not cells.local(s):
                continue
            x = microbatches[i] if s == 0 else held[s - 1]
            y = stage_fn(params[s], x.to(cells.devices[s]))
            if s == p - 1:
                outs[i] = y
            else:
                passed[s] = y
        held = _hand_on(passed, slot, cells, like, flow, key)
    if not cells.local(p - 1):
        return None
    home = (cells.devices[p - 1] if microbatches.device.type == "meta"
            else microbatches.device)
    return torch.stack([torch.zeros(like[0], dtype=like[1], device=home)
                        if o is None else o.to(home) for o in outs])


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor,
                   mesh: Mesh, *, axis: str = STAGE_AXIS,
                   data_axis: str | None = None) -> torch.Tensor:
    """Run microbatches through the p-stage pipeline.

    stage_fn: (one stage's params, activation [mb, ...]) → [mb, ...]
      (the activation's shape must be the same at every stage, e.g.
      transformer blocks).
    stage_params: a dict tree with leaves [p, ...] (`stack_stage_params`;
      stage ``s``'s slice is moved to its device each call), or a list of
      the p stages' params (modules or trees) on their stages' devices.
    microbatches: [M, mb, ...], the global input.
    Returns [M, mb, ...] on the microbatches' device: equal to
    stage_{p-1}(...stage_0(x)).

    With ``data_axis`` (the mesh's other axis) the microbatch dim mb is
    cut over it: each data group runs the same schedule on its slice of
    every microbatch on its row of the mesh (PP x DP), with the stage
    params copied to its row (autograd sums their gradients over the
    groups). Without it, the mesh's first row runs the whole batch.

    Over a mesh across processes each process runs its own stages and
    returns the output, which the last stage's process sends to every
    other (as the JAX package's ``psum`` of the last stage's output
    replicates it); no gradient crosses processes here: the pipelined LM
    step (``engine/pipeline_lm.py``) differentiates through a
    ``transport.Backflow``."""
    if data_axis is None:
        rows = [(mesh.along(axis, 0), microbatches)]
    else:
        dp = mesh.shape[data_axis]
        if microbatches.shape[1] % dp:
            raise ValueError(
                f"microbatch size {microbatches.shape[1]} not divisible by "
                f"data axis {data_axis!r} size {dp}")
        rows = [(mesh.along(axis, d), part) for d, part in
                enumerate(microbatches.chunk(dp, dim=1))]
    if not rows[0][0].spans:
        outs = [run_stages(stage_fn, stage_params, part, cells)
                for cells, part in rows]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    outs = []
    for d, (cells, part) in enumerate(rows):
        with torch.no_grad():
            y = run_stages(stage_fn, stage_params, part, cells, key=(d,))
        outs.append(transport.broadcast(
            part if y is None else y, cells.ranks[-1]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
