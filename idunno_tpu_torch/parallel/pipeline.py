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
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_map

from idunno_tpu_torch.parallel.mesh import STAGE_AXIS, Mesh


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
    ``s`` of every [p, ...] leaf of a stacked dict."""
    if isinstance(stage_params, (list, tuple, torch.nn.ModuleList)):
        if len(stage_params) != p:
            raise ValueError(f"{len(stage_params)} stages' params for "
                             f"{p} stages")
        return [tree_map(lambda a, dev=dev: a.to(dev)
                         if isinstance(a, torch.Tensor) else a, sp)
                for sp, dev in zip(stage_params, devices)]
    return [tree_map(lambda a, s=s, dev=dev: a[s].to(dev), stage_params)
            for s, dev in enumerate(devices)]


def run_stages(stage_fn, stage_params, microbatches: torch.Tensor,
               devices: list) -> torch.Tensor:
    """One row of stages through the GPipe schedule: stage ``s`` on
    ``devices[s]`` (``stage_params`` as in `pipeline_apply`). As in the
    JAX package, the output buffer starts at zeros and the last stage
    writes microbatch ``t - (p - 1)`` at slot ``t``. Returns [M, mb, ...]
    on the microbatches' device."""
    p, m = len(devices), microbatches.shape[0]
    params = _placed(stage_params, p, devices)
    outs: list = [None] * m
    held: dict = {}                  # stage → what it passes on next slot
    for _, slot in itertools.groupby(gpipe_slots(m, p),
                                     key=lambda entry: entry[0]):
        passed = {}
        for _, s, i in slot:
            x = microbatches[i] if s == 0 else held[s - 1]
            y = stage_fn(params[s], x.to(devices[s]))
            if s == p - 1:
                outs[i] = y
            else:
                passed[s] = y
        held = passed
    return torch.stack([torch.zeros_like(microbatches[i]) if o is None
                        else o.to(microbatches.device)
                        for i, o in enumerate(outs)])


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
    groups). Without it, the mesh's first row runs the whole batch."""
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
    outs = [run_stages(stage_fn, stage_params, part, devs)
            for devs, part in rows]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
