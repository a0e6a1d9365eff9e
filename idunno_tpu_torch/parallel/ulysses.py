"""Ulysses sequence parallelism, a port of ``idunno_tpu/parallel/ulysses.py``.

The second long-context strategy beside ring attention
(``parallel/ring_attention.py``): q/k/v, cut on the sequence over the
``seq_axis`` groups (``[B, T/p, H, D]`` a group), are regrouped by heads,
``[B, T, H/p, D]`` on each group's device; each group runs the local
attention over the whole sequence for its head group, and the reverse
regrouping restores the sequence cut. The JAX package does each
regrouping as one ``all_to_all``, and so does the port
(``parallel/transport.py:all_to_all``): within one process it is a copy
of each group's slice to its new group's device (on a virtual mesh, the
same card) and a concatenation, across processes one
``all_to_all_single``, whose backward is the mirror exchange. Autograd
carries the gradients back through the regroupings; with ``local_attn=
flash_attention`` each group runs the flash forward K2 and, in the
backward, K4 and K5 (``ops/flash_attention.py:FlashAttention``): p K2
launches a call, each process launching its own groups'. Over a mesh
across processes q/k/v and the output are this process's slice of the
sequence (``parallel/ring_attention.py``).

Ulysses needs the head count divisible by the axis size; ring attention
does not.
"""
from __future__ import annotations

import torch

from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.parallel import transport
from idunno_tpu_torch.parallel.mesh import DATA_AXIS, AxisCells, Mesh


def _to_heads(parts: list[torch.Tensor],
              cells: AxisCells) -> list[torch.Tensor]:
    """Sequence-cut ``[B, T/p, H, D]`` parts → head-cut ``[B, T, H/p, D]``
    parts: group ``h`` gets head group ``h`` of every part, in sequence
    order, on its device."""
    return transport.all_to_all(parts, cells, split_axis=2, concat_axis=1)


def _to_seq(parts: list[torch.Tensor],
            cells: AxisCells) -> list[torch.Tensor]:
    """The reverse of `_to_heads`: head-cut parts → sequence-cut parts,
    group ``g`` gets sequence block ``g`` of every head group, in head
    order."""
    return transport.all_to_all(parts, cells, split_axis=1, concat_axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, *, seq_axis: str = DATA_AXIS,
                      causal: bool = False,
                      local_attn=full_attention) -> torch.Tensor:
    """Attention with the sequence dim cut over ``seq_axis``.

    q/k/v: [B, T, H, D], T and H divisible by the axis size. Returns
    [B, T, H, D] on q's device — a drop-in for ``ring_attention`` where
    the head count allows it. ``local_attn`` is the attention of one
    group's heads over the whole sequence: ``full_attention`` by default,
    or ``ops/flash_attention.py:flash_attention`` (K2, K4, K5 on a
    card). Over a mesh across processes T is this process's slice."""
    cells = mesh.along(seq_axis)
    p, mine = len(cells), cells.mine
    if q.shape[2] % p:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the "
            f"{seq_axis!r} axis size ({p}); use ring_attention instead")
    if q.shape[1] % len(mine):
        raise ValueError(f"sequence {q.shape[1]} not divisible by the "
                         f"{seq_axis!r} axis size {len(mine)}")
    qh, kh, vh = (_to_heads([c.to(cells.devices[j]) for c, j in
                             zip(x.chunk(len(mine), dim=1), mine)], cells)
                  for x in (q, k, v))
    outs = [local_attn(a, b, c, causal=causal)
            for a, b, c in zip(qh, kh, vh)]
    return torch.cat([o.to(q.device) for o in _to_seq(outs, cells)],
                     dim=1)
