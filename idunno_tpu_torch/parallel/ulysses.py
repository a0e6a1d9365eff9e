"""Ulysses sequence parallelism, a port of ``idunno_tpu/parallel/ulysses.py``.

The second long-context strategy beside ring attention
(``parallel/ring_attention.py``): q/k/v, cut on the sequence over the
``seq_axis`` groups (``[B, T/p, H, D]`` a group), are regrouped by heads,
``[B, T, H/p, D]`` on each group's device; each group runs the local
attention over the whole sequence for its head group, and the reverse
regrouping restores the sequence cut. The JAX package does each
regrouping as one ``all_to_all``; on a single controller it is a copy of
each group's slice to its new group's device (on a virtual mesh, the same
card) and a concatenation. The regroupings are plain tensor ops, so
autograd carries the gradients back through them; with ``local_attn=
flash_attention`` each group runs the flash forward K2 and, in the
backward, K4 and K5 (``ops/flash_attention.py:FlashAttention``): p K2
launches a call.

Ulysses needs the head count divisible by the axis size; ring attention
does not.
"""
from __future__ import annotations

import torch

from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def _to_heads(parts: list[torch.Tensor], devices: list) -> list[torch.Tensor]:
    """Sequence-cut ``[B, T/p, H, D]`` parts → head-cut ``[B, T, H/p, D]``
    parts: group ``h`` gets head group ``h`` of every part, in sequence
    order, on its device (contiguous: the bf16 kernels copy 16-byte
    rows)."""
    p = len(devices)
    return [torch.cat([x.chunk(p, dim=2)[h].to(dev) for x in parts], dim=1)
            for h, dev in enumerate(devices)]


def _to_seq(parts: list[torch.Tensor], devices: list) -> list[torch.Tensor]:
    """The reverse of `_to_heads`: head-cut parts → sequence-cut parts,
    group ``g`` gets sequence block ``g`` of every head group, in head
    order."""
    p = len(devices)
    return [torch.cat([x.chunk(p, dim=1)[g].to(dev) for x in parts], dim=2)
            for g, dev in enumerate(devices)]


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
    card)."""
    devices = mesh.along(seq_axis)
    p = len(devices)
    if q.shape[2] % p:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the "
            f"{seq_axis!r} axis size ({p}); use ring_attention instead")
    if q.shape[1] % p:
        raise ValueError(f"sequence {q.shape[1]} not divisible by the "
                         f"{seq_axis!r} axis size {p}")
    qh, kh, vh = (_to_heads([c.to(dev) for c, dev in
                             zip(x.chunk(p, dim=1), devices)], devices)
                  for x in (q, k, v))
    outs = [local_attn(a, b, c, causal=causal)
            for a, b, c in zip(qh, kh, vh)]
    return torch.cat([o.to(q.device) for o in _to_seq(outs, devices)],
                     dim=1)
