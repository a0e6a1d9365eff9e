"""Ring attention — sequence parallelism over the mesh, a port of
``idunno_tpu/parallel/ring_attention.py``.

q/k/v ``[B, T, H, D]`` are cut on T over the ``seq_axis`` groups of a
mesh, each block on its group's device. The ring runs p steps: in step
``i`` group ``my`` holds the K/V block of group ``src = (my - i) mod p``
and attends its queries to it, then every K/V block moves one group on
(a device-to-device copy; on a virtual mesh, the same card). Each
(query block, key block) pair is one call of the flash forward K2
(``ops/flash_attention.py:flash_attention_kernel``), which returns the
block's normalized output and its log-sum-exp; the partials merge
exactly in f32 (``ops/paged_attention.py:merge_attention``), as the JAX
ring accumulates in f32. Under ``causal`` only the diagonal pair takes
K2's causal mask, pairs with ``src < my`` are unmasked and pairs with
``src > my`` are skipped (the JAX ring computes them masked to -inf: they
add exactly 0). So a causal ring launches K2 p(p+1)/2 times a call, a
non-causal one p².

The backward is its own (`RingAttention`): K2's forward gives no
gradient for its log-sum-exp, so the merge is not differentiated.
Instead it keeps the merged log-sum-exp and ``delta = rowsum(out · dO)``
of the final output, and for each live pair, K/V rotating as in the
forward, accumulates ``dq_my`` by the dQ kernel K4 and ``dk_src``,
``dv_src`` by the dK/dV kernel K5 (``ops/flash_attention.py``), whose
probabilities ``exp(s - lse)`` with the merged ``lse`` are the pair's
share of the whole softmax. On CPU tensors every kernel call is its
plain version.

The output and the gradients are gathered back onto the inputs' device:
the single-controller model keeps the residual stream there (ROADMAP.md
§1).
"""
from __future__ import annotations

import itertools

import torch

from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.ops.flash_attention import (
    attention_delta, flash_attention_bwd_dkv_kernel,
    flash_attention_bwd_dq_kernel, flash_attention_kernel)
from idunno_tpu_torch.ops.paged_attention import merge_attention
from idunno_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

__all__ = ["ring_attention", "full_attention", "RingAttention",
           "ring_pairs"]


def ring_pairs(p: int, causal: bool):
    """The live (step, my, src, diagonal) pairs of a p-group ring, in
    step order: group ``my`` holds group ``src``'s K/V block in step
    ``i``; ``diagonal`` pairs take the causal mask."""
    for i in range(p):
        for my in range(p):
            src = (my - i) % p
            if causal and src > my:
                continue
            yield i, my, src, causal and src == my


def _rotate(held: list, devices: list) -> list:
    """Every group's K/V block one group on: group ``j + 1`` receives what
    group ``j`` held (a copy to its device)."""
    p = len(held)
    return [tuple(x.to(devices[j]) for x in held[(j - 1) % p])
            for j in range(p)]


def _schedule(ks, vs, devices, causal):
    """The ring's live pairs with the K/V block each group holds: yields
    (my, src, diagonal, (k_blk, v_blk)), rotating the blocks between
    steps."""
    held = list(zip(ks, vs))
    for i, pairs in itertools.groupby(ring_pairs(len(devices), causal),
                                      key=lambda pair: pair[0]):
        if i:
            held = _rotate(held, devices)
        for _, my, src, diag in pairs:
            yield my, src, diag, held[my]


def _blocks(x: torch.Tensor, devices: list) -> list[torch.Tensor]:
    """``x`` cut on T into one contiguous block per group, on its device
    (contiguous: the bf16 kernels copy 16-byte rows)."""
    return [c.to(dev).contiguous()
            for c, dev in zip(x.chunk(len(devices), dim=1), devices)]


def _ring_forward(qs, ks, vs, devices, causal):
    """Per group: (out in q's dtype, merged lse f32 [B, H, T/p])."""
    o_acc: list = [None] * len(devices)
    lse_acc: list = [None] * len(devices)
    for my, _, diag, (k_blk, v_blk) in _schedule(ks, vs, devices, causal):
        o, lse = flash_attention_kernel(qs[my], k_blk, v_blk, causal=diag)
        o, lse_t = o.float(), lse.transpose(1, 2)          # [B, T/p, H]
        if o_acc[my] is None:
            o_acc[my], lse_acc[my] = o, lse_t
        else:
            o_acc[my] = merge_attention(o_acc[my], lse_acc[my], o, lse_t)
            lse_acc[my] = torch.logaddexp(lse_acc[my], lse_t)
    return ([o.to(qs[0].dtype) for o in o_acc],
            [lse.transpose(1, 2).contiguous() for lse in lse_acc])


class RingAttention(torch.autograd.Function):
    """The ring's forward (K2 per live pair, f32 merges) and backward (K4
    and K5 per live pair from the merged log-sum-exp), module docstring.
    ``devices`` are the ring's groups in order."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal):
        qs, ks, vs = (_blocks(x, devices) for x in (q, k, v))
        outs, lses = _ring_forward(qs, ks, vs, devices, causal)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.devices, ctx.causal = devices, causal
        ctx.homes = (q.device, k.device, v.device)
        return torch.cat([o.to(q.device) for o in outs], dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        devices, p = ctx.devices, len(ctx.devices)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[j * p:(j + 1) * p])
                                  for j in range(5))
        dos = _blocks(do, devices)
        deltas = [attention_delta(o, g) for o, g in zip(outs, dos)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in qs]
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in ks]
        dv = [torch.zeros_like(x) for x in dk]
        for my, src, diag, (k_blk, v_blk) in _schedule(ks, vs, devices,
                                                       ctx.causal):
            args = (qs[my], k_blk, v_blk, dos[my], lses[my], deltas[my])
            dq[my] += flash_attention_bwd_dq_kernel(*args, causal=diag)
            dk_part, dv_part = flash_attention_bwd_dkv_kernel(*args,
                                                              causal=diag)
            # the partial travels back to the block's own group
            dk[src] += dk_part.to(devices[src])
            dv[src] += dv_part.to(devices[src])
        q_home, k_home, v_home = ctx.homes
        return (torch.cat([g.to(q_home, qs[0].dtype) for g in dq], dim=1),
                torch.cat([g.to(k_home, ks[0].dtype) for g in dk], dim=1),
                torch.cat([g.to(v_home, vs[0].dtype) for g in dv], dim=1),
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, *, seq_axis: str = DATA_AXIS,
                   causal: bool = False) -> torch.Tensor:
    """Multi-head attention with the sequence dim cut over ``seq_axis``.

    q/k/v: [B, T, H, D] of one shape (the flash kernels' contract), T
    divisible by the axis size. Returns [B, T, H, D] on q's device,
    differentiable through `RingAttention`."""
    devices = mesh.along(seq_axis)
    p = len(devices)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("ring attention takes q/k/v of one shape "
                         f"[B, T, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % p:
        raise ValueError(f"sequence {q.shape[1]} not divisible by the "
                         f"{seq_axis!r} axis size {p}")
    return RingAttention.apply(q, k, v, devices, causal)
