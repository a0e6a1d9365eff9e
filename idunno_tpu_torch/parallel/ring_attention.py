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

Across processes (the sequence axis of a mesh whose rows belong to
several processes, ``parallel/mesh.py:global_mesh``), q/k/v are this
process's slice of the global sequence, the rows of its own groups (the
counterpart of a global array's addressable shards), and so is the
output. Each process runs the live pairs of its own groups; a block whose
next group, or a partial dK/dV whose block's group, lies in another
process crosses through ``parallel/transport.py:exchange``, every
process exchanging once per ring step in the same order, so the merges
and the sums of partials run in the one-process order.
"""
from __future__ import annotations

import itertools

import torch

from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.ops.flash_attention import (
    attention_delta, flash_attention_bwd_dkv_kernel,
    flash_attention_bwd_dq_kernel, flash_attention_kernel)
from idunno_tpu_torch.ops.paged_attention import merge_attention
from idunno_tpu_torch.parallel import transport
from idunno_tpu_torch.parallel.mesh import DATA_AXIS, AxisCells, Mesh

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


def _rotate(held: dict, cells: AxisCells) -> dict:
    """Every group's K/V block one group on: group ``j + 1`` receives what
    group ``j`` held (a copy to its device; through the transport from
    another process). ``held`` maps this process's groups to their
    blocks. Both sides of a crossing list it by the sending group."""
    p = len(cells)
    out = {j: tuple(x.to(cells.devices[j]) for x in held[(j - 1) % p])
           for j in cells.mine if cells.local((j - 1) % p)}
    sends = [(x, cells.ranks[(j + 1) % p]) for j in cells.mine
             if not cells.local((j + 1) % p) for x in held[j]]
    arriving = sorted(((j - 1) % p, j) for j in cells.mine
                      if not cells.local((j - 1) % p))
    like = held[cells.mine[0]]
    got = transport.exchange(sends, [
        ((x.shape, x.dtype, cells.devices[j]), cells.ranks[src])
        for src, j in arriving for x in like])
    for n, (_, j) in enumerate(arriving):
        out[j] = tuple(got[n * len(like):(n + 1) * len(like)])
    return out


def _steps(ks, vs, cells: AxisCells, causal):
    """The ring's steps: yields ``(step, pairs)``, ``pairs`` this
    process's live pairs of the step, each (my, src, diagonal, (k_blk,
    v_blk)), rotating the blocks between steps (every process rotates at
    every step, in the same order)."""
    held = dict(zip(cells.mine, zip(ks, vs)))
    for i, pairs in itertools.groupby(ring_pairs(len(cells), causal),
                                      key=lambda pair: pair[0]):
        if i:
            held = _rotate(held, cells)
        yield i, [(my, src, diag, held[my]) for _, my, src, diag in pairs
                  if cells.local(my)]


def _blocks(x: torch.Tensor, cells: AxisCells) -> list[torch.Tensor]:
    """``x`` (this process's rows of the sequence) cut on T into one
    contiguous block per group of this process, on its device
    (contiguous: the bf16 kernels copy 16-byte rows)."""
    mine = cells.mine
    return [c.to(cells.devices[j]).contiguous()
            for c, j in zip(x.chunk(len(mine), dim=1), mine)]


def _ring_forward(qs, ks, vs, cells, causal):
    """Per group of this process: (out in q's dtype, merged lse f32 [B,
    H, T/p])."""
    index = {j: n for n, j in enumerate(cells.mine)}
    o_acc: list = [None] * len(qs)
    lse_acc: list = [None] * len(qs)
    for my, _, diag, (k_blk, v_blk) in itertools.chain.from_iterable(
            pairs for _, pairs in _steps(ks, vs, cells, causal)):
        n = index[my]
        o, lse = flash_attention_kernel(qs[n], k_blk, v_blk, causal=diag)
        o, lse_t = o.float(), lse.transpose(1, 2)          # [B, T/p, H]
        if o_acc[n] is None:
            o_acc[n], lse_acc[n] = o, lse_t
        else:
            o_acc[n] = merge_attention(o_acc[n], lse_acc[n], o, lse_t)
            lse_acc[n] = torch.logaddexp(lse_acc[n], lse_t)
    return ([o.to(qs[0].dtype) for o in o_acc],
            [lse.transpose(1, 2).contiguous() for lse in lse_acc])


def _return_partials(parts: list, cells: AxisCells, step: int, causal,
                     like) -> list:
    """The dK/dV partials of one ring step on their way back to their
    blocks' groups: ``parts`` are this process's (src, dk_part, dv_part);
    returns those for this process's groups, from here or, through the
    transport, from another process (both sides list a crossing by its
    query group). ``like`` is (shape, dtype) of an f32 accumulator."""
    p = len(cells)
    # a partial crosses in f32, the accumulators' dtype (K5 gives the
    # inputs' dtype; the sum widens it all the same)
    sends = [(x.float(), cells.ranks[src]) for src, dk, dv in parts
             if not cells.local(src) for x in (dk, dv)]
    arriving = [(my, src) for i, my, src, _ in ring_pairs(p, causal)
                if i == step and cells.local(src) and not cells.local(my)]
    got = transport.exchange(sends, [
        ((like[0], like[1], cells.devices[src]), cells.ranks[my])
        for my, src in arriving for _ in range(2)])
    return ([part for part in parts if cells.local(part[0])]
            + [(src, got[2 * n], got[2 * n + 1])
               for n, (_, src) in enumerate(arriving)])


class RingAttention(torch.autograd.Function):
    """The ring's forward (K2 per live pair, f32 merges) and backward (K4
    and K5 per live pair from the merged log-sum-exp), module docstring.
    ``cells`` are the ring's groups in order."""

    @staticmethod
    def forward(ctx, q, k, v, cells, causal):
        qs, ks, vs = (_blocks(x, cells) for x in (q, k, v))
        outs, lses = _ring_forward(qs, ks, vs, cells, causal)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.cells, ctx.causal = cells, causal
        ctx.homes = (q.device, k.device, v.device)
        return torch.cat([o.to(q.device) for o in outs], dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        cells = ctx.cells
        n = len(cells.mine)
        index = {j: i for i, j in enumerate(cells.mine)}
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[j * n:(j + 1) * n])
                                  for j in range(5))
        dos = _blocks(do, cells)
        deltas = [attention_delta(o, g) for o, g in zip(outs, dos)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in qs]
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in ks]
        dv = [torch.zeros_like(x) for x in dk]
        for i, pairs in _steps(ks, vs, cells, ctx.causal):
            parts = []
            for my, src, diag, (k_blk, v_blk) in pairs:
                m = index[my]
                args = (qs[m], k_blk, v_blk, dos[m], lses[m], deltas[m])
                dq[m] += flash_attention_bwd_dq_kernel(*args, causal=diag)
                parts.append((src, *flash_attention_bwd_dkv_kernel(
                    *args, causal=diag)))
            # each partial travels back to its block's own group
            for src, dk_part, dv_part in _return_partials(
                    parts, cells, i, ctx.causal, (dk[0].shape, dk[0].dtype)):
                dk[index[src]] += dk_part.to(cells.devices[src])
                dv[index[src]] += dv_part.to(cells.devices[src])
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
    differentiable through `RingAttention`. Over a mesh across processes
    T is this process's slice (module docstring), divisible by the number
    of its groups."""
    cells = mesh.along(seq_axis)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("ring attention takes q/k/v of one shape "
                         f"[B, T, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % len(cells.mine):
        raise ValueError(f"sequence {q.shape[1]} not divisible by the "
                         f"{seq_axis!r} axis size {len(cells.mine)}")
    return RingAttention.apply(q, k, v, cells, causal)
