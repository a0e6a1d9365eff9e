"""Blockwise online-softmax attention forward: the CUDA kernel (K2) and
its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``idunno_tpu/ops/flash_attention.py:_flash_kernel``. Same contract as
``ops/attention.py:full_attention``: q/k/v [B, T, H, D] → [B, T, H, D],
and it plugs into ``models/transformer.py:TransformerLM`` as ``attn_fn``.
It reads q/k/v through their strides, so the TPU path's transpose to
[B·H, T_pad, D] and its padding of T are gone; rows and keys past T are
masked inside the kernel.

``flash_attention_kernel`` launches the kernel for CUDA tensors and raises
on anything it cannot take; for CPU tensors it runs
``flash_attention_plain``, which computes the same function in plain
tensor ops (one softmax over all keys instead of the kernel's per-tile
online softmax, so the two agree to f32 rounding). There is no backward
yet: ``flash_attention`` raises when an input requires grad rather than
return a gradient it cannot compute.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30          # safe -inf for masking (avoids inf - inf NaN)
# the variants the kernel compiles: the LM runs D = 64 in bf16 (served)
# and f32; D = 32 is the card tests' second shape
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def resolve_blocks(t: int, block_q: int = 256,
                   block_k: int = 1024) -> tuple[int, int, int]:
    """The (block_q, block_k, t_pad) the TPU kernel runs for sequence
    length ``t`` (``idunno_tpu/ops/flash_attention.py:resolve_blocks``),
    kept for labelling records with the TPU geometry. The CUDA kernel
    tiles 64 x 64 and masks the ragged edge instead of padding."""
    block_q = min(block_q, t)
    t_pad = -(-t // block_q) * block_q
    block_k = min(block_k, t_pad)
    if t_pad % block_k:
        bk = (block_k // 8) * 8
        while bk >= 8 and t_pad % bk:
            bk -= 8
        block_k = bk if bk >= 8 else block_q
    return block_q, block_k, t_pad


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, T, H, D] in q's dtype, lse f32 [B, H, T]) in the TPU
    kernel's arithmetic: f32 operands, scores ``q·k * (1/sqrt(D))``,
    masked keys at -1e30, a row whose sum is 0 divided by 1, and
    ``lse = m + log(l)``."""
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash attention takes q/k/v of one shape "
                         f"[B, T, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("flash attention takes q/k/v of one dtype in "
                        f"{sorted(map(str, _DTYPES))}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")


def _kernel_lib() -> ctypes.CDLL:
    from idunno_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_attention")
    fn = lib.idunno_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k/v [B, T, H, D] → (out [B, T, H, D] in q's dtype, lse f32
    [B, H, T]).

    On CUDA tensors: one launch of the CUDA kernel on the current stream
    (no synchronize); raises on a bad input or a refused launch. On CPU
    tensors: the plain version. ``flash_attention_kernel.launches`` counts
    the kernel's launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    b, t, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel needs the head_dim axis contiguous")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _kernel_lib().idunno_flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, d, _DTYPES[q.dtype],
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / (d ** 0.5), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention_kernel.launches += 1
    return out, lse


flash_attention_kernel.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """q/k/v [B, T, H, D] → [B, T, H, D]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor. Forward only: raises when an input
    requires grad (the backward kernels come with the training slice)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the port's flash attention has no backward yet "
                           "(training slice, ROADMAP.md); run it under "
                           "torch.no_grad() or use attn kind 'full'")
    return flash_attention_kernel(q, k, v, causal=causal)[0]
