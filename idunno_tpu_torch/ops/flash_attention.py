"""Blockwise online-softmax attention, forward and backward: the CUDA
kernels K2 (forward), K4 (dQ) and K5 (dK, dV), their plain versions, and
the ``torch.autograd.Function`` that joins them.

The kernels replace the TPU kernels of ``idunno_tpu/ops/flash_attention.py``:
K2 (``csrc/flash_attention.cu``) ``_flash_kernel``, K4 and K5
(``csrc/flash_attention_bwd.cu``) ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``; ``FlashAttention`` is the counterpart of the
JAX package's ``jax.custom_vjp`` around them. Same contract as
``ops/attention.py:full_attention``: q/k/v [B, T, H, D] → [B, T, H, D],
and it plugs into ``models/transformer.py:TransformerLM`` as ``attn_fn``.
It reads q/k/v through their strides, so the TPU path's transpose to
[B·H, T_pad, D] and its padding of T are gone; rows and keys past T are
masked inside the kernel.

Each kernel wrapper (``flash_attention_kernel``,
``flash_attention_bwd_dq_kernel``, ``flash_attention_bwd_dkv_kernel``)
launches its kernel for CUDA tensors and raises on anything it cannot
take; for CPU tensors it runs the matching part of the plain version
(``flash_attention_plain``, ``flash_attention_bwd_plain``), which computes
the same function in plain tensor ops: one softmax over all keys instead
of the kernel's per-tile online softmax, and the whole [T, T]
probability matrix instead of tiles, so the two agree to f32 rounding.

In bf16 (the serving and training path) K2, K4 and K5 run on the tensor
cores: bf16 products with f32 sums, and the probabilities P (K2, K5) and
dS (K4, K5) rounded to bf16 before their second product. That rounding,
at most 2⁻⁹ of each value, is their only difference from the plain
version's f32 arithmetic; ``tensor_core_bound`` turns it into a
per-element bound on out, dQ, dK and dV. The kernels copy 16-byte
chunks, so their bf16 inputs need 16-byte aligned rows
(``check_tensor_core_alignment``). The f32 variants keep the TPU
kernels' f32 arithmetic on the CUDA cores.

The backward recomputes the probabilities from the forward's
log-sum-exp: ``delta = rowsum(dO * O)`` in plain torch (the JAX package
leaves it to XLA), then K4 and K5. ``flash_attention`` is differentiable
through ``FlashAttention``; under ``torch.no_grad()`` (serving) it calls
the forward kernel directly.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30          # safe -inf for masking (avoids inf - inf NaN)
# the variants the kernels (K2, K4, K5) compile: the LM runs D = 64 in
# bf16 (served and trained) and f32; D = 32 is the card tests' second shape
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


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """f32 [B, H, Tq, Tk] scores ``q·k * (1/sqrt(D))``, masked keys at
    -1e30: the arithmetic of the TPU kernels' ``_masked_scores``."""
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, T, H, D] in q's dtype, lse f32 [B, H, T]) in the TPU
    kernel's arithmetic: f32 operands, scores ``q·k * (1/sqrt(D))``,
    masked keys at -1e30, a row whose sum is 0 divided by 1, and
    ``lse = m + log(l)``."""
    s = _scores(q, k, causal=causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers (8 significant bits) at |x|, elementwise,
    in f64."""
    _, e = torch.frexp(x.abs().double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)


_P_ROUNDING = 2.0 ** -8   # twice bf16's largest relative rounding error


def tensor_core_bound(name: str, got: torch.Tensor, ref: torch.Tensor,
                      q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, do: torch.Tensor | None = None,
                      lse: torch.Tensor | None = None,
                      delta: torch.Tensor | None = None) -> torch.Tensor:
    """Per-element bound on ``|got − ref|`` (f64, ``got``'s shape) for an
    output of the bf16 tensor-core kernels against the f32 arithmetic of
    the plain versions, ``name`` one of ``"out"`` (K2), ``"dq"`` (K4),
    ``"dk"``, ``"dv"`` (K5; the gradients need ``do``, ``lse`` and
    ``delta``).

    The kernels' bf16 products are exact in f32 and their sums f32; what
    they round is each probability p (K2, K5) and each dS (K4, K5) to bf16
    before the next product, a relative error of at most 2⁻⁹. Summed
    through that product, with P, dS and l computed the plain way:

    - out: ``2⁻⁸·(P·|V|)/l + 1 bf16 ulp of max(|got|, |ref|) + 1e-5``
    - dQ: ``2⁻⁸·(|dS|·|K|) + 1 ulp + 1e-5·max|ref|``
    - dV: ``2⁻⁸·(Pᵀ·|dO|) + 1 ulp + 1e-5·max|ref|``
    - dK: ``2⁻⁸·(|dS|ᵀ·|Q|) + 1 ulp + 1e-5·max|ref|``

    2⁻⁸ leaves a factor of two over the rounding for f32 differences in
    p; the ulp covers both sides' rounding of the result to bf16."""
    ulp = bf16_ulp(torch.maximum(got.float().abs(), ref.float().abs()))
    if name == "out":
        p = torch.softmax(_scores(q, k, causal=causal), dim=-1)
        term = torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())
        return _P_ROUNDING * term.double() + ulp + 1e-5
    if name not in ("dq", "dk", "dv"):
        raise ValueError(f"no tensor-core bound for {name!r}")
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal)
    if name == "dq":
        term = torch.einsum("bhqk,bkhd->bqhd", ds.abs(), k.float().abs())
    elif name == "dv":
        term = torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())
    else:
        term = torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q.float().abs())
    return (_P_ROUNDING * term.double() + ulp
            + 1e-5 * float(ref.float().abs().max()))


def _tensor_core_aligned(x: torch.Tensor) -> bool:
    return x.dtype != torch.bfloat16 or (
        x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3]))


def check_tensor_core_alignment(*xs: torch.Tensor) -> None:
    """Raise unless every bf16 tensor of ``xs`` can be copied in 16-byte
    chunks, as the tensor-core kernels (K2, K4, K5 in bf16) copy it: its data
    pointer 16-byte aligned and its batch, token and head strides
    multiples of 8 elements. f32 tensors pass unchecked. Reads only
    pointers and strides, so it runs on any device."""
    for x in xs:
        if not _tensor_core_aligned(x):
            raise ValueError(
                "the bf16 flash kernels copy 16-byte rows: they need a "
                "16-byte aligned data pointer and batch, token and head "
                "strides that are multiples of 8 elements, got pointer "
                f"{x.data_ptr():#x} (mod 16 = {x.data_ptr() % 16}) and "
                f"strides {tuple(x.stride())}")


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
    (no synchronize), the tensor-core kernel for bf16 (whose inputs must
    pass ``check_tensor_core_alignment``); raises on a bad input or a
    refused launch. On CPU tensors: the plain version.
    ``flash_attention_kernel.launches`` counts the kernel's launches."""
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
    check_tensor_core_alignment(q, k, v)
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


def _probs_and_ds(q, k, v, do, lse, delta, *, causal):
    """(p, ds) f32 [B, H, T, T]: ``p = exp(s - lse)`` and
    ``ds = p∘(dO·Vᵀ − delta)·scale``, as the TPU backward kernels build
    them."""
    scale = 1.0 / (q.shape[3] ** 0.5)
    p = torch.exp(_scores(q, k, causal=causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _dq_plain(q, k, v, do, lse, delta, *, causal):
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, *, causal):
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal=causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO ∘ O)``: f32 [B, H, T] from [B, T, H, D]."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) [B, T, H, D] in the inputs' dtype from the forward's
    q/k/v, out and lse (f32 [B, H, T]) and the output gradient ``do``, in
    the TPU kernels' arithmetic: f32 operands, ``p = exp(s − lse)``,
    ``delta = rowsum(dO∘O)``, ``ds = p∘(dO·Vᵀ − delta)·scale``,
    ``dq = ds·K``, ``dk = dsᵀ·Q``, ``dv = pᵀ·dO``."""
    delta = attention_delta(out, do)
    dq = _dq_plain(q, k, v, do, lse, delta, causal=causal)
    return (dq, *_dkv_plain(q, k, v, do, lse, delta, causal=causal))


def _bwd_lib() -> ctypes.CDLL:
    from idunno_tpu_torch.ops import cuda_build

    lib = cuda_build.load("flash_attention_bwd")
    strides = [ctypes.c_int64] * 12
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for name, n_out in (("idunno_flash_attention_bwd_dq", 1),
                        ("idunno_flash_attention_bwd_dkv", 2)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * (6 + n_out)
                           + [ctypes.c_int] * 5 + strides + tail)
            fn.restype = ctypes.c_int
    return lib


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    b, t, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"the output gradient must match q: got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, t) or x.dtype != torch.float32
                or x.device != q.device):
            raise ValueError(f"{name} must be f32 [B, H, T] = {(b, h, t)} "
                             f"on {q.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")


def _bwd_launch(name: str, outs, q, k, v, do, lse, delta, causal) -> None:
    """One launch of K4 or K5 on the current stream; raises on an input
    the kernel does not take or a refused launch."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    b, t, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if any(x.stride(3) != 1 for x in (q, k, v, do)):
        raise ValueError("flash kernel needs the head_dim axis contiguous")
    lse, delta = lse.contiguous(), delta.contiguous()
    fn = getattr(_bwd_lib(), name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    strides = [s for x in (q, k, v, do) for s in x.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b, t, h, d, _DTYPES[q.dtype], *strides, 1.0 / (d ** 0.5),
            int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def flash_attention_bwd_dq_kernel(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  lse: torch.Tensor, delta: torch.Tensor, *,
                                  causal: bool = False) -> torch.Tensor:
    """K4: dq [B, T, H, D] in q's dtype from q/k/v and ``do`` [B, T, H, D],
    lse and delta f32 [B, H, T]. One launch on a CUDA tensor (no
    synchronize), the tensor-core kernel for bf16 (whose inputs must pass
    ``check_tensor_core_alignment``); the plain version's dq on a CPU
    tensor. ``flash_attention_bwd_dq_kernel.launches`` counts the
    launches."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _dq_plain(q, k, v, do, lse, delta, causal=causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    check_tensor_core_alignment(q, k, v, do)
    _bwd_launch("idunno_flash_attention_bwd_dq", (dq,), q, k, v, do, lse,
                delta, causal)
    flash_attention_bwd_dq_kernel.launches += 1
    return dq


flash_attention_bwd_dq_kernel.launches = 0


def flash_attention_bwd_dkv_kernel(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, do: torch.Tensor,
                                   lse: torch.Tensor, delta: torch.Tensor, *,
                                   causal: bool = False
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: (dk, dv) [B, T, H, D] in the inputs' dtype, from the same
    inputs as K4. One launch on a CUDA tensor, the tensor-core kernel for
    bf16 (whose inputs must pass ``check_tensor_core_alignment``); the
    plain version's dk and dv on a CPU tensor.
    ``flash_attention_bwd_dkv_kernel.launches`` counts the launches."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _dkv_plain(q, k, v, do, lse, delta, causal=causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    check_tensor_core_alignment(q, k, v, do)
    _bwd_launch("idunno_flash_attention_bwd_dkv", (dk, dv), q, k, v, do, lse,
                delta, causal)
    flash_attention_bwd_dkv_kernel.launches += 1
    return dk, dv


flash_attention_bwd_dkv_kernel.launches = 0


class FlashAttention(torch.autograd.Function):
    """K2 forward, K4 then K5 backward: the counterpart of the JAX
    package's ``_flash.defvjp(_flash_fwd, _flash_bwd)``. The forward saves
    q, k, v, out and lse (f32 [B, H, T]); the backward never holds the
    [T, T] probabilities. On CPU tensors every step is the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_kernel(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or not _tensor_core_aligned(do):
            do = do.clone(memory_format=torch.contiguous_format)
        delta = attention_delta(out, do)
        dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta,
                                           causal=ctx.causal)
        dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """q/k/v [B, T, H, D] → [B, T, H, D]: the kernels on a CUDA tensor, the
    plain versions on a CPU tensor. Differentiable: when an input requires
    grad, through ``FlashAttention`` (K2, then K4 and K5 in the backward);
    otherwise one call of the forward kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_kernel(q, k, v, causal=causal)[0]
