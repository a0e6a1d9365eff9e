"""Pieces the plain references share: LayerNorm, the tanh GELU, the matrix
product with its optional fp8 rounding, and the switch that keeps float32
products in float32 on the card.

Every reference takes its weights as a dict of float32 tensors named as
``perfbench/weights.py`` names them, and computes in float32. With
``fp8=True`` every operand of a matrix product (activations per row,
weights per output channel) is rounded to float8 e4m3 with its own scale
before the product, which accumulates in float32: the nearest precision
below the bfloat16 that the configurations state, used as the control of
the output check.
"""
from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0


def strict_f32() -> None:
    """No TF32 in float32 products or convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled by the largest magnitude along
    ``dim`` so that it fills the format's range, and back to float32. The
    gradient passes through unchanged."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q * scale - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           fp8: bool = False) -> torch.Tensor:
    """x @ wᵀ + b, ``w`` [out, in]."""
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    y = x @ w.t()
    return y if b is None else y + b


def matmul(a: torch.Tensor, b: torch.Tensor, fp8: bool = False
           ) -> torch.Tensor:
    """a @ b over the last two axes, rounding rows of ``a`` and columns of
    ``b`` to fp8 with ``fp8``."""
    if fp8:
        a, b = fp8_round(a, -1), fp8_round(b, -2)
    return a @ b


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (GPT-2's ``gelu_new``)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, fp8: bool = False) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d)) v over [B, H, T, D], the scores and their
    softmax spelled out in float32."""
    d = q.shape[-1]
    s = matmul(q, k.transpose(-1, -2), fp8) / math.sqrt(d)
    if causal:
        t = q.shape[-2]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return matmul(p, v, fp8)


def mlp(x: torch.Tensor, w: dict, pre: str, fp8: bool = False
        ) -> torch.Tensor:
    h = gelu_tanh(linear(x, w[pre + "mlp_up.weight"], w[pre + "mlp_up.bias"],
                         fp8))
    return linear(h, w[pre + "mlp_down.weight"], w[pre + "mlp_down.bias"], fp8)
