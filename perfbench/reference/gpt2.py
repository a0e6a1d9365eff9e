"""Plain float32 GPT-2-medium-shaped language model, written from the
published description (Radford et al. 2019; the ``gpt2-medium``
``config.json``) with the departures the configuration states.

Token embedding; pre-LN blocks, each ``x + attn(ln1(x))`` then
``x + mlp(ln2(x))``; causal multi-head attention with q, k, v and output
biases; MLP of width ``n_inner`` with ``gelu_new``; a final LayerNorm and
a linear head.

Departures from GPT-2, each as the configuration states: rotary position
embedding (base 10000, rotating the two halves of each head) on q and k
in place of the learned position table; a head untied from the embedding
and with a bias; LayerNorm epsilon 1e-6; no dropout; random weights made
from the seed (``perfbench/weights.py``).

``forward`` is the full causal forward; ``greedy`` decodes through a
contiguous per-layer key/value cache, one token at a time.
"""
from __future__ import annotations

import torch

from perfbench.reference.common import (attention, layer_norm, linear, matmul,
                                        mlp)

ROPE_BASE = 10000.0


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate [B, H, T, D] by ``positions`` [T]: the two halves of D."""
    half = x.shape[-1] // 2
    freqs = ROPE_BASE ** (-torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, h, d // h).transpose(1, 2)


def hidden(w: dict, cfg: dict, tokens: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """The final LayerNorm's output [B, T, d] of int64 tokens [B, T]."""
    eps, h = cfg["layer_norm_epsilon"], cfg["n_head"]
    x = w["embed.weight"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg["n_layer"]):
        pre = f"blocks.{i}."
        y = layer_norm(x, w[pre + "ln1.weight"], w[pre + "ln1.bias"], eps)
        q, k, v = (_heads(linear(y, w[pre + f"attn.{n}.weight"],
                                 w[pre + f"attn.{n}.bias"], fp8), h)
                   for n in ("q", "k", "v"))
        a = attention(rope(q, pos), rope(k, pos), v, causal=True, fp8=fp8)
        a = a.transpose(1, 2).reshape(x.shape)
        x = x + linear(a, w[pre + "attn.out.weight"], w[pre + "attn.out.bias"],
                       fp8)
        y = layer_norm(x, w[pre + "ln2.weight"], w[pre + "ln2.bias"], eps)
        x = x + mlp(y, w, pre, fp8)
    return layer_norm(x, w["ln_f.weight"], w["ln_f.bias"], eps)


def head(w: dict, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    return linear(x, w["head.weight"], w["head.bias"], fp8)


def forward(w: dict, cfg: dict, tokens: torch.Tensor,
            fp8: bool = False) -> torch.Tensor:
    """Float32 logits [B, T, V] of int64 tokens [B, T]."""
    return head(w, hidden(w, cfg, tokens, fp8), fp8)


@torch.no_grad()
def greedy(w: dict, cfg: dict, prompt: list[int], n_new: int) -> list[int]:
    """``n_new`` greedy tokens after ``prompt``, decoded one at a time
    through a contiguous key/value cache of each layer."""
    eps, h = cfg["layer_norm_epsilon"], cfg["n_head"]
    dev = w["embed.weight"].device
    cache: list[tuple[torch.Tensor, torch.Tensor] | None] = \
        [None] * cfg["n_layer"]
    seq = list(prompt)
    out: list[int] = []
    step_in = torch.tensor([seq], device=dev)
    start = 0
    for _ in range(n_new):
        x = w["embed.weight"][step_in]
        pos = torch.arange(start, start + step_in.shape[1], device=dev)
        for i in range(cfg["n_layer"]):
            pre = f"blocks.{i}."
            y = layer_norm(x, w[pre + "ln1.weight"], w[pre + "ln1.bias"], eps)
            q, k, v = (_heads(linear(y, w[pre + f"attn.{n}.weight"],
                                     w[pre + f"attn.{n}.bias"]), h)
                       for n in ("q", "k", "v"))
            q, k = rope(q, pos), rope(k, pos)
            if cache[i] is not None:
                k = torch.cat([cache[i][0], k], dim=2)
                v = torch.cat([cache[i][1], v], dim=2)
            cache[i] = (k, v)
            s = matmul(q, k.transpose(-1, -2)) / q.shape[-1] ** 0.5
            t_q, t_k = q.shape[2], k.shape[2]
            keep = (torch.arange(t_k, device=dev)[None, :]
                    <= torch.arange(t_k - t_q, t_k, device=dev)[:, None])
            a = torch.softmax(s.masked_fill(~keep, float("-inf")), -1) @ v
            a = a.transpose(1, 2).reshape(x.shape)
            x = x + linear(a, w[pre + "attn.out.weight"],
                           w[pre + "attn.out.bias"])
            y = layer_norm(x, w[pre + "ln2.weight"], w[pre + "ln2.bias"], eps)
            x = x + mlp(y, w, pre)
        x = layer_norm(x[:, -1], w["ln_f.weight"], w["ln_f.bias"], eps)
        nxt = int(head(w, x).argmax(-1))
        out.append(nxt)
        start += step_in.shape[1]
        step_in = torch.tensor([[nxt]], device=dev)
    return out
