"""Plain float32 ViT classifier, with the crop and normalisation of its
input, written from the published description (Dosovitskiy et al. 2020,
arXiv:2010.11929; timm's ``vit_small_patch16_224``).

From uint8 NHWC images of 256²: the centre 224² crop, /255, ImageNet mean
and std; 16x16 patches through a strided convolution with bias; a class
token and a learned position table; pre-LN blocks (multi-head attention
with q, k, v and output biases, no mask; MLP of ratio 4); a final
LayerNorm and a linear head on the class token; softmax, top-1.

Departures from the published model, each as the configuration states:
GELU with the tanh approximation where timm uses the exact one; random
weights made from the seed (``perfbench/weights.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import (attention, layer_norm, linear, mlp)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def preprocess(images_u8: torch.Tensor, crop: int) -> torch.Tensor:
    """uint8 [N, H, W, 3] → float32 NCHW ``crop``², normalised."""
    h, w = images_u8.shape[1], images_u8.shape[2]
    top, left = (h - crop) // 2, (w - crop) // 2
    x = images_u8[:, top:top + crop, left:left + crop].to(torch.float32)
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x / 255.0 - mean) / std).permute(0, 3, 1, 2)


def logits(w: dict, cfg: dict, images_u8: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """Float32 logits [N, classes] of uint8 images [N, H, W, 3]."""
    x = preprocess(images_u8, cfg["img_size"])
    p = cfg["patch_size"]
    if fp8:
        from perfbench.reference.common import fp8_round
        x = fp8_round(x.reshape(x.shape[0], -1)).reshape(x.shape)
        weight = fp8_round(w["embed.weight"].reshape(
            w["embed.weight"].shape[0], -1)).reshape(w["embed.weight"].shape)
    else:
        weight = w["embed.weight"]
    x = F.conv2d(x, weight, w["embed.bias"], stride=p)
    x = x.flatten(2).transpose(1, 2)
    b, d = x.shape[0], x.shape[2]
    x = torch.cat([w["cls"].expand(b, 1, d), x], dim=1) + w["pos_embed"]
    h = cfg["num_heads"]
    eps = cfg["norm_eps"]
    for i in range(cfg["depth"]):
        pre = f"blocks.{i}."
        y = layer_norm(x, w[pre + "ln1.weight"], w[pre + "ln1.bias"], eps)
        q, k, v = (linear(y, w[pre + f"attn.{n}.weight"],
                          w[pre + f"attn.{n}.bias"], fp8)
                   .view(b, -1, h, d // h).transpose(1, 2)
                   for n in ("q", "k", "v"))
        a = attention(q, k, v, causal=False, fp8=fp8)
        a = a.transpose(1, 2).reshape(b, -1, d)
        x = x + linear(a, w[pre + "attn.out.weight"], w[pre + "attn.out.bias"],
                       fp8)
        y = layer_norm(x, w[pre + "ln2.weight"], w[pre + "ln2.bias"], eps)
        x = x + mlp(y, w, pre, fp8)
    cls = layer_norm(x[:, 0], w["ln_f.weight"], w["ln_f.bias"], eps)
    return linear(cls, w["head.weight"], w["head.bias"], fp8)
