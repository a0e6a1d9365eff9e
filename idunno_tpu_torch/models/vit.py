"""Vision Transformer, mirroring ``idunno_tpu/models/vit.py``.

A third servable image-classification family: it drops into
``InferenceEngine`` through the same ``model(images) -> logits`` contract
as AlexNet and ResNet. Patch embedding (a 16x16/stride-16 conv with bias,
or the folded preprocess stem, ``models/stem_fold.py``), a learned ``cls``
token and learned position embeddings, then the pre-LN transformer
``Block`` of ``models/transformer.py`` bidirectional and without RoPE,
a final LayerNorm and a linear head on the ``cls`` token.

Attention goes through ``attn_fn`` (``full_attention`` by default, as in
the JAX module); the engine builds ViTs with ``make_attn_fn("auto")``, so
on a card they attend through the flash kernel K2 (non-causal, T = 197
at 224² for ViT-S/16). Inputs are NCHW; the compute dtype is the
parameters' dtype; logits come back in f32. The position table is sized
for ``image_size``², which the flax module infers from its first input.
"""
from __future__ import annotations

import torch
from torch import nn

from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.stem_fold import FoldedStemConv
from idunno_tpu_torch.models.transformer import (LN_EPS, AttnFn, Block, Dense,
                                                 LayerNorm)
from idunno_tpu_torch.ops.attention import full_attention


class ViT(nn.Module):
    """ViT-/16-style classifier; ViT-S widths by default."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 dim: int = 384, depth: int = 12, num_heads: int = 6,
                 attn_fn: AttnFn = full_attention, image_size: int = 224,
                 fold_preprocess: bool = False) -> None:
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image {image_size}² not divisible by patch "
                             f"{patch}")
        self.patch, self.dim, self.image_size = patch, dim, image_size
        self.fold_preprocess = fold_preprocess
        if fold_preprocess:
            self.embed = FoldedStemConv(3, dim, patch, patch, 0, bias=True)
        else:
            self.embed = nn.Conv2d(3, dim, patch, patch)
        n = (image_size // patch) ** 2
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, causal=False, attn_fn=attn_fn,
                  use_rope=False) for _ in range(depth))
        self.ln_f = LayerNorm(dim, eps=LN_EPS)
        self.head = Dense(dim, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers: flax's defaults
        (``models/init.py``), ``cls`` zero, ``pos_embed`` a normal of std
        0.02."""
        init_like_flax(self, generator)
        nn.init.zeros_(self.cls)
        nn.init.normal_(self.pos_embed, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"ViT built for {self.image_size}² images, got "
                             f"{h}x{w}")
        dtype = self.ln_f.weight.dtype
        x = self.embed(x.to(dtype))                    # [B, dim, h/p, w/p]
        x = x.flatten(2).transpose(1, 2)               # [B, n, dim]
        x = torch.cat([self.cls.to(dtype).expand(b, 1, self.dim), x], dim=1)
        x = x + self.pos_embed.to(dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_f(x)[:, 0]).to(torch.float32)


def vit_s16(**kwargs) -> ViT:
    return ViT(**kwargs)


def vit_tiny(**kwargs) -> ViT:
    """ViT-Ti/16 widths at depth 4: small enough for the CPU tests."""
    kwargs.setdefault("dim", 192)
    kwargs.setdefault("depth", 4)
    kwargs.setdefault("num_heads", 3)
    return ViT(**kwargs)
