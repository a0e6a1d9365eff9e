"""Seeded initialisation with the JAX package's initialisers.

Flax's defaults, which the JAX models use: conv and dense kernels are
``lecun_normal`` (a normal truncated at two standard deviations, scaled to
variance 1/fan_in), biases zero, BatchNorm scale one and bias zero with
running mean 0 and variance 1, LayerNorm scale one and bias zero, and
embeddings a normal of variance 1/dim. The draws come from an explicit
``torch.Generator``; they are not the JAX package's numbers (``jax.random``
and torch differ), only the same distributions.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from idunno_tpu_torch.models.stem_fold import FoldedStemConv

# std of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    fan_in = w[0].numel()               # OIHW conv or (out, in) linear
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every conv, linear and BatchNorm of ``module``, and
    every submodule with its own ``reset_like_flax(generator)`` (the
    routed FFN's expert kernels, ``models/moe.py``) by that."""
    for m in module.modules():
        if hasattr(m, "reset_like_flax"):
            m.reset_like_flax(generator)
        elif isinstance(m, (nn.Conv2d, nn.Linear, FoldedStemConv)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            # flax Embed: variance_scaling(1, fan_in, normal) over the
            # feature axis, a plain normal of std 1/sqrt(dim)
            nn.init.normal_(m.weight, std=1.0 / math.sqrt(m.embedding_dim),
                            generator=generator)
