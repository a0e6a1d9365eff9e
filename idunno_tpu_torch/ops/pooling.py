"""Adaptive average pooling with torch semantics.

torchvision AlexNet uses ``AdaptiveAvgPool2d((6, 6))`` before the
classifier. Window boundaries follow torch: start = floor(i*H/out),
end = ceil((i+1)*H/out), as in ``idunno_tpu/ops/pooling.py``, whose JAX
version spells the windows out because XLA has no such op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NHWC [B,H,W,C] → [B,out_h,out_w,C]."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
