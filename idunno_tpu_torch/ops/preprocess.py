"""Device-side image preprocessing in plain tensor ops.

Mirrors ``idunno_tpu/ops/preprocess.py``: the host loader decodes and
resizes to a canonical static 256x256 uint8 NHWC batch
(``engine/data.py``); the crop, dtype conversion and normalization run on
the device, batched. Functions take and return NHWC, as the JAX package's
do. The engine's ``kernel`` mode runs the same step as one hand-written
CUDA kernel (``ops/preprocess_kernel.py``); this is its ``plain`` mode.
"""
from __future__ import annotations

import torch

# torchvision ImageNet normalization constants (`alexnet_resnet.py:61`).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center-crop an NHWC batch to ``size`` (a view, no copy)."""
    h, w = x.shape[1], x.shape[2]
    top = (h - size) // 2
    left = (w - size) // 2
    return x[:, top:top + size, left:left + size, :]


def preprocess_batch(images_u8: torch.Tensor, *, crop: int = 224) -> torch.Tensor:
    """uint8 NHWC batch (canonical 256x256) → normalized f32 NHWC ``crop``².

    CenterCrop(224) + ToTensor + Normalize of the reference pipeline, in
    the JAX package's arithmetic: divide by 255, subtract the mean, divide
    by the std, all in f32."""
    x = center_crop(images_u8, crop).to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
