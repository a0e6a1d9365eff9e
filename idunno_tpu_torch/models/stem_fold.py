"""Fold the preprocess normalize affine into the stem convolution.

The serving input pipeline is CenterCrop + ToTensor + Normalize
(reference `alexnet_resnet.py:57-62`), i.e. per channel
``x_norm = x/255·(1/std) - mean/std = a·x + c``, an affine map feeding a
convolution. By linearity (``idunno_tpu/models/stem_fold.py``):

    conv(pad0(a·x + c·1_img), W) = conv(pad0(x), W·a) + conv(pad0(c·1), W)

The first term scales each input-channel slice of the kernel; the second is
a constant map, computed as a conv over one c-valued image so that the
zero-padded borders match the unfolded path exactly. The network then reads
the raw cropped 0..255 values (exact in bf16), and no normalized image is
ever written to device memory.

The parameters stay torchvision's ``weight`` (and ``bias``) under the
family's stem name, so state_dicts and the weight carry see the same keys
as the unfolded model. The scaled kernel is formed in f32 and cast once to
the compute dtype, as the JAX module does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from idunno_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD


class FoldedStemConv(nn.Module):
    """Drop-in stem conv over RAW 0..255 NCHW inputs: computes
    ``conv(normalize(x), weight) [+ bias]`` by the folded form above."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int, bias: bool) -> None:
        super().__init__()
        if in_channels != len(IMAGENET_MEAN):
            raise ValueError(f"folded stem expects {len(IMAGENET_MEAN)} input "
                             f"channels, got {in_channels}")
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        # python floats: a scalar operand is rounded to the tensor's dtype,
        # so these match the JAX module's f32 ``a`` and compute-dtype ``c``
        std, mean = np.asarray(IMAGENET_STD), np.asarray(IMAGENET_MEAN)
        self.scale = [float(v) for v in 1.0 / (255.0 * std)]
        self.shift = [float(v) for v in -mean / std]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight        # read once: an int8 weight dequantizes
        # the compute dtype: the model hands over its activations' dtype
        dtype = x.dtype if x.is_floating_point() else weight.dtype
        x = x.to(dtype)
        h, w = x.shape[2], x.shape[3]
        wf = weight.to(torch.float32)
        ks = torch.cat([wf[:, i:i + 1] * a for i, a in enumerate(self.scale)],
                       dim=1).to(dtype)
        y = F.conv2d(x, ks, stride=self.stride, padding=self.padding)
        # constant-map term: one c-valued image through the unscaled
        # kernel; [1, F, Ho, Wo] broadcasts over the batch
        cimg = torch.cat([torch.full((1, 1, h, w), v, dtype=dtype,
                                     device=x.device) for v in self.shift],
                         dim=1)
        y = y + F.conv2d(cimg, weight.to(dtype), stride=self.stride,
                         padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.to(dtype)[None, :, None, None]
        return y
