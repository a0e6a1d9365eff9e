"""ResNet family as ``nn.Module``s, mirroring ``idunno_tpu/models/resnet.py``.

Architectures match torchvision, and so do the parameter names
(``conv1``, ``bn1``, ``layer1.0.conv1`` ..., ``fc``), so a torchvision
state_dict or one carried over from the JAX package
(``models/convert.py``) loads as it is: stem conv7x7/2 + maxpool, four
stages of BasicBlocks (resnet18: [2,2,2,2], resnet34: [3,4,6,3]) or
Bottlenecks (resnet50: [3,4,6,3], 4x expansion, stride on the 3x3: the
v1.5 layout), a strided projection at stage entry, global average pool,
1000-way FC.

Inputs are NCHW; the engine hands them over in ``channels_last`` memory,
which is the NHWC layout the preprocess kernel writes. The compute dtype is
the parameters' dtype (bf16 on the card, f32 in the CPU tests); logits come
back in f32. Padding is explicit, torch-style, as the JAX module spells it
(``resnet.py:80,115,172``), and the max-pool pads with -inf
(``nn.MaxPool2d(3, 2, 1)``), as ``nn.max_pool`` does.
"""
from __future__ import annotations

import torch
from torch import nn

from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.stem_fold import FoldedStemConv


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, filters, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _projection(in_ch, filters, stride)

    @property
    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(residual + y)


class Bottleneck(nn.Module):
    """1x1 reduce → 3x3 (strided, torchvision v1.5 placement) → 1x1 expand
    (4x), residual with projection on shape change."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int) -> None:
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = nn.Conv2d(in_ch, filters, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(filters)
        self.conv3 = nn.Conv2d(filters, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _projection(in_ch, out_ch, stride)

    @property
    def last_bn(self) -> nn.BatchNorm2d:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(residual + y)


def _projection(in_ch: int, out_ch: int, stride: int) -> nn.Sequential | None:
    """The strided 1x1 projection where the block changes shape."""
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                         nn.BatchNorm2d(out_ch))


class ResNet(nn.Module):
    """Generic ResNet: BasicBlock (18 = [2,2,2,2], 34 = [3,4,6,3]) or
    Bottleneck (50 = [3,4,6,3] with ``block_cls=Bottleneck``).

    ``fold_preprocess`` folds the normalize affine into the stem conv
    (``models/stem_fold.py``): the model then takes RAW cropped 0..255
    inputs, with the same parameters and mathematically identical
    outputs. ``stem_s2d`` (the JAX package's space-to-depth stem) is not
    ported yet and raises."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 stem_s2d: bool = False, fold_preprocess: bool = False) -> None:
        super().__init__()
        if stem_s2d:
            raise NotImplementedError(
                "stem_s2d (the space-to-depth stem) is not ported yet; "
                "ROADMAP.md lists it")
        self.fold_preprocess = fold_preprocess
        if fold_preprocess:
            self.conv1 = FoldedStemConv(3, num_filters, 7, 2, 3, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, num_filters, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(num_filters)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = num_filters
        for stage, n_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(block_cls(in_ch, filters, stride))
                in_ch = filters * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(in_ch, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers, with the last BatchNorm scale of
        every block zero (``scale_init=zeros`` there)."""
        init_like_flax(self, generator)
        for m in self.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                nn.init.zeros_(m.last_bn.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.bn1.weight.dtype)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.mean(dim=(2, 3))                  # global average pool
        return self.fc(x).to(torch.float32)     # logits in f32


def resnet18(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), **kwargs)


def resnet34(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kwargs)


def resnet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, **kwargs)
