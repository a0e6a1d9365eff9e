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
which is the NHWC layout the preprocess kernel writes. ``compute_dtype`` is
the activations' dtype (flax's ``dtype``); by default it is the
parameters' dtype (the serving engine's bf16 weights compute in bf16, the
CPU tests' f32 in f32). ``compute_dtype=torch.bfloat16`` over f32
parameters is the JAX module's default split, which its train step runs:
convs and the FC cast their f32 weights to bf16 (``models/mixed.py``), and
BatchNorm keeps f32 statistics, f32 running averages and f32 scale and
bias, normalizing in f32 into bf16 as flax's ``BatchNorm(dtype=bfloat16,
param_dtype=float32)`` does. Logits come back in f32. Padding is explicit, torch-style, as the JAX module spells it
(``resnet.py:80,115,172``), and the max-pool pads with -inf
(``nn.MaxPool2d(3, 2, 1)``), as ``nn.max_pool`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.mixed import Conv2d, Dense
from idunno_tpu_torch.models.stem_fold import FoldedStemConv
from idunno_tpu_torch.parallel.data import group_sum


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm`` (``momentum=0.9``, ``epsilon=1e-5``): in
    training it normalizes with the batch statistics, as torch does, but
    folds the *biased* batch variance into ``running_var``, where torch
    folds the unbiased one (n / (n - 1) larger, n = batch x height x
    width). Eval reads the running statistics, as torch does. An input in
    another dtype than the parameters' (bf16 activations over f32
    parameters) takes torch's mixed-type kernel: f32 statistics, scale
    and shift, the output in the input's dtype.

    torch's own update runs, then the unbiased share is scaled back on
    the per-channel vectors: with ``keep = (1 - momentum) * var0``, torch
    leaves ``keep + momentum * var * n / (n - 1)``, so ``(rv - keep) *
    (n - 1) / n + keep`` is flax's value, and no second pass over the
    activations is needed.

    Inside a data-parallel step over more than one group
    (``parallel/data.py:group_sum``), training normalizes with the
    statistics of the global batch, as ``jit`` over a data-sharded batch
    does: `global_batch_norm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        reduce = group_sum()
        if reduce is not None:
            return global_batch_norm(self, x, reduce)
        keep = (1.0 - self.momentum) * self.running_var
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        # a new tensor, not an in-place update: the autograd node of the
        # forward above holds running_var and checks its version
        with torch.no_grad():
            self.running_var = (self.running_var - keep) * ((n - 1) / n) + keep
        return y


def global_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor,
                      reduce) -> torch.Tensor:
    """Training BatchNorm over the global batch: each group's per-channel
    sum, sum of squares and count (f32) are summed over every data group
    by ``reduce`` (differentiable, so the backward takes the other groups'
    share too); mean and variance are flax's (``E[x²] - E[x]²``, the
    biased variance), and the running statistics fold them in with ``n``
    the global count. The output is in the input's dtype."""
    c = x.shape[1]
    xf = x.float()
    count = torch.full((1,), x.numel() // c, dtype=torch.float32,
                       device=x.device)
    stats = reduce(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                              count]))
    n = stats[-1]
    mean = stats[:c] / n
    var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
    shape = (1, c, 1, 1)
    scale = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (xf - mean.view(shape)) * scale.view(shape) + bn.bias.float().view(shape)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        bn.num_batches_tracked.add_(1)
    return y.to(x.dtype)


class _S2DStem(Conv2d):
    """The 7x7/stride-2 stem conv recast as a 4x4/stride-1 conv over the
    2x2 space-to-depth input [B, 4C, H/2, W/2] (``idunno_tpu/models/
    resnet.py:_S2DStem``, the MLPerf-ResNet trick): no stride, and 4·4·12
    = 192 taps contracted instead of 7·7·3 = 147.

    The parameter stays the torchvision-shaped ``weight`` [F, C, 7, 7]
    (same state_dict, same weight carry); the recast runs at forward time:
    zero-pad 7 → 8 with one *leading* row and column (tap a = 2m + dy - 1,
    so a = -1 is the empty slot), then fold each 2x2 tap block into the
    channels in the order of the input's (dy, dx, C). The output equals
    the 7x7 form's up to the order of the summation."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__(in_channels, out_channels, 7, 2, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"space-to-depth stem needs even spatial dims, "
                             f"got {h}x{w}")
        f = self.out_channels
        k = F.pad(self.weight.to(x.dtype), (1, 0, 1, 0))  # [F, C, 8, 8]
        k = (k.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
             .reshape(f, 4 * c, 4, 4))                  # (dy, dx, C) taps
        xs = (x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
              .reshape(b, 4 * c, h // 2, w // 2))
        return F.conv2d(F.pad(xs, (2, 1, 2, 1)), k)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (torchvision BasicBlock)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int) -> None:
        super().__init__()
        self.conv1 = Conv2d(in_ch, filters, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _projection(in_ch, filters, stride)

    @property
    def last_bn(self) -> BatchNorm2d:
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
        self.conv1 = Conv2d(in_ch, filters, 1, bias=False)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(filters)
        self.conv3 = Conv2d(filters, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _projection(in_ch, out_ch, stride)

    @property
    def last_bn(self) -> BatchNorm2d:
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
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, bias=False),
                         BatchNorm2d(out_ch))


class ResNet(nn.Module):
    """Generic ResNet: BasicBlock (18 = [2,2,2,2], 34 = [3,4,6,3]) or
    Bottleneck (50 = [3,4,6,3] with ``block_cls=Bottleneck``).

    ``fold_preprocess`` folds the normalize affine into the stem conv
    (``models/stem_fold.py``): the model then takes RAW cropped 0..255
    inputs, with the same parameters and mathematically identical
    outputs. ``stem_s2d`` runs the stem as the space-to-depth conv
    (`_S2DStem`), with the same parameters and outputs. Both recast the
    stem, so they exclude each other. ``compute_dtype`` is the activations'
    dtype (``None``: the parameters')."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 stem_s2d: bool = False, fold_preprocess: bool = False,
                 compute_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self._compute_dtype = compute_dtype
        if stem_s2d and fold_preprocess:
            raise ValueError("stem_s2d and fold_preprocess both recast the "
                             "stem conv; pick one")
        self.fold_preprocess = fold_preprocess
        if fold_preprocess:
            self.conv1 = FoldedStemConv(3, num_filters, 7, 2, 3, bias=False)
        elif stem_s2d:
            self.conv1 = _S2DStem(3, num_filters)
        else:
            self.conv1 = Conv2d(3, num_filters, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(num_filters)
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
        self.fc = Dense(in_ch, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers, with the last BatchNorm scale of
        every block zero (``scale_init=zeros`` there)."""
        init_like_flax(self, generator)
        for m in self.modules():
            if isinstance(m, (BasicBlock, Bottleneck)):
                nn.init.zeros_(m.last_bn.weight)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The activations' dtype; the parameters' unless set."""
        return self._compute_dtype or self.bn1.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
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
