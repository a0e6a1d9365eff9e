"""AlexNet as an ``nn.Module``, mirroring ``idunno_tpu/models/alexnet.py``.

The single-tower torchvision ``alexnet``, with its parameter names
(``features.0`` ... ``classifier.6``): five convs, three maxpools, adaptive
pool to 6x6, three FC layers with dropout. Inputs are NCHW (``channels_last``
in the engine); ``compute_dtype`` is the activations' dtype, by default the
parameters' (the JAX module's default is bf16 compute over f32 parameters:
``compute_dtype=torch.bfloat16``, the layers cast their weights,
``models/mixed.py``); logits come back in f32. ``fold_preprocess`` folds the normalize affine into
``features.0`` (``models/stem_fold.py``), which then reads raw 0..255.
"""
from __future__ import annotations

import torch
from torch import nn

from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.mixed import Conv2d, Dense, Dropout
from idunno_tpu_torch.models.stem_fold import FoldedStemConv
from idunno_tpu_torch.ops.pooling import adaptive_avg_pool


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, dropout_rate: float = 0.5,
                 fold_preprocess: bool = False,
                 compute_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self._compute_dtype = compute_dtype
        self.fold_preprocess = fold_preprocess
        if fold_preprocess:
            stem = FoldedStemConv(3, 64, 11, 4, 2, bias=True)
        else:
            stem = Conv2d(3, 64, 11, 4, 2)
        self.features = nn.Sequential(
            stem, nn.ReLU(inplace=True), nn.MaxPool2d(3, 2),
            Conv2d(64, 192, 5, padding=2), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            Conv2d(192, 384, 3, padding=1), nn.ReLU(inplace=True),
            Conv2d(384, 256, 3, padding=1), nn.ReLU(inplace=True),
            Conv2d(256, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2))
        self.classifier = nn.Sequential(
            Dropout(dropout_rate), Dense(256 * 6 * 6, 4096),
            nn.ReLU(inplace=True),
            Dropout(dropout_rate), Dense(4096, 4096),
            nn.ReLU(inplace=True),
            Dense(4096, num_classes))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers (``models/init.py``)."""
        init_like_flax(self, generator)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The activations' dtype; the parameters' unless set."""
        return self._compute_dtype or self.classifier[1].bias.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.to(self.compute_dtype))
        # torchvision AdaptiveAvgPool2d((6, 6)); identity at 224x224 input
        x = adaptive_avg_pool(x.permute(0, 2, 3, 1), (6, 6)).permute(0, 3, 1, 2)
        x = torch.flatten(x, 1)                 # CHW order, as torchvision
        return self.classifier(x).to(torch.float32)
