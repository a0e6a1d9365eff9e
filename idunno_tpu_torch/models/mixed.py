"""Layers that compute in their input's dtype over parameters kept in
their own: flax's ``dtype`` (the compute dtype) beside ``param_dtype``.

A flax ``Conv`` or ``Dense`` built with ``dtype=bfloat16,
param_dtype=float32`` keeps f32 parameters (the master weights an
optimizer updates) and casts its kernel and bias to bf16 for the product.
These subclasses (the CNNs' convs and FC, every Dense of the
transformers) do the same against the dtype of the activations they are
handed: the cast is a no-op where the dtypes agree (the serving
engine's bf16 weights under bf16 compute), so a model that never sets a
compute dtype runs exactly as the plain torch layer would. The parameter
names stay torch's (``weight``, ``bias``), so state dicts, the weight
carry (``models/convert.py``) and int8 weights (``ops/quantize.py``) are
unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from idunno_tpu_torch.parallel.data import dropout_plan


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its weight and bias to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Dense(nn.Linear):
    """``nn.Linear`` that casts its weight and bias to the input's dtype
    before the product (flax ``Dense`` with ``dtype`` = the compute dtype;
    a no-op when the dtypes agree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Dropout(nn.Dropout):
    """``nn.Dropout``, whose masks inside a data-parallel step come from
    the step's plan (``parallel/data.py:DropoutPlan``: the global batch's
    mask, this group's rows), so every mesh shape draws the same masks;
    elsewhere torch's generator draws them, as ``nn.Dropout`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        plan = dropout_plan() if self.training and self.p > 0 else None
        if plan is None:
            return super().forward(x)
        keep = plan.keep(x, self.p)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))
