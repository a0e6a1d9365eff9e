"""Model registry, mirroring ``idunno_tpu/models/__init__.py``.

The reference supports exactly two model names, dispatched by string
(`alexnet_resnet.py:17-22`, `mp4_machinelearning.py:560-571`): ``alexnet``
and ``resnet`` (ResNet-18). Those are the registry keys; the registry is
extensible, and holds the other ResNets and the ViTs (``vit`` is ViT-S/16,
``vit_tiny`` ViT-Ti/16 at depth 4), as the JAX package's does.
"""
from __future__ import annotations

from collections.abc import Callable

from torch import nn

from idunno_tpu_torch.models.alexnet import AlexNet
from idunno_tpu_torch.models.resnet import ResNet, resnet18, resnet34, resnet50
from idunno_tpu_torch.models.vit import ViT, vit_s16, vit_tiny

_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "alexnet": AlexNet,
    "resnet": resnet18,      # the reference's "resnet" means ResNet-18
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "vit": vit_s16,
    "vit_tiny": vit_tiny,
}


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def create_model(name: str, **kwargs) -> nn.Module:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; available: {available_models()}") from None
    return factory(**kwargs)


def register_model(name: str, factory: Callable[..., nn.Module]) -> None:
    _REGISTRY[name] = factory


__all__ = ["AlexNet", "ResNet", "ViT", "resnet18", "resnet34", "resnet50",
           "vit_s16", "vit_tiny", "create_model", "available_models",
           "register_model"]
