"""Training step for the CNN families, and what every training step shares:
the train state and the optimizers.

A port of ``idunno_tpu/engine/train.py`` without its mesh placement (slice
4). PyTorch trains in place: a step runs the forward, ``backward`` fills
each parameter's ``.grad``, and the optimizer updates the parameters and
its moments in place, where the JAX step returns a new state. So the
train state holds the live model and its optimizer, not copies of their
tensors, and a step returns only its metrics.

Optimizers are factories, ``params -> torch.optim.Optimizer``, with the
hyperparameters of the optax transformations the JAX callers use written
out (``adamw``, ``adam``, ``sgd``); ``flat_tx`` is the counterpart of
``optax.flatten``.

BatchNorm: flax's ``momentum=0.9`` is torch's ``momentum=0.1``, and the
port's ResNets use ``models/resnet.py:BatchNorm2d``, which folds the
*biased* batch variance into the running variance, as flax does (torch's
own ``nn.BatchNorm2d`` folds the unbiased one). So the running statistics
follow flax's rule; ``tests/test_torch_train.py`` holds both to the JAX
step's directly.
"""
from __future__ import annotations

import functools
from collections.abc import Callable, Iterable
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from idunno_tpu_torch.engine.inference import resolve_device
from idunno_tpu_torch.models.init import init_like_flax

TxFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


@dataclass
class TrainState:
    """``step``, the model and its optimizer. BatchNorm statistics live in
    the model's buffers, so nothing else is carried (the JAX state's
    ``batch_stats`` and ``opt_state`` are inside ``model`` and
    ``optimizer``)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def adamw(lr: float, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> TxFactory:
    """``optax.adamw(lr)``: its defaults, with weight decay 1e-4 applied to
    every parameter (``torch.optim.AdamW`` defaults to 1e-2)."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay,
                             foreach=False)


def adam(lr: float, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> TxFactory:
    """``optax.adam(lr)``: no weight decay."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=0.0, foreach=False)


def sgd(lr: float, momentum: float = 0.0) -> TxFactory:
    """``optax.sgd(lr, momentum)``: heavy-ball momentum with no dampening
    and no Nesterov term (the first step's trace is the gradient in both)."""
    return functools.partial(torch.optim.SGD, lr=lr, momentum=momentum,
                             dampening=0.0, nesterov=False, foreach=False)


def flat_tx(inner: TxFactory) -> TxFactory:
    """The counterpart of ``optax.flatten`` (``engine/train.py:flat_tx``
    in the JAX package): one update over all parameters instead of one per
    tensor. The factories above update tensor by tensor (``foreach=False``,
    a loop of small launches, as optax's per-leaf update is); this one
    takes ``fused=True``: the whole update (moments, bias correction,
    decay, step) is one multi-tensor kernel that walks many parameters per
    launch, where ``foreach=True`` would still make about a dozen passes
    over every parameter, one per elementwise op. Same per-element math,
    in place."""
    return functools.partial(inner, foreach=False, fused=True)


def place(model: nn.Module, generator: torch.Generator,
          device: str | torch.device | None) -> nn.Module:
    """Move ``model`` to ``device`` (``None``: the card) and seed it there
    with flax's initialisers (``models/init.py``; a model with its own
    ``init_weights`` uses that) from ``generator``, which lies on the same
    device."""
    model = model.to(resolve_device(device))
    init = getattr(model, "init_weights", None)
    if init is not None:
        init(generator)
    else:
        init_like_flax(model, generator)
    return model


def create_train_state(model: nn.Module, generator: torch.Generator,
                       tx_factory: TxFactory,
                       device: str | torch.device | None = None
                       ) -> TrainState:
    """A seeded model on ``device`` (``None``: the card, which must be
    present), in training mode, with its optimizer over every parameter."""
    model = place(model, generator, device).train()
    return TrainState(step=0, model=model,
                      optimizer=tx_factory(model.parameters()))


def check_state(state: TrainState, model: nn.Module,
                optimizer: torch.optim.Optimizer) -> None:
    """Raise unless ``state`` holds the model and optimizer a step was
    made for."""
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the train state holds another model or "
                         "optimizer than this step was made for")


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """``step(state, images, labels) -> metrics``: cross-entropy of the
    model in training mode (BatchNorm on batch statistics, its running
    statistics updated), backward, one in-place optimizer update.
    ``images`` are what the model takes (NCHW f32); labels int64 [B].
    Metrics are 0-d tensors on the device: ``loss`` and ``accuracy``."""

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        check_state(state, model, optimizer)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(images)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step
