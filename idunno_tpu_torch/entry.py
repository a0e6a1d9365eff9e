"""The port's counterpart of ``__graft_entry__.py:entry()``.

``entry()`` gives one forward step of the flagship model (ResNet-18, the
reference's headline model) and its example inputs, for a check that
the model builds and runs on its device:

    from idunno_tpu_torch.entry import entry
    forward, (model, images) = entry()          # on the card
    classes, probs = forward(model, images)

The forward is the JAX entry's, step for step: the center crop and
normalisation of a uint8 NHWC batch, the model, and top-1. The crop and
normalisation go through the K1 wrapper
(``ops/preprocess_kernel.py:preprocess_batch_kernel``): on a CUDA tensor
it launches K1 (``csrc/preprocess.cu``), whatever ``auto`` means
elsewhere; on a CPU tensor it runs K1's plain version. K1 writes bf16,
the model takes it in f32 (its parameters' dtype), so the input holds
K1's rounding of the normalised image (2^-9 relative at most).
``device="cpu"`` is the only way onto the CPU: without it the step runs
on the card and raises where there is none.
"""
from __future__ import annotations

import torch

from idunno_tpu_torch.engine.inference import resolve_device
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.ops.classify import top1_from_logits
from idunno_tpu_torch.ops.preprocess_kernel import preprocess_batch_kernel

CROP = 224


def logits(model: torch.nn.Module, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC [B, 256, 256, 3] → f32 logits [B, classes]: K1 (or its
    plain version on a CPU tensor), then the model."""
    x = preprocess_batch_kernel(images_u8, CROP)
    return model(x.to(torch.float32).permute(0, 3, 1, 2))


@torch.inference_mode()
def forward(model: torch.nn.Module, images_u8: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One forward step: ([B] int32 class ids, [B] f32 probabilities)."""
    return top1_from_logits(logits(model, images_u8))


def entry(device: torch.device | str | None = None):
    """``(forward, (model, example_images))``: ResNet-18 with flax's
    initialisers drawn from a ``torch.Generator`` seeded 0, in eval mode
    on ``device`` (the card by default), and a zero uint8 batch [8, 256,
    256, 3] on the same device."""
    dev = resolve_device(device)
    model = create_model("resnet")
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    example_images = torch.zeros((8, 256, 256, 3), dtype=torch.uint8,
                                 device=dev)
    return forward, (model, example_images)
