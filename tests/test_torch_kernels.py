"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``gpu``) and skips where there is
none; the card is looked for inside a fixture, never at import time. The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from idunno_tpu_torch.config import EngineConfig
from idunno_tpu_torch.engine import data as data_lib
from idunno_tpu_torch.engine.inference import InferenceEngine
from idunno_tpu_torch.ops.preprocess_kernel import (preprocess_batch_kernel,
                                                    preprocess_batch_plain)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


# (batch, side, crop): the main path's shape; the ragged 240² batch of
# tests/test_pallas_ops.py, whose rows are not 16-byte aligned (the
# one-byte-per-thread kernel); an odd crop; a crop of the whole image
@pytest.mark.gpu
@pytest.mark.parametrize("batch,side,crop", [
    (256, 256, 224), (3, 240, 224), (2, 256, 225), (1, 224, 224)])
def test_preprocess_kernel_matches_plain_version(cuda_device, batch, side,
                                                 crop):
    rng = np.random.default_rng(side + crop)
    imgs = torch.from_numpy(rng.integers(
        0, 256, (batch, side, side, 3), dtype=np.uint8)).to(cuda_device)
    before = preprocess_batch_kernel.launches
    out = preprocess_batch_kernel(imgs, crop)
    torch.cuda.synchronize()
    assert preprocess_batch_kernel.launches == before + 1
    assert out.shape == (batch, crop, crop, 3) and out.dtype == torch.bfloat16
    ref = preprocess_batch_plain(imgs, crop)
    # the kernel forbids FMA contraction and rounds to nearest-even like
    # the plain version: bit for bit equal
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["resnet", "alexnet"])
def test_kernel_mode_matches_plain_mode_on_card(cuda_device, name):
    cfg = dict(batch_size=8, image_size=224, resize_size=256)
    kern = InferenceEngine(EngineConfig(preprocess="kernel", **cfg))
    plain = InferenceEngine(EngineConfig(preprocess="plain", **cfg))
    _, images = data_lib.load_range(None, 0, 7)
    batch = torch.from_numpy(images).to(cuda_device)
    before = preprocess_batch_kernel.launches
    out = kern.logits(name, batch)
    assert preprocess_batch_kernel.launches == before + 1
    ref = plain.logits(name, batch)
    # plain mode normalizes in f32 (divide) and the model rounds to bf16;
    # the kernel multiplies and rounds: the bf16 inputs differ at most in
    # a few elements by one ulp, so the bf16 logits agree closely
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-2 * scale)
