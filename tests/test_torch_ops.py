"""Parity of the PyTorch port's CNN ops with the JAX package, on the CPU.

Inputs come from a numpy seed and go through the JAX function and its port
counterpart. The preprocess kernel's plain version is held to the Pallas
kernel run in interpret mode (its arithmetic) and to the plain f32
preprocess; tests/test_torch_kernels.py holds the CUDA kernel itself to
that plain version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.ops.classify import top1_from_logits as jax_top1
from idunno_tpu.ops.pallas_preprocess import preprocess_batch_pallas
from idunno_tpu.ops.pooling import adaptive_avg_pool as jax_adaptive_avg_pool
from idunno_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from idunno_tpu_torch.ops.classify import top1_from_logits
from idunno_tpu_torch.ops.pooling import adaptive_avg_pool
from idunno_tpu_torch.ops.preprocess import center_crop, preprocess_batch
from idunno_tpu_torch.ops.preprocess_kernel import (preprocess_batch_kernel,
                                                    preprocess_batch_plain)

# (batch, input side): the canonical 256² input, and the ragged 240² batch
# of tests/test_pallas_ops.py (its rows are not 16-byte aligned)
PREPROCESS_SHAPES = [(4, 256), (3, 240)]


def u8_images(seed: int, batch: int, side: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(batch, side, side, 3), dtype=np.uint8)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def assert_within_bf16_ulp(a: np.ndarray, b: np.ndarray) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a - b) <= ulp), float(np.max(np.abs(a - b) / ulp))


@pytest.mark.parametrize("batch,side", PREPROCESS_SHAPES)
def test_kernel_plain_version_matches_pallas_kernel(batch, side):
    imgs = u8_images(side, batch, side)
    ref = preprocess_batch_pallas(jnp.asarray(imgs), crop=224, interpret=True)
    out = preprocess_batch_plain(torch.from_numpy(imgs), 224)
    assert out.dtype == torch.bfloat16 and out.shape == (batch, 224, 224, 3)
    # same arithmetic order, each step rounded in f32: at most 1 bf16 ulp
    # apart (XLA on the CPU may contract the multiply-subtract)
    assert_within_bf16_ulp(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("batch,side", PREPROCESS_SHAPES)
def test_kernel_plain_version_matches_f32_preprocess(batch, side):
    imgs = u8_images(side + 1, batch, side)
    ref = np.asarray(jax_preprocess(jnp.asarray(imgs), crop=224))
    out = preprocess_batch_plain(torch.from_numpy(imgs), 224).float().numpy()
    # bf16 rounding of values in (-2.2, 2.7): half a bf16 ulp at |x| < 4
    np.testing.assert_allclose(out, ref, atol=1 / 128, rtol=0)


@pytest.mark.parametrize("batch,side", PREPROCESS_SHAPES)
def test_preprocess_batch_matches_jax(batch, side):
    imgs = u8_images(side + 2, batch, side)
    ref = np.asarray(jax_preprocess(jnp.asarray(imgs), crop=224))
    out = preprocess_batch(torch.from_numpy(imgs), crop=224)
    assert out.dtype == torch.float32
    # the same f32 divide-subtract-divide on both sides; only the libm of
    # the two frameworks differs, so allow one f32 ulp at |x| < 4
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-7, rtol=0)


def test_center_crop_offsets():
    x = torch.arange(2 * 9 * 8 * 3).reshape(2, 9, 8, 3)
    out = center_crop(x, 4)
    # top = (9 - 4) // 2 = 2, left = (8 - 4) // 2 = 2
    assert torch.equal(out, x[:, 2:6, 2:6, :])


@pytest.mark.parametrize("batch,side", PREPROCESS_SHAPES)
def test_kernel_wrapper_on_cpu_is_plain_version(batch, side):
    imgs = torch.from_numpy(u8_images(side + 3, batch, side))
    before = preprocess_batch_kernel.launches
    out = preprocess_batch_kernel(imgs, 224)
    assert torch.equal(out, preprocess_batch_plain(imgs, 224))
    assert preprocess_batch_kernel.launches == before   # no kernel ran


@pytest.mark.parametrize("bad,err", [
    (torch.zeros((2, 64, 64, 3), dtype=torch.float32), TypeError),
    (torch.zeros((64, 64, 3), dtype=torch.uint8), ValueError),
    (torch.zeros((2, 64, 64, 4), dtype=torch.uint8), ValueError),
    (torch.zeros((2, 3, 64, 64), dtype=torch.uint8).permute(0, 2, 3, 1),
     ValueError),
    (torch.zeros((2, 32, 64, 3), dtype=torch.uint8), ValueError),
])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(bad, err):
    with pytest.raises(err):
        preprocess_batch_kernel(bad, 48)


def test_top1_matches_jax_including_ties():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((16, 1000)).astype(np.float32)
    logits[3, [5, 17, 900]] = 50.0          # three-way tie: first index wins
    logits[4, :] = 0.0                      # flat row: index 0
    ref_idx, ref_prob = jax_top1(jnp.asarray(logits))
    idx, prob = top1_from_logits(torch.from_numpy(logits))
    assert idx.dtype == torch.int32 and prob.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert idx[3] == 5 and idx[4] == 0
    # f32 softmax over 1000 classes in two libraries: a few f32 ulps
    np.testing.assert_allclose(prob.numpy(), np.asarray(ref_prob),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("hw", [(13, 13), (7, 9), (1, 1), (6, 6)])
def test_adaptive_avg_pool_matches_jax(hw):
    rng = np.random.default_rng(hw[0] * 31 + hw[1])
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    ref = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), (6, 6)))
    out = adaptive_avg_pool(torch.from_numpy(x), (6, 6)).numpy()
    assert out.shape == (2, 6, 6, 5)
    # means of at most 9 f32 values, summed in another order
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

