"""Fused center-crop + uint8 → normalized bf16: the CUDA kernel and its
plain version.

The kernel (``csrc/preprocess.cu``) replaces the TPU kernel
``idunno_tpu/ops/pallas_preprocess.py:_norm_kernel``. It is bound by memory
bandwidth (one u8 read and one bf16 write per element) and fuses the crop
the TPU version leaves to a separate slice. ``preprocess_batch_kernel``
launches it for a CUDA tensor and raises on anything it cannot take; for a
CPU tensor it runs ``preprocess_batch_plain``, which repeats the kernel's
arithmetic in plain tensor ops, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from idunno_tpu_torch.ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                             center_crop)

# The kernel's constants, in f32 exactly as the Pallas kernel forms them:
# x * f32(1/255), mean as f32, inv_std = f32(1) / f32(std).
SCALE = np.float32(1.0 / 255.0)
MEAN = np.asarray(IMAGENET_MEAN, dtype=np.float32)
INV_STD = np.float32(1.0) / np.asarray(IMAGENET_STD, dtype=np.float32)


def preprocess_batch_plain(images_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """uint8 NHWC → bf16 NHWC ``crop``² in the kernel's arithmetic order:
    multiply by 1/255, subtract the mean, multiply by 1/std, each rounded
    in f32, then round to bf16."""
    x = center_crop(images_u8, crop).to(torch.float32)
    dev = x.device
    x = x * torch.from_numpy(np.array(SCALE)).to(dev)
    x = x - torch.from_numpy(MEAN).to(dev)
    x = x * torch.from_numpy(INV_STD).to(dev)
    return x.to(torch.bfloat16)


def _check(images_u8: torch.Tensor, crop: int) -> None:
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"preprocess kernel takes uint8, got {images_u8.dtype}")
    if images_u8.dim() != 4 or images_u8.shape[3] != 3:
        raise ValueError("preprocess kernel takes NHWC [B, H, W, 3], got "
                         f"shape {tuple(images_u8.shape)}")
    if not images_u8.is_contiguous():
        raise ValueError("preprocess kernel takes a contiguous batch")
    h, w = images_u8.shape[1], images_u8.shape[2]
    if crop <= 0 or h < crop or w < crop:
        raise ValueError(f"crop {crop} does not fit a {h}x{w} image")


def _kernel_lib() -> ctypes.CDLL:
    from idunno_tpu_torch.ops import cuda_build

    lib = cuda_build.load("preprocess")
    fn = lib.idunno_crop_normalize_u8_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def preprocess_batch_kernel(images_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """uint8 NHWC [B, H, W, 3] → normalized bf16 NHWC [B, crop, crop, 3].

    On a CUDA tensor: one launch of the CUDA kernel on the current stream
    (no synchronize); raises on a bad input or a refused launch. On a CPU
    tensor: the plain version. ``preprocess_batch_kernel.launches`` counts
    the kernel's launches."""
    _check(images_u8, crop)
    if images_u8.device.type == "cpu":
        return preprocess_batch_plain(images_u8, crop)
    if images_u8.device.type != "cuda":
        raise ValueError(f"preprocess kernel runs on cuda or cpu tensors, "
                         f"got {images_u8.device}")
    b, h, w, _ = images_u8.shape
    out = torch.empty((b, crop, crop, 3), dtype=torch.bfloat16,
                      device=images_u8.device)
    if b == 0:
        return out
    fn = _kernel_lib().idunno_crop_normalize_u8_bf16
    with torch.cuda.device(images_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(images_u8.data_ptr(), out.data_ptr(), b, h, w, crop,
            float(SCALE), *(float(m) for m in MEAN),
            *(float(s) for s in INV_STD), stream)
    if rc != 0:
        raise RuntimeError(f"preprocess kernel launch failed: cudaError {rc}")
    preprocess_batch_kernel.launches += 1
    return out


preprocess_batch_kernel.launches = 0
