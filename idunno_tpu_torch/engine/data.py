"""Host-side image loading, mirroring ``idunno_tpu/engine/data.py``.

The reference's loader is a per-image loop: glob ``test_<N>.JPEG``, PIL
open, RGB-convert, torchvision transforms (`alexnet_resnet.py:46-66`).
Here the host decodes and resizes to a canonical static 256x256 uint8 NHWC
batch (shortest-side resize to 256 + center crop); everything after that
runs on the device (``ops/preprocess.py``, ``ops/preprocess_kernel.py``).

A synthetic generator stands in for the dataset when no image files exist:
deterministic per-index uint8 images, the same as the JAX package's.

Staging keeps its own copy of the JAX package's numpy staging
(``idunno_tpu/native/__init__.py:_stage_batch_np``), which is bit-identical
to its C++/OpenMP library; porting that library is still to do
(ROADMAP.md).
"""
from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("idunno.data")

CANONICAL_SIZE = 256


def image_name(index: int) -> str:
    """Reference dataset naming: ``test_<N>.JPEG`` (`alexnet_resnet.py:49`)."""
    return f"test_{index}.JPEG"


def image_path(root: str, index: int) -> str:
    return os.path.join(root, image_name(index))


def synthetic_image(index: int, size: int = CANONICAL_SIZE) -> np.ndarray:
    """Deterministic pseudo-image for a dataset index (no files needed)."""
    rng = np.random.default_rng(index)
    return rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)


def decode_image(path: str) -> np.ndarray:
    """Decode one file → raw RGB uint8 [H, W, 3] (no resize)."""
    from PIL import Image
    with Image.open(path) as img:
        if img.mode != "RGB":
            img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)


def _axis_coords(s: int, d: int):
    """Half-pixel 16.16 fixed-point source coordinates for one axis."""
    step = (s << 16) // d
    c = np.arange(d, dtype=np.int64) * step + step // 2 - (1 << 15)
    np.clip(c, 0, (s - 1) << 16, out=c)
    lo = c >> 16
    hi = np.minimum(lo + 1, s - 1)
    frac = c & 0xFFFF
    return lo, hi, frac


def _resize_bilinear_np(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Fixed-point bilinear resize of RGB u8 [H, W, 3] → [dh, dw, 3]."""
    sh, sw = src.shape[:2]
    y0, y1, fy = _axis_coords(sh, dh)
    x0, x1, fx = _axis_coords(sw, dw)
    p = src.astype(np.int64)
    r0, r1 = p[y0], p[y1]                       # [dh, sw, 3]
    top = (r0[:, x0] << 16) + (r0[:, x1] - r0[:, x0]) * fx[None, :, None]
    bot = (r1[:, x0] << 16) + (r1[:, x1] - r1[:, x0]) * fx[None, :, None]
    val = (top << 16) + (bot - top) * fy[:, None, None]
    return ((val + (1 << 31)) >> 32).astype(np.uint8)


def stage_batch(frames: list[np.ndarray], size: int) -> np.ndarray:
    """K decoded RGB frames (varying sizes) → contiguous u8
    [K, size, size, 3] with shortest-side resize + center crop. A frame
    already ``size``² is copied as it is: the resize is the identity there
    (every source coordinate is whole), so the result is the same."""
    out = np.empty((len(frames), size, size, 3), np.uint8)
    for i, f in enumerate(frames):
        h, w = f.shape[:2]
        if (h, w) == (size, size):
            out[i] = f
            continue
        # rounded division, same integer formula as the JAX package's
        if w <= h:
            rw, rh = size, max(size, (h * size + w // 2) // w)
        else:
            rh, rw = size, max(size, (w * size + h // 2) // h)
        r = _resize_bilinear_np(
            np.ascontiguousarray(f, dtype=np.uint8), rh, rw)
        top, left = (rh - size) // 2, (rw - size) // 2
        out[i] = r[top:top + size, left:left + size]
    return out


def load_range(root: str | None, start: int, end: int,
               size: int = CANONICAL_SIZE) -> tuple[list[str], np.ndarray]:
    """Load dataset indices [start, end] inclusive (the reference's range
    convention, `alexnet_resnet.py:48`) → (names, uint8 [N, size, size, 3]).

    Decode runs in a thread pool (PIL releases the GIL), then
    ``stage_batch`` packs all frames into one contiguous batch. Missing
    files become synthetic images, so a query over a partially-present
    dataset still completes with an exact result count."""
    from concurrent.futures import ThreadPoolExecutor

    indices = list(range(start, end + 1))
    names = [image_name(i) for i in indices]
    if not indices:
        return names, np.zeros((0, size, size, 3), np.uint8)

    def fetch(i: int) -> np.ndarray:
        path = image_path(root, i) if root else None
        if path and os.path.exists(path):
            try:
                return decode_image(path)
            except OSError as e:
                # present-but-undecodable is a data problem, not a missing
                # index — surface it, then still classify a placeholder so
                # the query's result count stays exact.
                logger.warning("decode failed for %s (%s); "
                               "substituting placeholder", path, e)
        return synthetic_image(i, size)

    if len(indices) > 1:
        with ThreadPoolExecutor(max_workers=min(16, len(indices))) as pool:
            frames = list(pool.map(fetch, indices))
    else:
        frames = [fetch(indices[0])]
    return names, stage_batch(frames, size)

