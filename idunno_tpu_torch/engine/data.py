"""Host-side image loading, mirroring ``idunno_tpu/engine/data.py``.

The reference's loader is a per-image loop: glob ``test_<N>.JPEG``, PIL
open, RGB-convert, torchvision transforms (`alexnet_resnet.py:46-66`).
Here the host decodes and resizes to a canonical static 256x256 uint8 NHWC
batch (shortest-side resize to 256 + center crop); everything after that
runs on the device (``ops/preprocess.py``, ``ops/preprocess_kernel.py``).

A synthetic generator stands in for the dataset when no image files exist:
deterministic per-index uint8 images, the same as the JAX package's.

Staging runs through the port's copy of the native library
(``idunno_tpu_torch/native``: C++ with OpenMP across frames, built with g++
at first use), whose numpy fallback is bit-identical to it.
"""
from __future__ import annotations

import logging
import os
from collections.abc import Iterator

import numpy as np

from idunno_tpu_torch import native

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


def load_range(root: str | None, start: int, end: int,
               size: int = CANONICAL_SIZE) -> tuple[list[str], np.ndarray]:
    """Load dataset indices [start, end] inclusive (the reference's range
    convention, `alexnet_resnet.py:48`) → (names, uint8 [N, size, size, 3]).

    Decode runs in a thread pool (PIL releases the GIL), then the native
    staging library resizes, crops and packs all frames into one
    contiguous batch with OpenMP (``native.stage_batch``). Missing
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
    return names, native.stage_batch(frames, size)


def iter_batches(names: list[str], images: np.ndarray,
                 batch_size: int) -> Iterator[tuple[list[str], np.ndarray]]:
    """(names, images) in consecutive chunks of ``batch_size``; the last
    chunk may be shorter."""
    for i in range(0, len(names), batch_size):
        yield names[i:i + batch_size], images[i:i + batch_size]

