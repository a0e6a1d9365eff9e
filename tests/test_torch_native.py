"""The port's copy of the native staging library
(``idunno_tpu_torch/native``) and the host data path around it, against
the JAX package's (``idunno_tpu/native``, ``idunno_tpu/engine/data.py``),
on the CPU.

Staging is bit-exact everywhere: the port's library against the JAX
package's, the library against its own numpy fallback, on frames of
several sizes and orientations. The library is built with g++ into
``idunno_tpu_torch/build/``, beside the CUDA kernels.
"""
import os

import numpy as np
import pytest
from PIL import Image

from idunno_tpu import native as jax_native
from idunno_tpu.engine import data as jax_data
from idunno_tpu_torch import native
from idunno_tpu_torch.engine import data as data_lib
from tests.torch_workers import share_cores  # noqa: F401

# (height, width) of the frames: canonical, landscape, portrait, tiny,
# and a long thin frame
SHAPES = [(256, 256), (300, 400), (480, 320), (17, 9), (512, 100)]


def frames(seed: int, shapes=SHAPES) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in shapes]


def test_library_builds_under_the_port_build_dir():
    lib = native.get_lib()
    assert lib is not None and native.available()
    path = lib._name
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("idunno_tpu_torch",
                                                  "build"))
    assert os.path.basename(path).startswith("_native_")


@pytest.mark.parametrize("size", [256, 224, 64])
def test_stage_batch_bit_equal_to_jax_package(size):
    fs = frames(size)
    out = native.stage_batch(fs, size)
    assert out.shape == (len(fs), size, size, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jax_native.stage_batch(fs, size))


def test_library_and_numpy_fallback_bit_equal():
    fs = frames(3)
    np.testing.assert_array_equal(native.stage_batch(fs, 256),
                                  native._stage_batch_np(fs, 256))
    for f in fs:
        for dh, dw in ((224, 224), (256, 300), (31, 17)):
            np.testing.assert_array_equal(
                native.resize_bilinear(f, dh, dw),
                native._resize_bilinear_np(f, dh, dw))


def test_canonical_frames_stage_unchanged():
    fs = frames(4, [(256, 256)] * 3)
    np.testing.assert_array_equal(native.stage_batch(fs, 256), np.stack(fs))


def test_load_range_matches_jax_package(tmp_path):
    """Decoded files (3 of 5 present, non-square) and synthetic
    placeholders for the missing ones: the same names and bytes."""
    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 256, (300, 280, 3), dtype=np.uint8)
        Image.fromarray(arr).save(str(tmp_path / f"test_{i}.JPEG"))
    names, batch = data_lib.load_range(str(tmp_path), 0, 4)
    want_names, want = jax_data.load_range(str(tmp_path), 0, 4)
    assert names == want_names == [f"test_{i}.JPEG" for i in range(5)]
    np.testing.assert_array_equal(batch, want)


@pytest.mark.parametrize("n,batch_size", [(10, 4), (8, 8), (0, 3)])
def test_iter_batches_matches_jax_package(n, batch_size):
    names, images = data_lib.load_range(None, 0, n - 1, size=32)
    got = list(data_lib.iter_batches(names, images, batch_size))
    want = list(jax_data.iter_batches(names, images, batch_size))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert len(got) == -(-n // batch_size)
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
