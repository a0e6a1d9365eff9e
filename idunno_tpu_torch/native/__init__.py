"""ctypes bindings for the native runtime library, built on demand: a copy
of ``idunno_tpu/native``.

One shared object holds every native component — image staging
(`stage.cc`, the data-loader hot path) and the log-scan engine
(`grepscan.cc`, the distributed-grep hot path; unused until the port's
grep lands). Built with ``g++ -O3 -march=native -fopenmp`` at first use
into ``idunno_tpu_torch/build/`` (beside the CUDA kernels, not next to the
sources), keyed by the sources' joint hash; every entry point has a
pure-Python fallback so the framework works without a toolchain — native
is an accelerator, not a dependency (ctypes, no pybind11).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_SOURCES = [os.path.join(_DIR, "stage.cc"),
            os.path.join(_DIR, "grepscan.cc")]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> ctypes.CDLL | None:
    h = hashlib.sha256()
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"_native_{tag}.so")
    if not os.path.exists(so_path):
        # pid-unique temp so concurrent builds from several local node
        # processes can't interleave writes; os.replace publishes atomically
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
               "-fPIC", *_SOURCES, "-o", tmp]
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (subprocess.SubprocessError, OSError, FileNotFoundError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.resize_bilinear_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    lib.stage_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.grep_literal.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.grep_literal.restype = ctypes.c_int64
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _build()
                _tried = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def _as_u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _axis_coords(s: int, d: int):
    """Half-pixel 16.16 fixed-point source coordinates for one axis —
    bit-identical to stage.cc's ``x * x_step + x_step/2 - 2^15`` clamped."""
    step = (s << 16) // d
    c = np.arange(d, dtype=np.int64) * step + step // 2 - (1 << 15)
    np.clip(c, 0, (s - 1) << 16, out=c)
    lo = c >> 16
    hi = np.minimum(lo + 1, s - 1)
    frac = c & 0xFFFF
    return lo, hi, frac


def _resize_bilinear_np(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Pure-numpy twin of stage.cc's resize_bilinear_u8 (same fixed point,
    same rounding) so staging is pixel-identical with or without g++."""
    sh, sw = src.shape[:2]
    y0, y1, fy = _axis_coords(sh, dh)
    x0, x1, fx = _axis_coords(sw, dw)
    p = src.astype(np.int64)
    r0, r1 = p[y0], p[y1]                       # [dh, sw, 3]
    top = (r0[:, x0] << 16) + (r0[:, x1] - r0[:, x0]) * fx[None, :, None]
    bot = (r1[:, x0] << 16) + (r1[:, x1] - r1[:, x0]) * fx[None, :, None]
    val = (top << 16) + (bot - top) * fy[:, None, None]
    return ((val + (1 << 31)) >> 32).astype(np.uint8)


def resize_bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """RGB u8 [H, W, 3] → [dh, dw, 3]; native when possible, bit-identical
    numpy fallback otherwise."""
    lib = get_lib()
    if lib is None:
        return _resize_bilinear_np(
            np.ascontiguousarray(src, dtype=np.uint8), dh, dw)
    src = np.ascontiguousarray(src, dtype=np.uint8)
    dst = np.empty((dh, dw, 3), np.uint8)
    lib.resize_bilinear_u8(_as_u8_ptr(src), src.shape[0], src.shape[1],
                           _as_u8_ptr(dst), dh, dw)
    return dst


def _stage_batch_np(frames: list[np.ndarray], size: int) -> np.ndarray:
    out = np.empty((len(frames), size, size, 3), np.uint8)
    for i, f in enumerate(frames):
        h, w = f.shape[:2]
        # rounded division, same integer formula as stage.cc
        if w <= h:
            rw, rh = size, max(size, (h * size + w // 2) // w)
        else:
            rh, rw = size, max(size, (w * size + h // 2) // h)
        r = _resize_bilinear_np(
            np.ascontiguousarray(f, dtype=np.uint8), rh, rw)
        top, left = (rh - size) // 2, (rw - size) // 2
        out[i] = r[top:top + size, left:left + size]
    return out


def stage_batch(frames: list[np.ndarray], size: int) -> np.ndarray:
    """K decoded RGB frames (varying sizes) → contiguous u8
    [K, size, size, 3] with shortest-side resize + center crop. OpenMP
    across frames natively; bit-identical serial numpy fallback otherwise."""
    lib = get_lib()
    if lib is None or not frames:
        return _stage_batch_np(frames, size)
    contig = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    k = len(contig)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * k)(
        *[_as_u8_ptr(f) for f in contig])
    dims = np.asarray([[f.shape[0], f.shape[1]] for f in contig],
                      dtype=np.int32)
    dst = np.empty((k, size, size, 3), np.uint8)
    lib.stage_batch_u8(ptrs, dims.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int32)), k, size, _as_u8_ptr(dst))
    return dst


def grep_literal(path: str, needle: str,
                 max_offsets: int = 10_000) -> tuple[int, list[int]] | None:
    """Count lines of ``path`` containing the literal ``needle``; also
    return up to ``max_offsets`` matching line-start byte offsets
    (ascending). None when the native library is unavailable (caller falls
    back to the Python scanner) or the file cannot be read."""
    lib = get_lib()
    if lib is None:
        return None
    offsets = np.empty(max_offsets, np.int64)
    n_written = ctypes.c_int64(0)
    total = lib.grep_literal(
        path.encode(), needle.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_offsets, ctypes.byref(n_written))
    if total < 0:
        return None
    return int(total), offsets[:n_written.value].tolist()
