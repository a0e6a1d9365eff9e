"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>_<hash>.so``, where the hash
covers the source, the headers it may include (``csrc/*.cuh``) and the
flags, then loaded with ``ctypes``. Nothing is
built when a module is imported: the wrapper of a kernel asks for its
library on its first launch, and ``build`` compiles several sources at
once, one ``nvcc`` each, all started together. ``nvcc -Xptxas -v`` reports
(registers, spills) are kept beside each library for ``ptxas_report``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit on PATH or under /usr/local/cuda")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built for the current source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, path), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: list[str]) -> dict[str, str]:
    """Compile every source of ``names`` that has no current library, all
    ``nvcc`` processes at once; returns name → library path. Raises with
    the compiler's output when any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    running = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        # pid-unique temp, published with os.replace: concurrent builds
        # never see a half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        with open(paths[name] + ".ptxas.txt", "w") as f:
            f.write(out)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    current build of ``csrc/<name>.cu``; empty when it was not built here."""
    path = library_path(name) + ".ptxas.txt"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
