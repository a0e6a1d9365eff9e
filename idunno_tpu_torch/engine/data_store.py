"""Dataset staging through the replicated store.

The reference distributes its dataset over SDFS before inferring: `put` the
images, workers `get` them to local disk, then the model reads local files
(`README.md:37-38`, `mp4_machinelearning.py:886-945`). This module is that
flow made native: a dataset is published ONCE into the replicated store as
packed uint8 shards + a JSON meta object, and every worker stages the
shards it needs on demand into a host-local cache (fetch once per shard per
host — re-replication keeps shards alive through failures like any other
store object).

Engine integration: pass ``dataset_root="store://<name>"`` anywhere a
dataset root is accepted (`InferenceEngine.infer`, the `inference` control/
shell verbs carry it through jobs) and workers resolve ranges against the
published dataset instead of local files.

Shards are raw uint8 bytes (no per-image codec) so staging is a straight
memcpy into the [N, S, S, 3] batch the device path consumes — decode cost
was paid once at publish time, not per query (the reference re-decodes
every image on every task, `alexnet_resnet.py:46-66`).
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np

from idunno_tpu_torch.engine.data import image_name, synthetic_image

STORE_SCHEME = "store://"


def dataset_meta_name(name: str) -> str:
    return f"dataset/{name}/meta"


def dataset_shard_name(name: str, k: int) -> str:
    return f"dataset/{name}/shard_{k}"


def publish_images(store, name: str, images: np.ndarray, *,
                   shard_size: int = 256) -> dict:
    """Publish a packed uint8 image block [N, S, S, 3] as store shards;
    returns the meta dict (incl. n/size/shard count)."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or images.shape[1] != images.shape[2] \
            or images.shape[3] != 3:
        raise ValueError(f"want [N, S, S, 3] uint8, got {images.shape}")
    if shard_size < 1:
        raise ValueError(f"shard_size={shard_size}: must be >= 1")
    n, size = images.shape[0], images.shape[1]
    n_shards = -(-n // shard_size) if n else 0
    for k in range(n_shards):
        block = images[k * shard_size:(k + 1) * shard_size]
        store.put_bytes(dataset_shard_name(name, k), block.tobytes())
    meta = {"n": n, "size": size, "shard_size": shard_size,
            "n_shards": n_shards}
    store.put_bytes(dataset_meta_name(name), json.dumps(meta).encode())
    return meta


class StoreDataset:
    """Range reader over a published dataset with a host-local shard cache.

    ``cache_dir`` (one per host) holds fetched shards as flat files; every
    node fetches a shard at most once, matching the reference's
    stage-to-local-disk procedure. Thread-safe: worker job threads may
    load overlapping ranges concurrently."""

    def __init__(self, store, name: str,
                 cache_dir: str | None = None) -> None:
        self.store = store
        self.name = name
        blob, self.version = store.get_bytes(dataset_meta_name(name))
        meta = json.loads(blob)
        self.n = int(meta["n"])
        self.size = int(meta["size"])
        self.shard_size = int(meta["shard_size"])
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._mem: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def _shard_path(self, k: int) -> str:
        # version-qualified: a re-published dataset never serves stale cache
        return os.path.join(self.cache_dir, f"shard_{k}.v{self.version}.u8")

    # without a disk cache, shards live in RAM — bound how many (a full
    # dataset pinned in host memory per engine can OOM the node)
    _MEM_SHARDS_MAX = 64

    def _shard(self, k: int) -> np.ndarray:
        with self._lock:
            arr = self._mem.get(k)
        if arr is not None:
            return arr
        rows = min(self.shard_size, self.n - k * self.shard_size)
        shape = (rows, self.size, self.size, 3)
        nbytes = int(np.prod(shape))
        path = self._shard_path(k) if self.cache_dir else None
        if path is not None:
            if not (os.path.exists(path)
                    and os.path.getsize(path) == nbytes):  # torn write
                blob, _ = self.store.get_bytes(
                    dataset_shard_name(self.name, k))
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)                 # atomic vs readers
            # memmap: the OS page cache backs reads, nothing is pinned in
            # this process — host RSS stays bounded however big the dataset
            arr = np.memmap(path, dtype=np.uint8, mode="r", shape=shape)
        else:
            blob, _ = self.store.get_bytes(dataset_shard_name(self.name, k))
            arr = np.frombuffer(blob, dtype=np.uint8).reshape(shape)
        with self._lock:
            self._mem[k] = arr
            # bound the cache either way: RAM for frombuffer shards, open
            # file handles for memmaps (both re-acquire cheaply)
            while len(self._mem) > self._MEM_SHARDS_MAX:   # oldest-first
                self._mem.pop(next(iter(self._mem)))
        return arr

    def load_range(self, start: int,
                   end: int) -> tuple[list[str], np.ndarray]:
        """Indices [start, end] inclusive → (names, uint8 [N, S, S, 3]).
        Out-of-range indices get the deterministic synthetic placeholder —
        same contract as the local-file loader (result counts stay exact)."""
        indices = list(range(start, end + 1))
        names = [image_name(i) for i in indices]
        if not indices:
            return names, np.zeros((0, self.size, self.size, 3), np.uint8)
        out = np.empty((len(indices), self.size, self.size, 3), np.uint8)
        i = 0
        while i < len(indices):
            idx = indices[i]
            if not 0 <= idx < self.n:
                out[i] = synthetic_image(idx, self.size)
                i += 1
                continue
            k = idx // self.shard_size
            shard = self._shard(k)
            lo = idx - k * self.shard_size
            take = min(len(shard) - lo, len(indices) - i)
            out[i:i + take] = shard[lo:lo + take]
            i += take
        return names, out
