"""The CNN inference engine on PyTorch, mirroring
``idunno_tpu/engine/inference.py``.

Models are built once, held resident on the device in the compute dtype
and ``channels_last`` memory, and run batched. The public contract matches
the reference: ``infer(model, start, end)`` → a ``QueryResult`` whose
records are ``(image_name, category, probability)`` tuples
(`alexnet_resnet.py:92`).

One batch: uint8 NHWC [B, 256, 256, 3] goes to the device through pinned
memory; the preprocess (``EngineConfig.preprocess``) crops and normalizes
it, or the folded stem reads the raw crop; the model runs; softmax + top-1
reduce the logits on the device, and only (index, probability) pairs come
back. The ``kernel`` preprocess writes NHWC bf16, which after
``.permute(0, 3, 1, 2)`` is already a ``channels_last`` NCHW tensor, so no
transpose copy sits at the boundary.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the tests do), and raises when no card is present.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from idunno_tpu_torch.config import EngineConfig
from idunno_tpu_torch.engine import data as data_lib
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.classes import imagenet_categories
from idunno_tpu_torch.ops.classify import top1_from_logits
from idunno_tpu_torch.ops.preprocess import center_crop, preprocess_batch
from idunno_tpu_torch.ops.preprocess_kernel import preprocess_batch_kernel

# the JAX package's replicated-store dataset prefix (engine/data_store.py)
STORE_SCHEME = "store://"
# provenance of every model this engine serves: seeded random weights, or
# weights carried from the JAX package, until a checkpoint can be read
PROVENANCE = "random"


@dataclass
class QueryResult:
    """One executed (sub)query — the reference's return contract
    (`alexnet_resnet.py:92`) plus throughput accounting.

    ``weights`` is the provenance marker (``PROVENANCE`` for this
    engine): random weights must never pass as real classifications."""

    model: str
    records: list[tuple[str, str, float]]   # (image_name, category, prob)
    elapsed_s: float
    weights: str = "unknown"

    @property
    def images_per_s(self) -> float:
        return len(self.records) / self.elapsed_s if self.elapsed_s else 0.0


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    return dev


class InferenceEngine:
    """Holds the loaded models of one node and runs them on one device.

    Batches are padded to ``config.batch_size``. ``preprocess="auto"``
    resolves to the CUDA kernel on a card and to plain tensor ops on the
    CPU (``config.py:EngineConfig``)."""

    def __init__(self, config: EngineConfig | None = None,
                 device: str | torch.device | None = None,
                 seed: int = 0) -> None:
        self.config = config or EngineConfig()
        if self.config.stem_s2d:
            raise NotImplementedError(
                "EngineConfig.stem_s2d: the space-to-depth stem is not "
                "ported yet; ROADMAP.md lists it")
        self.device = resolve_device(device)
        self.seed = seed
        self.dtype = getattr(torch, self.config.compute_dtype)
        mode = self.config.preprocess
        if mode == "auto":
            mode = "kernel" if self.device.type == "cuda" else "plain"
        self.preprocess = mode
        # eval mode, on the device, compute dtype, channels_last
        self._models: dict[str, nn.Module] = {}
        self._load_lock = threading.Lock()
        self.categories = imagenet_categories()

    # -- loading ----------------------------------------------------------

    def load(self, name: str,
             state_dict: dict[str, torch.Tensor] | None = None) -> None:
        """Build ``name`` once and pin it on the device. Its weights are
        ``state_dict`` (torchvision keys, e.g. carried from the JAX package
        by ``models/convert.py:state_dict_from_flax``) when given, else a
        seeded random init. Passing a state_dict for a loaded model
        replaces its weights. Thread-safe: a warmup thread and the worker
        loop may race here."""
        if name in self._models and state_dict is None:
            return
        with self._load_lock:
            if name in self._models and state_dict is None:
                return
            if self.preprocess == "fold":
                try:
                    module = create_model(name, fold_preprocess=True)
                except TypeError:
                    raise ValueError(f"preprocess='fold': model {name!r} "
                                     "does not support fold_preprocess") from None
            else:
                module = create_model(name)
            if state_dict is None:
                module.init_weights(torch.Generator().manual_seed(self.seed))
            else:
                module.load_state_dict(state_dict)
            self._models[name] = module.to(
                device=self.device, dtype=self.dtype,
                memory_format=torch.channels_last).eval()

    def weights_provenance(self, name: str) -> str:
        """The provenance marker of a loaded model; "unknown" if not loaded
        (never triggers a load just to read a string)."""
        return PROVENANCE if name in self._models else "unknown"

    def loaded_models(self) -> list[str]:
        return sorted(self._models)

    # -- one device batch -------------------------------------------------

    def _model_input(self, images_u8: torch.Tensor) -> torch.Tensor:
        """Device uint8 NHWC → the model's NCHW input for the configured
        preprocess (raw crop for ``fold``)."""
        crop = self.config.image_size
        if self.preprocess == "fold":
            x = center_crop(images_u8, crop)
        elif self.preprocess == "kernel":
            x = preprocess_batch_kernel(images_u8, crop)
        else:
            x = preprocess_batch(images_u8, crop=crop)
        return x.permute(0, 3, 1, 2)

    @torch.inference_mode()
    def logits(self, name: str, images_u8: torch.Tensor) -> torch.Tensor:
        """Device uint8 NHWC [B, H, W, 3] → f32 logits [B, classes] through
        this engine's preprocess and model; asynchronous on a card."""
        self.load(name)
        return self._models[name](self._model_input(images_u8))

    @torch.inference_mode()
    def _predict(self, name: str, batch: torch.Tensor):
        return top1_from_logits(self.logits(name, batch))

    def _to_device(self, images_u8: np.ndarray) -> torch.Tensor:
        """Host uint8 → device, through pinned memory, without waiting."""
        t = torch.from_numpy(np.ascontiguousarray(images_u8))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _pad(self, arr: np.ndarray, n: int) -> np.ndarray:
        if len(arr) == n:
            return arr
        pad = np.zeros((n - len(arr), *arr.shape[1:]), dtype=arr.dtype)
        return np.concatenate([arr, pad])

    # -- execution --------------------------------------------------------

    def infer_batch(self, name: str,
                    images_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """uint8 [N,256,256,3] → (class idx [N], prob [N]); pads to the
        engine batch size internally. Every chunk is launched before any
        result is read back."""
        self.load(name)
        n = len(images_u8)
        if n == 0:
            return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
        bs = self.config.batch_size
        pending = []
        for i in range(0, n, bs):
            chunk = images_u8[i:i + bs]
            idx, prob = self._predict(name, self._to_device(self._pad(chunk, bs)))
            pending.append((idx, prob, len(chunk)))
        return (np.concatenate([idx.cpu().numpy()[:k] for idx, _, k in pending]),
                np.concatenate([p.cpu().numpy()[:k] for _, p, k in pending]))

    # -- staged (device-resident) execution --------------------------------
    #
    # The reference stages its dataset to worker-local disk over SDFS before
    # running inference (`README.md:37-38`). The device analogue stages the
    # query range into device memory once, then serves from there: every
    # staged batch is launched back to back and only the (idx, prob) pairs
    # come back, with one synchronization at the end.

    def stage(self, images_u8: np.ndarray) -> tuple[torch.Tensor, int]:
        """Host uint8 [N,256,256,3] → device [K, B, 256, 256, 3] (padded).
        Returns (staged tensor, true N)."""
        n = len(images_u8)
        bs = self.config.batch_size
        k = -(-n // bs)
        padded = self._pad(images_u8, k * bs).reshape(
            k, bs, *images_u8.shape[1:])
        return self._to_device(padded), n

    def infer_staged(self, name: str, staged: torch.Tensor,
                     n: int) -> tuple[np.ndarray, np.ndarray]:
        """Classify a staged (device-resident) image block: one launch
        sequence per staged batch, one synchronization at the end."""
        outs = [self._predict(name, batch) for batch in staged]
        idx = torch.cat([i for i, _ in outs]).cpu().numpy()
        prob = torch.cat([p for _, p in outs]).cpu().numpy()
        return idx[:n], prob[:n]

    def _load_chunk(self, root: str | None, start: int,
                    end: int) -> tuple[list[str], np.ndarray]:
        """One device batch worth of host decode (a seam for tests to
        inject decode cost)."""
        if root and root.startswith(STORE_SCHEME):
            raise NotImplementedError(
                f"dataset {root!r}: datasets in the replicated store are not "
                "ported yet; ROADMAP.md lists them")
        return data_lib.load_range(root, start, end,
                                   size=self.config.resize_size)

    def infer(self, name: str, start: int, end: int,
              dataset_root: str | None = None) -> QueryResult:
        """Execute a query range [start, end] — the reference's
        ``deeplearning(filename, modelname, start, end)`` surface.

        The range is cut into device-batch chunks. Host decode of chunk
        i+1 runs on a prefetch thread while chunk i is in flight on the
        device (launches return at once), and at most ``max_inflight``
        staged batches are on the device before the oldest is read back:
        device compute, the pinned copy of the next chunk and host decode
        all overlap."""
        t0 = time.time()
        self.load(name)
        bs = self.config.batch_size
        bounds = [(s, min(s + bs - 1, end)) for s in range(start, end + 1, bs)]
        names: list[str] = []
        out_idx: list[np.ndarray] = []
        out_prob: list[np.ndarray] = []
        # bounded in-flight window: the device never holds more than this
        # many staged input batches, so a huge range cannot exhaust device
        # memory while the decode thread runs ahead of compute
        max_inflight = 4
        pending: deque = deque()

        def drain_one() -> None:
            di, dp, n = pending.popleft()       # .cpu() waits for the batch
            out_idx.append(di.cpu().numpy()[:n])
            out_prob.append(dp.cpu().numpy()[:n])

        if bounds:
            with ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="decode") as pool:
                fut = pool.submit(self._load_chunk, dataset_root, *bounds[0])
                for i in range(len(bounds)):
                    chunk_names, images = fut.result()
                    if i + 1 < len(bounds):      # prefetch the next chunk
                        fut = pool.submit(self._load_chunk, dataset_root,
                                          *bounds[i + 1])
                    batch = self._to_device(self._pad(images, bs))
                    idx, prob = self._predict(name, batch)
                    names.extend(chunk_names)
                    pending.append((idx, prob, len(chunk_names)))
                    if len(pending) >= max_inflight:
                        drain_one()
        while pending:
            drain_one()
        idx = np.concatenate(out_idx or [np.zeros((0,), np.int32)])
        prob = np.concatenate(out_prob or [np.zeros((0,), np.float32)])
        records = [(names[i], self.categories[int(idx[i])], float(prob[i]))
                   for i in range(len(names))]
        return QueryResult(model=name, records=records,
                           elapsed_s=time.time() - t0,
                           weights=PROVENANCE)

    def warmup(self, name: str) -> float:
        """Load and run one full batch; returns the seconds it took."""
        self.load(name)
        t0 = time.time()
        bs = self.config.batch_size
        size = self.config.resize_size
        dummy = np.zeros((bs, size, size, 3), np.uint8)
        idx, _ = self._predict(name, self._to_device(dummy))
        idx.cpu()
        return time.time() - t0
