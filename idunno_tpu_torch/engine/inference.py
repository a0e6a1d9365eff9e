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

``EngineConfig.quantize="int8"`` holds each model's weights as int8 with
f32 per-channel scales, dequantized inside the forward
(``ops/quantize.py``); ``stem_s2d`` builds ResNets with the space-to-depth
stem. ViTs attend through ``make_attn_fn("auto")``: the flash kernel K2 on
a card.

With a replicated store attached (``store=``, a node's
``FileStoreService``), weights another node published there
(``publish_weights``, under ``ckpt.pt/<model>``: ``engine/checkpoint.py``)
take precedence over the seeded init, so every node of a cluster serves
the same weights, and ``store://<name>`` dataset roots resolve against
images published into the store (``engine/data_store.py``).

Data parallelism (``mesh=``, a ``parallel/mesh.py:Mesh``), as the JAX
engine's mesh: each data group holds a replica of the weights on its
device, a batch (rounded up to a multiple of the data axis) is cut into
one contiguous slice per group, and each group runs the preprocess (K1
on a card) on its slice on its own device, then the model, then top-1;
the records come back in the input's order. Where the mesh has a model
axis, the wide layers (``parallel/sharding.py:cnn_tp_specs``) are cut
over the group's model shards and their output features gathered
(``ColumnSplit``). A mesh of one group runs the one-device code.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (the tests do), and raises when no card is present.
With neither ``device`` nor ``mesh`` the engine runs over
``local_mesh()``: one data group per visible card.
"""
from __future__ import annotations

import logging
import os
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
from idunno_tpu_torch.engine.checkpoint import (checkpoint_name, decode_state,
                                                save_variables)
from idunno_tpu_torch.engine.data_store import (STORE_SCHEME, StoreDataset,
                                                dataset_meta_name)
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.classes import imagenet_categories
from idunno_tpu_torch.models.transformer import make_attn_fn
from idunno_tpu_torch.ops.classify import top1_from_logits
from idunno_tpu_torch.ops.preprocess import center_crop, preprocess_batch
from idunno_tpu_torch.ops.preprocess_kernel import preprocess_batch_kernel
from idunno_tpu_torch.ops.quantize import quantize_tree
from idunno_tpu_torch.parallel.data import replicate
from idunno_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                            local_mesh, make_mesh)
from idunno_tpu_torch.parallel.sharding import cnn_tp_specs, split_columns

log = logging.getLogger("idunno.engine")


@dataclass
class QueryResult:
    """One executed (sub)query — the reference's return contract
    (`alexnet_resnet.py:92`) plus throughput accounting.

    ``weights`` is the provenance marker: "store" for cluster-published
    weights fetched from the replicated store, "random" for seeded weights
    (or weights carried from the JAX package, themselves seeded): random
    weights must never pass as real classifications."""

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
    """Holds the loaded models of one node and runs them over its mesh
    (module docstring): on one device when the mesh has one group.

    Batches are padded to ``config.batch_size`` rounded up to a multiple
    of the data axis. ``preprocess="auto"`` resolves to the CUDA kernel on
    a card and to plain tensor ops on the CPU (``config.py:EngineConfig``).
    ``store`` is an optional replicated file store (a node's
    ``FileStoreService``). ``mesh`` runs every data group in this process;
    ``device``, when given with it, must be its lead device."""

    def __init__(self, config: EngineConfig | None = None,
                 device: str | torch.device | None = None,
                 seed: int = 0, store=None, *, mesh: Mesh | None = None
                 ) -> None:
        self.config = config or EngineConfig()
        if mesh is None:
            dev = resolve_device(device)
            mesh = (local_mesh() if device is None
                    else make_mesh(1, 1, devices=[dev]))
        else:
            resolve_device(mesh.lead)
            if len(mesh.local_groups) != mesh.shape[DATA_AXIS]:
                raise ValueError("an engine runs every data group of its "
                                 "mesh in this process; this mesh spans "
                                 "processes")
            if device is not None and torch.device(device) != mesh.lead:
                raise ValueError(f"device {device} is not the mesh's lead "
                                 f"device {mesh.lead}")
        self.mesh = mesh
        self.n_data = mesh.shape[DATA_AXIS]
        self.n_model = mesh.shape[MODEL_AXIS]
        self.device = mesh.lead
        self.seed = seed
        # weights published into the store (by any node) take precedence
        # over the seeded init, so every node serves IDENTICAL weights
        self.store = store
        self.dtype = getattr(torch, self.config.compute_dtype)
        mode = self.config.preprocess
        if mode == "auto":
            mode = "kernel" if self.device.type == "cuda" else "plain"
        self.preprocess = mode
        # eval mode, on the device, compute dtype, channels_last; the
        # first data group's (the others' in ``_replicas``)
        self._models: dict[str, nn.Module] = {}
        self._replicas: dict[str, list[nn.Module]] = {}
        self._provenance: dict[str, str] = {}     # "store" | "random"
        self._store_datasets: dict[str, StoreDataset] = {}
        self._load_lock = threading.Lock()
        self.categories = imagenet_categories()

    # -- loading ----------------------------------------------------------

    def load(self, name: str,
             state_dict: dict[str, torch.Tensor] | None = None) -> None:
        """Build ``name`` once and pin it on the device. Its weights are
        ``state_dict`` (torchvision keys, e.g. carried from the JAX package
        by ``models/convert.py:state_dict_from_flax``) when given; else the
        store's published weights when a store is attached and holds
        usable ones (provenance "store"); else a seeded random init.
        Passing a state_dict for a loaded model replaces its weights. With
        ``quantize="int8"`` the weights are quantized once they sit on the
        device in the compute dtype. Thread-safe: a warmup thread and the
        worker loop may race here."""
        if name in self._models and state_dict is None:
            return
        with self._load_lock:
            if name in self._models and state_dict is None:
                return
            module = self._create(name)
            provenance = "random"
            if state_dict is None and self.store is not None:
                state_dict = self._try_load_from_store(name, module)
                if state_dict is not None:
                    provenance = "store"
            if state_dict is None:
                module.init_weights(torch.Generator().manual_seed(self.seed))
            else:
                module.load_state_dict(state_dict)
            module = module.to(device=self.device, dtype=self.dtype,
                               memory_format=torch.channels_last).eval()
            replicas = self._replicate(module)
            if self.config.quantize == "int8":
                replicas = [quantize_tree(m) for m in replicas]
            self._models[name] = replicas[0]
            self._replicas[name] = replicas
            self._provenance[name] = provenance

    def _replicate(self, module: nn.Module) -> list[nn.Module]:
        """``module`` (on the lead device) for each data group: the group's
        replica on its device, its wide layers cut over the group's model
        shards where the mesh has a model axis (``cnn_tp_specs``,
        ``split_columns``); ``[module]`` itself for a mesh of one
        device."""
        if self.n_data == 1 and self.n_model == 1:
            return [module]
        specs = cnn_tp_specs(module.state_dict(), n_model=self.n_model)
        return [split_columns(rep, specs, list(row)) for rep, row in
                zip(replicate(self.mesh, module), self.mesh.devices)]

    def _try_load_from_store(self, name: str,
                             module: nn.Module) -> dict | None:
        """Fetch cluster-published weights (``ckpt.pt/<name>``) from the
        replicated store; None when absent or unusable (fall through to
        the seeded init).

        A LOCAL replica is served only when a ``stat`` to the master shows
        it holds the LATEST version — re-replication after membership churn
        can leave this node with a stale copy, and serving it would break
        the identical-weights-cluster-wide invariant. When the master is
        unreachable the freshest local copy is served best-effort; a local
        copy that is stale, unreadable, or fails validation falls through
        to a master fetch. The warnings flag the same hazard: this node may
        serve different weights than the cluster."""
        cname = checkpoint_name(name)
        local = self.store.local_files().get(cname)
        latest = None
        stat_failed = False
        try:
            latest, _holders = self.store.stat(cname)
        except Exception as e:  # noqa: BLE001 - split absent vs unreachable
            not_found = ("not found" in str(e).lower()
                         or "not exist" in str(e).lower())
            if not local:
                if not_found:
                    log.debug("no store-published weights for %s", name)
                else:
                    log.warning(
                        "store stat for %s weights failed (%s); no local "
                        "replica to serve — falling back", name, e)
                return None
            stat_failed = True
            if not_found:
                log.warning(
                    "master has no record of %s weights but a local "
                    "replica exists (deleted, or failover metadata rebuild "
                    "in progress?); serving the local copy best-effort",
                    name)
            else:
                log.warning(
                    "store stat for %s weights failed (%s); serving the "
                    "local replica without knowing whether it is current",
                    name, e)
        use_version = None
        if local and (latest is None or latest in local):
            use_version = latest if latest is not None else max(local)
        if use_version is not None:
            blob = self.store.local.read(cname, use_version)
            if blob is not None:
                state = self._decode_state(name, module, blob)
                if state is not None:
                    return state
        if stat_failed:
            log.warning("local replica for %s unusable and the master has "
                        "no fetchable copy — falling back", name)
            return None
        try:
            blob, _ = self.store.get_bytes(cname)
        except Exception as e:  # noqa: BLE001 - split absent vs broken
            msg = str(e).lower()
            if "not found" in msg or "not exist" in msg:
                log.debug("no store-published weights for %s", name)
            else:
                log.warning(
                    "store fetch for %s weights failed (%s); this node "
                    "may serve different weights than the cluster",
                    name, e)
            return None
        return self._decode_state(name, module, blob)

    @staticmethod
    def _decode_state(name: str, module: nn.Module, blob: bytes
                      ) -> dict | None:
        """Decode a weights blob and validate its keys and shapes against
        ``module`` before anything is loaded, so a blob published under
        another architecture or config falls back to the seeded init
        instead of failing mid-query; None (with a warning) when unusable."""
        try:
            _, state = decode_state(blob)
            want = module.state_dict()
            if set(state) != set(want):
                missing = sorted(set(want) - set(state))[:3]
                extra = sorted(set(state) - set(want))[:3]
                raise ValueError(f"keys differ from this engine's model "
                                 f"(missing {missing}, unexpected {extra})")
            bad = [f"{k}: {tuple(state[k].shape)} != {tuple(v.shape)}"
                   for k, v in want.items() if state[k].shape != v.shape]
            if bad:
                raise ValueError("shape mismatch vs this engine's config: "
                                 + "; ".join(bad[:3]))
            return state
        except Exception as e:  # noqa: BLE001 - corrupt/mismatched blob
            log.warning("store-published weights for %s unusable (%s)",
                        name, e)
            return None

    def publish_weights(self, name: str, *, allow_random: bool = False) -> int:
        """Version this node's loaded weights for ``name`` into the store,
        so every other node serves the same parameters; returns the store
        version. Refuses seeded random weights (they would masquerade
        cluster-wide under provenance "store") unless ``allow_random``."""
        if self.store is None:
            raise ValueError("engine has no store attached")
        if self.n_model > 1:
            raise ValueError("refusing to publish from an engine whose "
                             "mesh has a model axis: its wide layers are "
                             "cut; publish from an engine without one")
        if self.config.quantize != "none":
            # a quantized engine only holds int8 weights; dequantizing them
            # would publish lossy round-tripped values as the cluster's
            # canonical full-precision checkpoint
            raise ValueError(
                f"refusing to publish from a quantize={self.config.quantize!r}"
                " engine: its weights are lossy; publish from an engine with"
                " quantize='none'")
        self.load(name)
        if self._provenance[name] == "random" and not allow_random:
            raise ValueError(
                f"refusing to publish RANDOM weights for {name!r}; load a "
                "trained checkpoint first or pass allow_random=True "
                "(test/demo clusters only)")
        return save_variables(self.store, name, self._models[name])

    def _create(self, name: str) -> nn.Module:
        """``name`` with the engine's options. As in the JAX engine, a
        family that does not take an option rejects its kwarg (a
        TypeError): ``preprocess="fold"`` then raises, ``stem_s2d`` (the
        ResNets') is left out, and so are the ViTs' ``image_size`` (the
        crop) and ``attn_fn`` (``make_attn_fn("auto")``)."""
        if self.preprocess == "fold":
            tries = [{"fold_preprocess": True}]
        elif self.config.stem_s2d:
            tries = [{"stem_s2d": True}, {}]
        else:
            tries = [{}]
        vit = {"image_size": self.config.image_size,
               "attn_fn": make_attn_fn("auto")}
        for opts in tries:
            for extra in (vit, {}):
                try:
                    return create_model(name, **opts, **extra)
                except TypeError:
                    pass
        raise ValueError(f"preprocess='fold': model {name!r} does not "
                         "support fold_preprocess")

    def weights_provenance(self, name: str) -> str:
        """"store" | "random" for a loaded model; "unknown" if not loaded
        (never triggers a load just to read a string)."""
        return self._provenance.get(name, "unknown")

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
    def logits(self, name: str, images_u8: torch.Tensor,
               group: int = 0) -> torch.Tensor:
        """Device uint8 NHWC [B, H, W, 3] → f32 logits [B, classes] through
        this engine's preprocess and data group ``group``'s replica, on
        that group's device; asynchronous on a card."""
        self.load(name)
        return self._replicas[name][group](self._model_input(images_u8))

    @torch.inference_mode()
    def _predict(self, name: str, batch: torch.Tensor, group: int = 0):
        return top1_from_logits(self.logits(name, batch, group))

    def _to_device(self, images_u8: np.ndarray,
                   device: torch.device | None = None) -> torch.Tensor:
        """Host uint8 → device, through pinned memory, without waiting."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(images_u8))
        if device.type == "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _to_groups(self, images_u8: np.ndarray) -> list[torch.Tensor]:
        """A host device batch → each data group's contiguous slice on its
        device (the whole batch on the one device of a one-group mesh)."""
        if self.n_data == 1:
            return [self._to_device(images_u8)]
        return [self._to_device(part, row[0]) for part, row in zip(
            np.array_split(images_u8, self.n_data), self.mesh.devices)]

    def _predict_groups(self, name: str, parts: list[torch.Tensor]) -> list:
        """Each group's (idx, prob) of its slice, launched group by group
        on each group's device without waiting."""
        return [self._predict(name, part, g) for g, part in enumerate(parts)]

    @staticmethod
    def _host(outs: list, n: int) -> tuple[np.ndarray, np.ndarray]:
        """The groups' (idx, prob) back on the host in row order, the
        first ``n`` rows (a read waits for each group's device)."""
        return (np.concatenate([i.cpu().numpy() for i, _ in outs])[:n],
                np.concatenate([p.cpu().numpy() for _, p in outs])[:n])

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
        bs = self._device_batch()
        pending = []
        for i in range(0, n, bs):
            chunk = images_u8[i:i + bs]
            pending.append((self._predict_groups(
                name, self._to_groups(self._pad(chunk, bs))), len(chunk)))
        out = [self._host(outs, k) for outs, k in pending]
        return (np.concatenate([i for i, _ in out]),
                np.concatenate([p for _, p in out]))

    def _device_batch(self) -> int:
        """The configured batch size rounded UP to a multiple of the data
        axis: batches must divide evenly over it."""
        return -(-self.config.batch_size // self.n_data) * self.n_data

    # -- staged (device-resident) execution --------------------------------
    #
    # The reference stages its dataset to worker-local disk over SDFS before
    # running inference (`README.md:37-38`). The device analogue stages the
    # query range into device memory once, then serves from there: every
    # staged batch is launched back to back and only the (idx, prob) pairs
    # come back, with one synchronization at the end.

    def stage(self, images_u8: np.ndarray
              ) -> tuple[list[torch.Tensor], int]:
        """Host uint8 [N,256,256,3] → one device block per data group,
        group ``g``'s ``[K, B / n_data, 256, 256, 3]`` (its slice of every
        padded batch) on its device; one group's block is the whole
        ``[K, B, 256, 256, 3]``. Returns (blocks, true N)."""
        n = len(images_u8)
        bs = self._device_batch()
        k = -(-n // bs)
        padded = self._pad(images_u8, k * bs).reshape(
            k, bs, *images_u8.shape[1:])
        per = bs // self.n_data
        return [self._to_device(padded[:, g * per:(g + 1) * per], row[0])
                for g, row in enumerate(self.mesh.devices)], n

    def infer_staged(self, name: str, staged: list[torch.Tensor],
                     n: int) -> tuple[np.ndarray, np.ndarray]:
        """Classify staged (device-resident) blocks: one launch sequence
        per staged batch and data group, then each group's results joined
        on its device and read back once (the only synchronization), the
        rows in the input's order."""
        k = len(staged[0])
        outs: list[list] = [[] for _ in staged]
        for b in range(k):
            for g, out in enumerate(self._predict_groups(
                    name, [block[b] for block in staged])):
                outs[g].append(out)

        def rows(j: int) -> np.ndarray:
            # group-major reads back to batch-major rows: batch b holds
            # every group's slice of it in group order
            per_group = [torch.cat([o[j] for o in group]).cpu().numpy()
                         for group in outs]
            return np.stack([a.reshape(k, -1) for a in per_group],
                            1).reshape(-1)[:n]

        return rows(0), rows(1)

    def _load_chunk(self, root: str | None, start: int,
                    end: int) -> tuple[list[str], np.ndarray]:
        """One device batch worth of host decode (a seam for tests to
        inject decode cost). ``root="store://<name>"`` resolves against a
        dataset published into the replicated store
        (``engine/data_store.py``) with a host-local shard cache."""
        if root and root.startswith(STORE_SCHEME):
            return self._store_dataset(root[len(STORE_SCHEME):]).load_range(
                start, end)
        return data_lib.load_range(root, start, end,
                                   size=self.config.resize_size)

    def _store_dataset(self, name: str) -> StoreDataset:
        """One cached `StoreDataset` per name, re-validated against the
        master's current meta version on every access (one metadata-only
        STAT per chunk): a re-published dataset is picked up by WARM
        engines too, never mixing versions across workers. When the master
        is unreachable the cached object serves best-effort."""
        if self.store is None:
            raise ValueError(
                f"dataset 'store://{name}' needs an engine with a store "
                "attached (this engine has none)")
        with self._load_lock:
            ds = self._store_datasets.get(name)
            if ds is not None:
                try:
                    latest, _ = self.store.stat(dataset_meta_name(name))
                except Exception:  # noqa: BLE001 - keep serving best-effort
                    latest = ds.version
                if latest != ds.version:
                    ds = None                      # re-published: rebuild
            if ds is None:
                cache = os.path.join(self.store.local.data_dir,
                                     ".dataset_cache", name)
                ds = StoreDataset(self.store, name, cache_dir=cache)
                if ds.size != self.config.resize_size:
                    raise ValueError(
                        f"dataset 'store://{name}' was published at "
                        f"{ds.size}x{ds.size} but this engine stages at "
                        f"{self.config.resize_size}x{self.config.resize_size}")
                self._store_datasets[name] = ds
            return ds

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
        bs = self._device_batch()
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
            outs, n = pending.popleft()         # .cpu() waits for the batch
            idx, prob = self._host(outs, n)
            out_idx.append(idx)
            out_prob.append(prob)

        if bounds:
            with ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="decode") as pool:
                fut = pool.submit(self._load_chunk, dataset_root, *bounds[0])
                for i in range(len(bounds)):
                    chunk_names, images = fut.result()
                    if i + 1 < len(bounds):      # prefetch the next chunk
                        fut = pool.submit(self._load_chunk, dataset_root,
                                          *bounds[i + 1])
                    parts = self._to_groups(self._pad(images, bs))
                    names.extend(chunk_names)
                    pending.append((self._predict_groups(name, parts),
                                    len(chunk_names)))
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
                           weights=self._provenance[name])

    def warmup(self, name: str) -> float:
        """Load and run one full batch; returns the seconds it took."""
        self.load(name)
        t0 = time.time()
        bs = self._device_batch()
        size = self.config.resize_size
        dummy = np.zeros((bs, size, size, 3), np.uint8)
        self._host(self._predict_groups(name, self._to_groups(dummy)), bs)
        return time.time() - t0
