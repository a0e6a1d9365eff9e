"""Paged KV-cache block pool (vLLM PagedAttention-style).

A port of ``idunno_tpu/engine/kv_blocks.py``. The decode-cache leaves
(``cached_k``/``cached_v``, plus ``k_scale``/``v_scale`` on int8 caches)
are contiguous per sequence; this pool adds fixed-size TOKEN BLOCKS over
the same leaves. Each block holds ``block_size`` consecutive token
positions of every K/V leaf of every layer; a prompt's KV is then a
CHAIN of blocks that other requests with the same token prefix (at the
same absolute positions) can reuse. Ownership/eviction policy lives one
level up in ``serve/prefix_cache.py`` (the radix tree); this pool only
does storage:

  alloc/free     — free-list, O(1), no compaction (blocks are uniform)
  incref/decref  — per-block reference counts: a block is pinned while
                   any admitted request's chain holds it
  write_block    — copy one block's worth of a prefill row cache's K/V
                   into a block, in place on the device
  gather         — assemble a chain back into a batch-1, length-n·bs
                   cache (the gathered, non-paged hit path)
  kv_pages       — the stores themselves, ``[L, N, bs, ...]``, which the
                   paged decode path reads through the block table

The stores are depth-stacked ``[L, N, bs, KVH, D]`` (scales
``[L, N, bs, KVH]``), so ``store[l]`` is directly the page array of layer
``l``. Correctness note: the transformer is causal, so a token's K/V
depends only on the tokens at and before its position — KV written by
ONE request is identical to what any other request with the same token
prefix would compute at those positions.

Under tensor parallelism (``mesh=``, a ``parallel/mesh.py:Mesh``) each
model shard ``m`` keeps its own stores on its device: head-sharded (its
``KVH/n`` KV heads) when the KV heads divide the model axis, whole
(replicated) otherwise, as the JAX package shards its stores; a device
that serves shard ``m`` for several data groups keeps one copy. Row
caches, gathers and page stores are then the sharded decoder's
(`models/transformer.py:ShardedCache`), but a block read or written raw
(`read_block`, `write_raw_block`) is always the whole block in the
unsharded layout: published and exported blocks are content-equal
whatever the publisher's ``n_model``, so the cluster prefix cache and the
KV handoff work between pools of different ``n_model``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from idunno_tpu_torch.models.transformer import KV_LEAF_KEYS, ShardedCache


def concat_kv_prefix(front, back):
    """Concatenate two batch-1 caches along the token axis at the K/V
    leaves (static pool prefix + gathered radix chain → one combined
    prefix). The port's caches are depth-stacked ``[L, 1, T, ...]``, so
    the token axis is 2. Sharded caches concatenate shard by shard, on
    ``front``'s devices."""
    if isinstance(front, ShardedCache):
        return ShardedCache([[concat_kv_prefix(f, b) for f, b in zip(fr, br)]
                             for fr, br in zip(front.parts, back.parts)])
    return {name: torch.cat([leaf, back[name].to(leaf.device)], dim=2)
            for name, leaf in front.items() if name in KV_LEAF_KEYS}


class KVBlockPool:
    """Fixed-size token-block storage over a model's decode-cache K/V
    leaves, with free-list allocation and per-block refcounts. Policy-
    free: see `serve/prefix_cache.py` for the radix tree that decides
    what the blocks mean and when they are evicted."""

    def __init__(self, model, num_blocks: int, block_size: int,
                 mesh=None, device: torch.device | str | None = None) -> None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks {num_blocks} must be >= 1")
        if block_size < 1:
            raise ValueError(f"block_size {block_size} must be >= 1")
        from idunno_tpu_torch.engine.generate import init_cache

        self.model = model
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.mesh = mesh
        self._shards: dict | None = None
        if mesh is None:
            template = init_cache(model, 1, 1, device=device)
        else:
            from idunno_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            n_model = mesh.shape[MODEL_AXIS]
            # the KV-head split of the decode cache: shard when the KV
            # heads divide the model axis, replicate otherwise
            self._head_shard = n_model > 1 and model.kv_heads % n_model == 0
            template = init_cache(model, 1, 1, device="cpu")
        self._stores: dict[str, torch.Tensor] = {}
        # the whole (unsharded) per-block shape and dtype of each leaf
        self._block_shapes = {}
        for name, leaf in template.items():
            # [L, 1, 1, ...] → [L, N, bs, ...]
            shape = (leaf.shape[0], num_blocks, block_size) + tuple(leaf.shape[3:])
            self._block_shapes[name] = ((shape[0],) + shape[2:], leaf.dtype)
            if mesh is None:
                self._stores[name] = torch.zeros(shape, dtype=leaf.dtype,
                                                 device=leaf.device)
        if mesh is not None:
            # one store set per (device, model shard): the KV-head axis
            # (3 of [L, N, bs, KVH, ...]) cut where the heads shard
            self._shards = {}
            for row in mesh.devices:
                for m, dev in enumerate(row):
                    if (dev, m) in self._shards:
                        continue
                    stores = {}
                    for name, leaf in template.items():
                        tail = list(leaf.shape[3:])
                        if self._head_shard:
                            tail[0] //= n_model
                        shape = (leaf.shape[0], num_blocks,
                                 block_size) + tuple(tail)
                        stores[name] = torch.zeros(shape, dtype=leaf.dtype,
                                                   device=dev)
                    self._shards[dev, m] = stores
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._refs: dict[int, int] = {}       # allocated block → refcount

    # -- allocation -------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> int | None:
        """One free block (refcount 0) or None when the pool is full —
        the caller decides whether to evict or skip."""
        if not self._free:
            return None
        bid = self._free.pop()
        self._refs[bid] = 0
        return bid

    def free(self, bid: int) -> None:
        refs = self._refs.get(bid)
        if refs is None:
            raise ValueError(f"block {bid} is not allocated")
        if refs:
            # refused free must leave the block tracked (still allocated)
            raise ValueError(f"block {bid} freed with refcount {refs}")
        del self._refs[bid]
        self._free.append(bid)

    def incref(self, bid: int) -> None:
        self._refs[bid] += 1

    def decref(self, bid: int) -> None:
        if self._refs[bid] < 1:
            raise ValueError(f"block {bid} decref below zero")
        self._refs[bid] -= 1

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    # -- data movement ----------------------------------------------------

    def write_block(self, bid: int, row_cache: dict, offset: int) -> None:
        """Copy token positions [offset, offset+block_size) of a batch-1
        prefill cache's K/V leaves (``[L, 1, T, ...]``) into block
        ``bid``, in place. The offset is an ABSOLUTE cache position; a
        window outside the row cache raises (a clamped copy would
        duplicate tokens into the wrong block and poison later hits)."""
        parts = (row_cache.parts[0] if isinstance(row_cache, ShardedCache)
                 else None)
        row_len = next(iter((parts[0] if parts else row_cache)
                            .values())).shape[2]
        if offset < 0 or offset + self.block_size > row_len:
            raise ValueError(
                f"write_block offset {offset} + block_size "
                f"{self.block_size} outside row cache of {row_len} "
                f"tokens (offset is an ABSOLUTE cache position — did the "
                f"caller forget/double-count the static prefix length?)")
        if self._shards is not None:
            # every store set of shard m takes row part m (a device that
            # holds shard m for another data group copies across)
            for (_, m), stores in self._shards.items():
                for name, store in stores.items():
                    store[:, bid].copy_(
                        parts[m][name][:, 0, offset:offset + self.block_size])
            return
        for name, store in self._stores.items():
            chunk = row_cache[name][:, 0, offset:offset + self.block_size]
            store[:, bid].copy_(chunk)

    def read_block(self, bid: int) -> dict[str, torch.Tensor]:
        """One block's raw per-leaf content as CPU tensors (``[L, bs,
        ...]``) in the store's own dtype (bf16 included: numpy has no
        bf16), keyed by leaf name — the payload of a cluster prefix-cache
        publish and of a KV handoff export (`store/kv_chain.py`)."""
        if bid not in self._refs:
            raise ValueError(f"block {bid} is not allocated")
        if self._shards is not None:
            # the whole block: data group 0's shards, KV heads joined
            row = self.mesh.devices[0]
            sets = [self._shards[dev, m] for m, dev in enumerate(row)]
            if not self._head_shard:
                sets = sets[:1]
            return {name: torch.cat([s[name][:, bid].to("cpu") for s in sets],
                                    dim=2)
                    for name in self._block_shapes}
        return {name: store[:, bid].to("cpu", copy=True)
                for name, store in self._stores.items()}

    def write_raw_block(self, bid: int, arrays: dict[str, Any]) -> None:
        """Inverse of `read_block`: install raw slivers (torch tensors or
        numpy arrays) into block ``bid``. Every store leaf must be present
        with its exact per-block shape and the store's dtype (a cast would
        change the KV a hit attends) — a partial, mis-shaped or mistyped
        payload raises before any store is touched."""
        if bid not in self._refs:
            raise ValueError(f"block {bid} is not allocated")
        staged = {}
        for name, (want, dtype) in self._block_shapes.items():
            arr = arrays.get(name)
            if arr is None:
                raise ValueError(f"write_raw_block missing leaf {name!r}")
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"write_raw_block leaf {name!r} shape {tuple(arr.shape)}"
                    f" != store block shape {tuple(want)}")
            t = (arr if isinstance(arr, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(arr)))
            if t.dtype != dtype:
                raise ValueError(
                    f"write_raw_block leaf {name!r} dtype {t.dtype} != "
                    f"store dtype {dtype}")
            staged[name] = t
        if self._shards is not None:
            for (dev, m), stores in self._shards.items():
                for name, store in stores.items():
                    src = staged[name]
                    if self._head_shard:
                        n = store.shape[3]
                        src = src.narrow(2, m * n, n)
                    store[:, bid].copy_(src.to(dev))
            return
        for name, store in self._stores.items():
            store[:, bid].copy_(staged[name].to(store.device))

    def kv_pages(self) -> dict[str, torch.Tensor]:
        """The page stores by leaf name, each ``[L, N, bs, ...]`` — the
        arrays the paged decode path (`ops/paged_attention.py`) reads
        THROUGH the block table instead of gathering. A sharded pool gives
        each leaf as ``{(device, shard): store}``, which
        `models/transformer.py:ShardedLM` reads shard by shard."""
        if self._shards is not None:
            return {name: {key: stores[name]
                           for key, stores in self._shards.items()}
                    for name in self._block_shapes}
        return dict(self._stores)

    @property
    def bytes_per_block(self) -> int:
        """Bytes one whole (unsharded) block occupies across every K/V
        leaf store."""
        return sum(int(np.prod(shape)) * torch.empty((), dtype=dt)
                   .element_size()
                   for shape, dt in self._block_shapes.values())

    def gather(self, blocks: list[int], group: int = 0):
        """Chain → a batch-1, length-``len(blocks)·block_size`` cache
        (``[L, 1, n·bs, ...]`` per leaf) for the gathered prefix splice; a
        sharded pool gives a `ShardedCache` on data group ``group``'s
        devices."""
        n = len(blocks)
        if n < 1:
            raise ValueError("empty block chain")
        if self._shards is not None:
            row = self.mesh.devices[group]
            return ShardedCache([[self._gather(self._shards[dev, m], blocks)
                                  for m, dev in enumerate(row)]])
        return self._gather(self._stores, blocks)

    def _gather(self, stores: dict, blocks: list[int]) -> dict:
        n = len(blocks)
        idx = torch.as_tensor(blocks, dtype=torch.int64,
                              device=next(iter(stores.values())).device)
        out = {}
        for name, store in stores.items():
            picked = store.index_select(1, idx)          # [L, n, bs, ...]
            out[name] = picked.reshape(
                (store.shape[0], 1, n * self.block_size) + tuple(store.shape[3:]))
        return out
