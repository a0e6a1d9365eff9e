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
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from idunno_tpu_torch.models.transformer import KV_LEAF_KEYS


def concat_kv_prefix(front: dict, back: dict) -> dict:
    """Concatenate two batch-1 caches along the token axis at the K/V
    leaves (static pool prefix + gathered radix chain → one combined
    prefix). The port's caches are depth-stacked ``[L, 1, T, ...]``, so
    the token axis is 2."""
    return {name: torch.cat([leaf, back[name]], dim=2)
            for name, leaf in front.items() if name in KV_LEAF_KEYS}


class KVBlockPool:
    """Fixed-size token-block storage over a model's decode-cache K/V
    leaves, with free-list allocation and per-block refcounts. Policy-
    free: see `serve/prefix_cache.py` for the radix tree that decides
    what the blocks mean and when they are evicted."""

    def __init__(self, model, num_blocks: int, block_size: int,
                 mesh=None, device: torch.device | str | None = None) -> None:
        if mesh is not None:
            raise ValueError("a sharded block pool (mesh=) comes with the "
                             "parallelism slice (ROADMAP.md, modules "
                             "item 10)")
        if num_blocks < 1:
            raise ValueError(f"num_blocks {num_blocks} must be >= 1")
        if block_size < 1:
            raise ValueError(f"block_size {block_size} must be >= 1")
        from idunno_tpu_torch.engine.generate import init_cache

        self.model = model
        self.num_blocks = num_blocks
        self.block_size = block_size
        template = init_cache(model, 1, 1, device=device)
        self._stores: dict[str, torch.Tensor] = {}
        for name, leaf in template.items():
            # [L, 1, 1, ...] → [L, N, bs, ...]
            shape = (leaf.shape[0], num_blocks, block_size) + tuple(leaf.shape[3:])
            self._stores[name] = torch.zeros(shape, dtype=leaf.dtype,
                                             device=leaf.device)
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
        row_len = next(iter(row_cache.values())).shape[2]
        if offset < 0 or offset + self.block_size > row_len:
            raise ValueError(
                f"write_block offset {offset} + block_size "
                f"{self.block_size} outside row cache of {row_len} "
                f"tokens (offset is an ABSOLUTE cache position — did the "
                f"caller forget/double-count the static prefix length?)")
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
        for name, store in self._stores.items():
            arr = arrays.get(name)
            want = store.shape[:1] + store.shape[2:]
            if arr is None:
                raise ValueError(f"write_raw_block missing leaf {name!r}")
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"write_raw_block leaf {name!r} shape {tuple(arr.shape)}"
                    f" != store block shape {tuple(want)}")
            t = (arr if isinstance(arr, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(arr)))
            if t.dtype != store.dtype:
                raise ValueError(
                    f"write_raw_block leaf {name!r} dtype {t.dtype} != "
                    f"store dtype {store.dtype}")
            staged[name] = t.to(store.device)
        for name, store in self._stores.items():
            store[:, bid].copy_(staged[name])

    def kv_pages(self) -> dict[str, torch.Tensor]:
        """The page stores by leaf name, each ``[L, N, bs, ...]`` — the
        arrays the paged decode path (`ops/paged_attention.py`) reads
        THROUGH the block table instead of gathering."""
        return dict(self._stores)

    @property
    def bytes_per_block(self) -> int:
        """Bytes one block occupies across every K/V leaf store."""
        return sum(s.numel() // self.num_blocks * s.element_size()
                   for s in self._stores.values())

    def gather(self, blocks: list[int]) -> dict:
        """Chain → a batch-1, length-``len(blocks)·block_size`` cache
        (``[L, 1, n·bs, ...]`` per leaf) for the gathered prefix splice."""
        n = len(blocks)
        if n < 1:
            raise ValueError("empty block chain")
        idx = torch.as_tensor(blocks, dtype=torch.int64,
                              device=next(iter(self._stores.values())).device)
        out = {}
        for name, store in self._stores.items():
            picked = store.index_select(1, idx)          # [L, n, bs, ...]
            out[name] = picked.reshape(
                (store.shape[0], 1, n * self.block_size) + tuple(store.shape[3:]))
        return out
