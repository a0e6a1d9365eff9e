"""Cross-request radix prefix cache (SGLang RadixAttention-style,
PAPERS.md) over a `KVBlockPool` (`engine/kv_blocks.py`).

A radix tree keyed by block_size-token chunks of the PER-REQUEST prompt
(the pool-level static ``prefix=`` is shared by construction and sits in
front of every chain at fixed absolute positions). Each node owns one
block of the pool — the KV for its chunk's token positions — so a
root-to-node path is a ready-to-splice block chain for that token
prefix. Admission (`DecodeServer._admit`) looks up the longest cached
chain, gathers it, and prefills only the remaining suffix; after the
prefill it inserts the request's own full blocks so the NEXT request
sharing the prompt head hits them.

Lifecycle:
  - lookup/insert stamp every touched node with a monotonic LRU clock.
  - A request acquires (increfs) its whole chain at admission and
    releases it at retirement/cancel — pinned chains can never be
    evicted mid-flight.
  - Allocation under pool pressure evicts the LRU refcount-0 LEAF,
    repeatedly; a held node is never a candidate, and an inner node is
    only freed after its subtree (children pin their chain prefix by
    structure, not by refcount).
  - When eviction cannot free a block (every block pinned by live
    requests), insertion is skipped — serving NEVER blocks or fails on
    cache pressure; the request just doesn't seed the tree
    (``insert_skips`` counts these).

The reference recomputes every query from scratch
(`mp4_machinelearning.py:541-616`); there is no counterpart subsystem.
"""
from __future__ import annotations

from typing import Any

from idunno_tpu_torch.engine.kv_blocks import KVBlockPool


class _Node:
    __slots__ = ("chunk", "block", "children", "parent", "stamp")

    def __init__(self, chunk: tuple[int, ...], block: int,
                 parent: "_Node | None", stamp: int) -> None:
        self.chunk = chunk
        self.block = block
        self.children: dict[tuple[int, ...], _Node] = {}
        self.parent = parent
        self.stamp = stamp


class RadixPrefixCache:
    def __init__(self, pool: KVBlockPool) -> None:
        self.pool = pool
        self.block_size = pool.block_size
        self._root = _Node((), -1, None, 0)
        self._clock = 0
        self.evictions = 0
        self.insert_skips = 0
        self.inserted_blocks = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens: list[int]):
        bs = self.block_size
        for j in range(len(tokens) // bs):
            yield tuple(tokens[j * bs:(j + 1) * bs])

    # -- query ------------------------------------------------------------

    def lookup(self, tokens: list[int]) -> list[_Node]:
        """Longest cached chain for ``tokens`` (block-aligned: only full
        block_size chunks can match). Touches the chain's LRU stamps."""
        stamp = self._tick()
        node, chain = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.stamp = stamp
            chain.append(child)
            node = child
        return chain

    def acquire(self, chain: list[_Node]) -> None:
        for nd in chain:
            self.pool.incref(nd.block)

    def release(self, chain: list[_Node]) -> None:
        for nd in chain:
            self.pool.decref(nd.block)

    # -- growth -----------------------------------------------------------

    def insert(self, tokens: list[int], row_cache: Any,
               pos_offset: int) -> list[_Node]:
        """Ensure a chain exists for every FULL block of ``tokens``,
        writing newly created nodes' KV from ``row_cache`` (token i of
        ``tokens`` lives at cache position ``pos_offset + i`` — the
        pool-level static prefix length at the serving tier). Existing
        nodes are reused untouched: the causal model makes their stored
        KV bit-identical to what this request's prefill just computed at
        the same positions. Best-effort — returns the chain built so
        far (possibly short) when the pool is exhausted even after
        eviction.

        The returned chain comes back ACQUIRED (each node increffed as
        the walk pins it — so the insert's own eviction loop can never
        free a node of the chain being built); the caller owns exactly
        one reference per node and must `release` it at retirement."""
        stamp = self._tick()
        node, chain = self._root, []
        for j, chunk in enumerate(self._chunks(tokens)):
            child = node.children.get(chunk)
            if child is None:
                bid = self._alloc_block()
                if bid is None:
                    self.insert_skips += 1
                    break
                self.pool.write_block(bid, row_cache,
                                      pos_offset + j * self.block_size)
                child = _Node(chunk, bid, node, stamp)
                node.children[chunk] = child
                self.inserted_blocks += 1
            child.stamp = stamp
            self.pool.incref(child.block)
            chain.append(child)
            node = child
        return chain

    def graft(self, tokens: list[int],
              fetched: list[tuple[list[int], Any]],
              start_depth: int) -> int:
        """Splice cluster-fetched raw blocks (`serve/cluster_prefix.py`)
        into the tree: ``fetched`` holds (chunk, leaf arrays) pairs for
        consecutive depths starting at ``start_depth`` of ``tokens``.
        Chunks already present are REUSED, not reallocated — grafting is
        naturally idempotent, a duplicated fetch converges on the same
        tree (the `prefix_fetch` contract anchor). Best-effort like
        `insert`: stops when the pool is exhausted even after eviction.
        Returns the number of NEW blocks written; nothing is acquired —
        the caller re-runs `lookup` to pin the extended chain."""
        stamp = self._tick()
        node = self._root
        chunks = list(self._chunks(tokens))
        # pin the whole walked path (like `insert`): the alloc loop's
        # eviction must never free a node of the chain being extended
        pinned: list[_Node] = []
        try:
            for j in range(start_depth):
                node = node.children.get(chunks[j])
                if node is None:
                    raise ValueError(
                        f"graft start_depth {start_depth} deeper than "
                        f"the local chain (missing chunk {j})")
                self.pool.incref(node.block)
                pinned.append(node)
            wrote = 0
            for i, (chunk, arrays) in enumerate(fetched):
                chunk = tuple(int(t) for t in chunk)
                if chunk != chunks[start_depth + i]:
                    raise ValueError("graft chunk does not match the "
                                     "prompt prefix at its depth")
                child = node.children.get(chunk)
                if child is None:
                    bid = self._alloc_block()
                    if bid is None:
                        self.insert_skips += 1
                        break
                    self.pool.write_raw_block(bid, arrays)
                    child = _Node(chunk, bid, node, stamp)
                    node.children[chunk] = child
                    self.inserted_blocks += 1
                    wrote += 1
                child.stamp = stamp
                self.pool.incref(child.block)
                pinned.append(child)
                node = child
            return wrote
        finally:
            for nd in pinned:
                self.pool.decref(nd.block)

    def _alloc_block(self) -> int | None:
        while True:
            bid = self.pool.alloc()
            if bid is not None:
                return bid
            if not self._evict_one():
                return None

    def _evict_one(self) -> bool:
        """Free the least-recently-used refcount-0 LEAF node's block.
        False when no node is evictable (every leaf pinned)."""
        best = None
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
                continue
            if self.pool.refcount(nd.block) == 0 and (
                    best is None or nd.stamp < best.stamp):
                best = nd
        if best is None:
            return False
        del best.parent.children[best.chunk]
        self.pool.free(best.block)
        self.evictions += 1
        return True

    # -- introspection ----------------------------------------------------

    def num_nodes(self) -> int:
        n, stack = 0, list(self._root.children.values())
        while stack:
            nd = stack.pop()
            n += 1
            stack.extend(nd.children.values())
        return n
