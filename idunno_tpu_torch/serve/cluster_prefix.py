"""Cluster-wide prefix cache: content-addressed KV chains on the SDFS
ring.

The per-`DecodeServer` radix cache (`serve/prefix_cache.py`) dies with
its pool: behind an autoscaled group every replica re-prefills the same
system prompts, and a freshly spawned replica starts cold exactly when
the group is under SLO pressure. This subsystem publishes hot,
block-aligned prefix chains into SDFS (one `store/kv_chain.py` KVC1
blob per block, placed by the EXISTING ring — no new replication
machinery) and lets any replica's admission path extend a short local
hit with the published suffix.

Flow (all hooks live in `engine/serve_lm.py` / `serve/control.py`):

  publish — after `_finish_admission` inserts a request's chain into
      the radix tree, chains whose admission hit proves sharing
      (local hit >= ``publish_min_hits`` blocks; 0 = always) are
      pushed: blob names are the rolling chunk hash, so identical
      prefixes from any replica/pool converge on identical names and
      a duplicate publish is a version bump of identical bytes
      (the natural-idempotency story for ``prefix_publish``).
  probe — on admission, when the local radix hit is shorter than the
      block-aligned prompt, the prober derives every candidate name
      from its OWN tokens and STATs deepest-first; the first hit is
      the longest published chain sharing the prefix. No directory.
  fetch — `get_bytes` ONLY the missing depths (local_blocks..found),
      verify each blob's embedded chunk tokens, and graft into the
      radix tree (`RadixPrefixCache.graft`); the admission then
      prefills just the remainder — token-exact because grafted KV
      sits at the same absolute positions causal attention demands.
  warm — `lm_manager.group_spawn` sends ``prefix_fetch`` with a
      tenant; the per-tenant warm index (an SDFS JSON blob) maps the
      tenant to its published prefixes so a new replica's first
      request prefills only the suffix.

Staleness: eviction is `store.delete` (an SDFS tombstone); a republish
bumps the version PAST the tombstone (`store/sdfs.py:_master_put`), and
internal ring PUTs refuse zombie versions — so a fetched blob is always
the newest published content or a typed miss, never a resurrected old
chain. On top of that, `decode_block(expect_tokens=...)` refuses any
blob whose embedded chunk differs from the prober's prefix.

Failure policy: probe/fetch/publish NEVER fail serving — every store
or transport error degrades to a miss/skip and bumps ``errors``.

Determinism: no clocks, no rng; the only state is bounded memo dicts.

A port of ``idunno_tpu/serve/cluster_prefix.py``: ``ClusterPrefixCache``
is the JAX package's; ``pool_namespace`` fingerprints the port's module
(its weights live in the module, so there is no ``params`` argument) and
takes its config part from the architecture `save_lm` stores
(``engine/generate.py:lm_config``).
"""
from __future__ import annotations

import json
from typing import Any, Callable

import torch

from idunno_tpu_torch.comm.transport import TransportError
from idunno_tpu_torch.store.kv_chain import (chain_names, decode_block,
                                       encode_block, namespace_key,
                                       tenant_index_name)
from idunno_tpu_torch.store.sdfs import StoreError

# per-tenant warm index caps: entries per tenant, chain depth per entry
_INDEX_ENTRIES = 32
_NOTE_CAP = 256

_MISS = (StoreError, TransportError, OSError, ValueError, KeyError)


def pool_namespace(model, prefix_tokens, quantize: str | None,
                   block_size: int, extra: str | None = None) -> str:
    """Namespace id folding in everything that affects KV content: two
    pools share chains ONLY when their model config, a weights
    fingerprint (the first 64 values, as f32, of the first four
    ``state_dict()`` tensors, and the tensor count — cheap, order-
    stable), static pool prefix, quantize mode and block_size all agree.
    The config is the architecture `save_lm` stores (KV cache dtype and
    compute dtype included), never ``vars(model)``, which on a module
    holds its training flag and private dicts."""
    from idunno_tpu_torch.engine.generate import lm_config

    fp = []
    tensors = list(model.state_dict().values())
    for t in tensors[:4]:
        flat = t.detach().reshape(-1)[:64].to("cpu", torch.float32)
        fp.append(flat.numpy().tobytes().hex())
    return namespace_key({
        "config": lm_config(model), "params_fp": fp,
        "n_leaves": len(tensors),
        "prefix": [int(t) for t in (prefix_tokens or ())],
        "quantize": quantize or "", "block_size": int(block_size),
        "extra": extra or ""})


class ClusterPrefixCache:
    """Publish/probe/fetch client for ONE pool (one namespace), bound
    to the node's `FileStoreService`. Thread-safety matches its owner:
    all calls arrive on the pool's serving-loop thread
    (`serve/lm_pool.py` marshals the control verbs there)."""

    def __init__(self, store, namespace: str, block_size: int,
                 publish_min_hits: int = 1) -> None:
        self.store = store
        self.namespace = namespace
        self.block_size = int(block_size)
        # publish only chains whose admission hit had >= this many local
        # blocks (the prompt PROVED it is shared); 0 publishes every
        # inserted chain (the warm path and tests use 0)
        self.publish_min_hits = int(publish_min_hits)
        # names this pool already confirmed published (memo: skip the
        # stat/put); bounded by insertion order
        self._published: dict[str, bool] = {}
        # head-chunk key -> tenant, so a publish triggered deep in the
        # admission path can attribute the chain to the submitting
        # tenant (serve/lm_pool.py notes it at submit time)
        self._tenant_notes: dict[tuple[int, ...], str] = {}
        # counters surfaced as lm_stats gauges (engine/serve_lm.py
        # prefix_cache_stats); warmup() resets via reset_counters()
        self.remote_hits = 0
        self.published_chains = 0
        self.published_blocks = 0
        self.warm_blocks = 0
        self.fetch_bytes = 0
        self.errors = 0

    def reset_counters(self) -> None:
        self.remote_hits = 0
        self.published_chains = 0
        self.published_blocks = 0
        self.warm_blocks = 0
        self.fetch_bytes = 0
        self.errors = 0

    # -- naming ------------------------------------------------------------

    def names(self, tokens: list[int]) -> list[str]:
        return chain_names(self.namespace, tokens, self.block_size)

    def _chunk(self, tokens: list[int], j: int) -> list[int]:
        bs = self.block_size
        return [int(t) for t in tokens[j * bs:(j + 1) * bs]]

    # -- probe -------------------------------------------------------------

    def probe(self, tokens: list[int], start_depth: int = 0) -> int:
        """Deepest published depth (in blocks) for this prefix, probing
        deepest-first via ring `stat` and stopping at the first hit; 0
        when nothing deeper than ``start_depth`` is published. Pure
        read — mutates nothing anywhere."""
        names = self.names(tokens)
        for depth in range(len(names), start_depth, -1):
            name = names[depth - 1]
            try:
                if name in self._published:
                    return depth
                self.store.stat(name)
            except StoreError:
                continue
            except _MISS:
                self.errors += 1
                return 0
            self._memo(name)
            return depth
        return 0

    # -- fetch -------------------------------------------------------------

    def fetch(self, tokens: list[int], from_depth: int, to_depth: int,
              ) -> list[tuple[list[int], dict[str, Any]]]:
        """Blobs for depths [from_depth, to_depth), shallowest first,
        each verified against the expected chunk tokens. Stops at the
        first failure — a chain is only usable as a CONTIGUOUS prefix,
        so a gap ends the fetch (the caller grafts what arrived)."""
        names = self.names(tokens)
        out = []
        for depth in range(from_depth, min(to_depth, len(names))):
            chunk = self._chunk(tokens, depth)
            try:
                blob, _version = self.store.get_bytes(names[depth])
                _meta, arrays = decode_block(blob, expect_tokens=chunk)
            except StoreError:
                break
            except _MISS:
                self.errors += 1
                break
            self.fetch_bytes += len(blob)
            self._memo(names[depth])
            out.append((chunk, arrays))
        return out

    # -- publish -----------------------------------------------------------

    def publish(self, tokens: list[int], n_blocks: int,
                read_block: Callable[[int], dict[str, Any]],
                tenant: str | None = None,
                force: bool = False) -> dict[str, int]:
        """Publish the first ``n_blocks`` full chunks of ``tokens``:
        for each depth whose content-addressed name is not already on
        the ring, encode the pool block (``read_block(j)`` returns the
        raw leaf arrays) and PUT it. Returns {published, blocks}.
        Content addressing via ``chain_names`` is what makes a replayed
        publish converge: same prefix, same names, same bytes.
        ``force`` skips the local published-memo (NOT the ring stat):
        the explicit `prefix_publish` verb uses it so a republish after
        ANOTHER pool's eviction — which this pool's memo cannot see —
        still lands."""
        names = self.names(tokens)[:n_blocks]
        wrote = 0
        for j, name in enumerate(names):
            if not force and name in self._published:
                continue
            try:
                self.store.stat(name)
                self._memo(name)
                continue
            except StoreError:
                pass                            # not published yet
            except _MISS:
                self.errors += 1
                break
            chunk = self._chunk(tokens, j)
            meta = {"tokens": chunk, "depth": j,
                    "namespace": self.namespace,
                    "block_size": self.block_size}
            try:
                blob = encode_block(meta, read_block(j))
                self.store.put_bytes(name, blob)
            except _MISS:
                self.errors += 1
                break
            self._memo(name)
            wrote += 1
        if wrote:
            self.published_chains += 1
            self.published_blocks += wrote
            ten = tenant or self._tenant_notes.get(
                tuple(tokens[:self.block_size]))
            if ten is not None:
                self._index_add(ten, tokens, len(names))
        return {"published": wrote, "blocks": len(names)}

    # -- eviction ----------------------------------------------------------

    def evict(self, tokens: list[int], from_depth: int = 0) -> int:
        """Tombstone every published blob of this chain at depth >=
        ``from_depth``. SDFS versioning makes this safe against
        republish races: a later publish bumps the version past the
        tombstone, and ring-internal PUTs refuse zombie versions — a
        reader never sees the evicted content again."""
        dropped = 0
        for name in self.names(tokens)[from_depth:]:
            try:
                self.store.delete(name)
                dropped += 1
            except _MISS:
                self.errors += 1
            self._published.pop(name, None)
        return dropped

    # -- tenant warm index -------------------------------------------------

    def note(self, tokens: list[int], tenant: str) -> None:
        """Remember which tenant submitted this prompt head, so the
        publish deep in the admission path can attribute the chain.
        Bounded FIFO."""
        if len(tokens) < self.block_size:
            return
        key = tuple(int(t) for t in tokens[:self.block_size])
        self._tenant_notes.pop(key, None)
        self._tenant_notes[key] = str(tenant)
        while len(self._tenant_notes) > _NOTE_CAP:
            self._tenant_notes.pop(next(iter(self._tenant_notes)))

    def _index_add(self, tenant: str, tokens: list[int],
                   depth: int) -> None:
        """Merge (tokens[:depth*bs], depth) into the tenant's warm
        index blob — read-modify-write keeping the LONGEST chain per
        distinct head and at most ``_INDEX_ENTRIES`` entries (newest
        kept)."""
        head = [int(t) for t in tokens[:depth * self.block_size]]
        entries = self.tenant_entries(tenant)
        kept = []
        for e in entries:
            et = e.get("tokens", [])
            if (et[:len(head)] == head or head[:len(et)] == et):
                if len(et) >= len(head):
                    return              # an equal-or-longer chain exists
                continue                # superseded by the new entry
            kept.append(e)
        kept.append({"tokens": head, "depth": int(depth)})
        kept = kept[-_INDEX_ENTRIES:]
        try:
            self.store.put_bytes(
                tenant_index_name(self.namespace, tenant),
                json.dumps({"entries": kept}, sort_keys=True).encode())
        except _MISS:
            self.errors += 1

    def tenant_entries(self, tenant: str) -> list[dict[str, Any]]:
        try:
            blob, _ = self.store.get_bytes(
                tenant_index_name(self.namespace, tenant))
            return list(json.loads(blob.decode()).get("entries", []))
        except _MISS:
            return []

    # -- internals ---------------------------------------------------------

    def _memo(self, name: str) -> None:
        self._published.pop(name, None)
        self._published[name] = True
        while len(self._published) > 4 * _NOTE_CAP:
            self._published.pop(next(iter(self._published)))

    def stats(self) -> dict[str, int]:
        return {"prefix_remote_hits": self.remote_hits,
                "prefix_published_chains": self.published_chains,
                "prefix_published_blocks": self.published_blocks,
                "prefix_warm_blocks": self.warm_blocks,
                "prefix_fetch_bytes": self.fetch_bytes,
                "prefix_store_errors": self.errors}
