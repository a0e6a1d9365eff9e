"""Content-addressed KV chain-blob codec for the cluster prefix cache.

A published prefix chain is one SDFS blob PER BLOCK, named by a rolling
hash over the block_size-token chunks:

    h_0 = sha256(namespace)
    h_j = sha256(h_{j-1} || chunk_j tokens as int64 bytes)
    name_j = "kvb/{namespace_prefix}/{h_j}"

so the name of depth j commits to the ENTIRE token prefix up to and
including chunk j (plus everything the namespace folds in — model
identity, params fingerprint, static pool prefix, quantize mode,
block_size). Two consequences the subsystem is built on:

  - Dedupe is structural: identical prefixes hash to identical names,
    so replicas and pools publishing the same system prompt converge on
    the same blobs (and a duplicate publish is a version bump of
    identical bytes — the natural-idempotency anchor for
    ``prefix_publish`` in ``analysis/contracts.py``).
  - Probing needs no directory: a prober derives every candidate name
    from its OWN prompt tokens and STATs deepest-first; the first hit
    is the longest published chain sharing its prefix.

Blob layout (magic ``KVC1``): 4-byte magic, uint32 little-endian header
length, JSON header ``{"meta": {...}, "leaves": {keystr: {"dtype",
"shape", "offset", "nbytes"}}}``, then the leaves' raw buffers
concatenated. ``meta`` EMBEDS the chunk tokens — `decode_block`
verification against the expected chunk is the correctness guard that
makes stale content and (astronomically unlikely) hash collisions a
refused fetch instead of a wrong token.

Pure library: no transport, no clocks, no rng (determinism-clean for
the chaos surface).

A port of ``idunno_tpu/store/kv_chain.py``: the names, hashes and blob
layout are the JAX package's, byte for byte, so the two packages write
identical blobs for identical leaves. ``encode_block`` takes torch tensors
or numpy arrays; ``decode_block`` returns CPU torch tensors. bf16 leaves
travel as their raw little-endian 16-bit words under the dtype name
``"bfloat16"`` (the name the JAX codec writes through ``ml_dtypes``), so
neither side needs ``ml_dtypes``.
"""
from __future__ import annotations

import hashlib
import json
import struct
from typing import Any

import numpy as np
import torch

MAGIC = b"KVC1"

# SDFS name prefixes: per-block chain blobs and the per-tenant warm
# index consumed by warm-at-spawn (serve/lm_manager.py:group_spawn)
BLOB_PREFIX = "kvb"
TENANT_PREFIX = "kvpub"


def namespace_key(parts: dict[str, Any]) -> str:
    """Collapse everything that affects KV content into one hex id.
    Callers (serve/cluster_prefix.py) pass model config, a params
    fingerprint, the static pool prefix tokens, quantize mode and
    block_size — any difference in any of them MUST produce disjoint
    chain names, or a fetch would splice another model's KV."""
    canon = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def rolling_hashes(namespace: str, tokens: list[int],
                   block_size: int) -> list[str]:
    """One hex digest per FULL block_size chunk of ``tokens``; digest j
    commits to namespace + chunks 0..j."""
    h = hashlib.sha256(namespace.encode()).hexdigest()
    out = []
    for j in range(len(tokens) // block_size):
        chunk = tokens[j * block_size:(j + 1) * block_size]
        raw = np.asarray(chunk, np.int64).tobytes()
        h = hashlib.sha256(bytes.fromhex(h) + raw).hexdigest()
        out.append(h)
    return out


def chain_names(namespace: str, tokens: list[int],
                block_size: int) -> list[str]:
    """SDFS blob name per full chunk, deepest last."""
    return [f"{BLOB_PREFIX}/{namespace}/{h}"
            for h in rolling_hashes(namespace, tokens, block_size)]


def tenant_index_name(namespace: str, tenant: str) -> str:
    return f"{TENANT_PREFIX}/{namespace}/tenants/{tenant}"


# torch dtypes a leaf may have, by the numpy dtype name the JAX codec
# writes for them
_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _leaf_bytes(arr) -> tuple[str, list[int], bytes]:
    """(dtype name, shape, C-contiguous little-endian bytes) of a torch
    tensor or numpy array; bf16 goes out as its raw 16-bit words."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise ValueError(f"KVC1 cannot carry dtype {t.dtype}")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy().tobytes()
        return name, list(t.shape), raw
    a = np.ascontiguousarray(arr)
    return a.dtype.name, list(a.shape), a.tobytes()


def encode_block(meta: dict[str, Any],
                 arrays: dict[str, Any]) -> bytes:
    """One block's leaves (torch tensors or numpy arrays) + metadata → a
    KVC1 blob. ``meta`` must carry the chunk's tokens
    (``meta["tokens"]``) — decode-side verification depends on it.
    Buffers are serialized C-contiguous in sorted leaf order so identical
    content yields identical bytes (content addressing needs bit-stable
    encoding)."""
    leaves, bufs, offset = {}, [], 0
    for key in sorted(arrays):
        dtype, shape, raw = _leaf_bytes(arrays[key])
        leaves[key] = {"dtype": dtype, "shape": shape,
                       "offset": offset, "nbytes": len(raw)}
        bufs.append(raw)
        offset += len(raw)
    header = json.dumps({"meta": meta, "leaves": leaves},
                        sort_keys=True).encode()
    return b"".join([MAGIC, struct.pack("<I", len(header)), header]
                    + bufs)


def decode_block(blob: bytes,
                 expect_tokens: list[int] | None = None,
                 ) -> tuple[dict[str, Any], dict[str, torch.Tensor]]:
    """KVC1 blob → (meta, {keystr: CPU tensor}). When ``expect_tokens``
    is given, the embedded chunk tokens must match EXACTLY — this is the
    guard that turns a stale/corrupt/colliding blob into a typed refusal
    instead of silently wrong KV."""
    if blob[:4] != MAGIC:
        raise ValueError(f"not a KVC1 blob (magic {blob[:4]!r})")
    (hlen,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8:8 + hlen].decode())
    meta = header["meta"]
    if expect_tokens is not None:
        got = [int(t) for t in meta.get("tokens", ())]
        if got != [int(t) for t in expect_tokens]:
            raise ValueError(
                "chain blob token mismatch: embedded chunk does not "
                "match the expected prefix chunk (stale or colliding "
                "publish refused)")
    base = 8 + hlen
    arrays = {}
    for key, spec in header["leaves"].items():
        dtype = _TORCH_DTYPES.get(spec["dtype"])
        if dtype is None:
            raise ValueError(f"KVC1 leaf {key!r} has dtype "
                             f"{spec['dtype']!r}, which the port cannot read")
        start = base + spec["offset"]
        raw = bytearray(blob[start:start + spec["nbytes"]])
        flat = (torch.frombuffer(raw, dtype=dtype) if raw
                else torch.empty(0, dtype=dtype))
        arrays[key] = flat.reshape(spec["shape"])
    return meta, arrays
