"""Continuous batching for LM serving (JetStream/vLLM-style).

A port of ``idunno_tpu/engine/serve_lm.py:DecodeServer``: a fixed pool of
decode slots where finished sequences retire immediately and queued
prompts are admitted into the freed rows while the other rows keep
decoding. Three steps on one device:

  prefill  — the whole prompt bucket in ONE chunked decode step
             (`models/transformer.py:decode_apply`, scalar cursor, t>1):
             prompt K/V written into a batch-1 row cache, first generated
             token picked at the row's true length. A radix-cache hit
             prefills only the suffix; on a paged pool the suffix attends
             the hit region through the block table (the CUDA kernel K3).
  insert   — the row cache + prompt tokens copied into slot r of the live
             [S, max_len] decode state.
  decode   — ONE token for ALL S slots per model step through the per-row
             cursors (each row attends its own depth; retired rows idle
             harmlessly); ``decode_steps`` steps run per `step()` call. On
             a paged pool every step attends each row's radix-hit region
             through K3. The KV cache is updated in place.

Speculative decoding (``draft=(draft_model, None)``): a cheap draft
proposes ``draft_len`` tokens a round, the target verifies them in ONE
chunked per-row apply (``draft_len + 1`` positions, K3 on a paged pool),
and `spec_commit` keeps greedy rows exactly on the target's greedy stream
and sampled rows exactly on its sampling distribution; ``decode_steps``
rounds run per `step()` call.

One dispatch, one replay (``decode_graph``): the JAX package compiles a
dispatch (``decode_steps`` steps or rounds) into one program; here a
dispatch in which no live row samples is recorded once as a
``torch.cuda.CUDAGraph`` (after one eager pass that builds the kernels)
and replayed from then on. The state it reads and writes lives in fixed
buffers updated in place. A dispatch in which a live row samples runs
eagerly: each sampled row draws from its own ``torch.Generator``, which a
fixed graph cannot hold. ``graph_stats()`` counts both kinds.

``quantize="int8"`` serves an int8 copy of the target's weights (f32
per-channel scales, dequantized inside each forward: ``ops/quantize.py``),
quantized layer by layer as the JAX package does; the caller's model stays
as it is, and so does the draft.

The cluster KV tier: with ``cluster_prefix`` set (a
``serve/cluster_prefix.py:ClusterPrefixCache``), an admission whose local
radix hit is short probes the store for a longer published chain, fetches
the missing blocks and grafts them into the radix tree, and an inserted
chain is published; the ``handoff_*`` legs export a prompt's blocks from a
prefill pool and adopt them into a decode pool (``store/kv_chain.py``
blobs). A fetched or adopted chain is a plain radix hit afterwards: on a
paged pool the suffix prefill and every decode step attend it through K3.

A routed model (``models/moe.py``: a ``ffn_factory`` on some blocks)
serves as the JAX server serves it: from the contiguous cache or a
gathered block pool, every row of a decode step (idle ones too) routed
together, so a row's expert capacity depends on the batch as it does
there; ``paged_kernel`` and a speculative pool over a routed target raise
as they do there.

Tensor parallelism (``n_model > 1`` or ``mesh=``, a ``parallel/mesh.py:
Mesh``): the pool decodes through `models/transformer.py:ShardedLM`, the
Megatron split written out (each model shard its Q heads, its KV heads or
all of them where they do not divide, its MLP slice and its vocab slice
of the unembed; two reductions per block, summed in shard order), its
slots split over the mesh's data axis. The KV cache and the block pool
are head-sharded (`engine/kv_blocks.py`), a paged pool runs K3 per shard
on the shard's pages, and the sampling tail resolves its picks from
per-shard statistics (`ops/sampling.py:VocabShards`). ``n_model > 1``
without a mesh builds a pure-TP mesh: over the visible cards on a card
(distinct devices, or `MeshShapeError`), and a virtual mesh over the one
CPU on the CPU (`parallel/mesh.py`). A mesh whose cells are distinct
devices runs its dispatches eagerly (a CUDA graph records one device's
work). A speculative pool's draft decodes through its own `ShardedLM`
when its Q heads divide ``n_model`` (its KV heads and vocab split or
replicate by the target's rules, its cache a `ShardedCache`), and
otherwise through a `ShardedLM` over the data groups' lead devices alone
(one whole replica a group; a routed draft is itself, on the lead);
the verify chunk runs through the target's `ShardedLM` (K3 per shard on
a paged pool), and the round's picks merge per-shard maxima while its
sampled rows and log-probabilities read the vocab parts joined in shard
order. A routed target refuses ``n_model > 1`` as the JAX package's pool
does (the TP split targets dense scanned blocks); over a data-only mesh
it serves as one replica on the mesh's lead device, every row of a step
routed together as the JAX pool routes its global batch.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from idunno_tpu_torch.engine.generate import init_cache
from idunno_tpu_torch.engine.inference import resolve_device
from idunno_tpu_torch.engine.kv_blocks import concat_kv_prefix
from idunno_tpu_torch.models.transformer import (KV_LEAF_KEYS, ShardedCache,
                                                 ShardedLM, TransformerLM,
                                                 decode_apply)
from idunno_tpu_torch.ops.paged_attention import (PagedContext,
                                                  paged_attention_kernel,
                                                  resolve_paged_kernel)
from idunno_tpu_torch.ops.quantize import quantize_tree
from idunno_tpu_torch.ops.sampling import (VocabShards, draw_sampled,
                                           filter_on, filtered_probs,
                                           fused_decode_tail, pick_token,
                                           shard_argmax, token_logprob)
from idunno_tpu_torch.parallel.sharding import (sampling_collective_bytes,
                                                tp_collective_bytes)

# the launch-counted kernel wrappers a decode dispatch can reach; a replay
# adds, per wrapper, the launches its capture recorded
_COUNTED = (paged_attention_kernel,)

# the slot default of the serving control plane (`serve/control.py`,
# `serve/lm_manager.py`), the JAX package's value: the knee of its
# measured slots-scaling curve on the TPU, not re-measured on a card;
# callers that want another batch pass `slots` explicitly
DEFAULT_SLOTS = 16


@dataclass
class Request:
    """One generation request: ``tokens`` is the raw prompt (host ints);
    ``temperature`` 0 = greedy, > 0 = per-row softmax sampling seeded by
    ``seed`` (defaults to the request id, so every request draws an
    independent, reproducible stream)."""

    id: int
    tokens: list[int]
    max_new: int
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # token-level stop sequences over the GENERATED region; a matched stop
    # sequence is KEPT in the output and the row retires at its final token
    stop: list[list[int]] | None = None
    seed: int | None = None
    t_admit: float = 0.0       # monotonic stamp set at slot admission
    # admitted before the server's FIRST decode dispatch
    cold: bool = False
    # (trace_id, parent_span_id) from the submitting hop (utils/spans.py)
    trace: tuple | None = None


@dataclass
class Completion:
    id: int
    tokens: list[int]          # prompt + generated, true ragged length
    prompt_len: int
    # SERVICE time: slot admission (prefill start) → retirement
    service_s: float = 0.0
    # client-cancelled mid-stream
    cancelled: bool = False
    # per-GENERATED-token logprobs under the raw model distribution; None
    # unless the pool was built with track_logprobs=True
    logprobs: list[float] | None = None
    # gateway rejection that completed the request without decoding
    rejected: str | None = None
    # admitted before the pool's first-ever decode dispatch
    cold_start: bool = False


def _abandon_capture(dev: torch.device, pool, stream) -> None:
    """Undo what a failed ``torch.cuda.graph`` capture leaves behind, so
    the process keeps drawing on the card: when the recorded body raises,
    ``capture_end`` raises too, and three things stay as the capture set
    them. The graph's side stream stays current (its stream context is
    never exited): ``stream``, current before, is made current again.
    The caching allocator keeps ``pool`` among its captures under way
    (and so never recycles cross-stream blocks): it is ended, where
    ``capture_end`` did not get to end it. And the card's default
    generator stays in capture mode, so every later random draw on the
    card raises: it is given a fresh state with the same seed and offset."""
    torch.cuda.set_stream(stream)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(idx, pool)
    except RuntimeError:
        pass                    # capture_end had ended it
    gen = torch.cuda.default_generators[idx]
    fresh = torch.Generator(device=dev)
    fresh.set_state(gen.get_state())
    gen.graphsafe_set_state(fresh)


def _splice_prefix(cache, prefix_cache):
    """Write a cached prefix's K/V leaves into the head of a (longer)
    fresh batch-1 cache, in place (sharded caches shard by shard)."""
    if isinstance(cache, ShardedCache):
        for row, prow in zip(cache.parts, prefix_cache.parts):
            for part, ppart in zip(row, prow):
                _splice_prefix(part, ppart)
        return cache
    for name in KV_LEAF_KEYS:
        if name in cache:
            src = prefix_cache[name]
            cache[name][:, :, :src.shape[2]] = src
    return cache


def resolve_decode_graph(kind: str, device: torch.device) -> str:
    """``auto`` → ``graph`` on a CUDA device, ``eager`` elsewhere;
    ``graph`` anywhere but on a CUDA device raises."""
    if kind not in ("auto", "graph", "eager"):
        raise ValueError(f"decode_graph must be auto|graph|eager, got {kind!r}")
    if kind == "auto":
        return "graph" if device.type == "cuda" else "eager"
    if kind == "graph" and device.type != "cuda":
        raise ValueError(f"decode_graph='graph' replays CUDA graphs and needs "
                         f"a CUDA device, got {device}")
    return kind


def _insert_cache(cache, row_cache, slot: int):
    """Cache-only splice of a batch-1 row cache into slot ``slot`` of the
    pool's cache, in place (the draft's prompt prefill; the target's
    insert writes the tokens as well). A sharded pool cache holds its
    slots in data-group order; the row cache is its group's."""
    if isinstance(cache, ShardedCache):
        per = next(iter(cache.parts[0][0].values())).shape[1]
        row = cache.parts[slot // per]
        for part, rpart in zip(row, row_cache.parts[0]):
            _insert_cache(part, rpart, slot % per)
        return cache
    for name, leaf in cache.items():
        src = row_cache[name]
        leaf[:, slot, :src.shape[2]] = src[:, 0]
    return cache


def _fill_cand(proposals: torch.Tensor, bonus: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """[S, γ+1] candidate tokens from [S, γ] proposals: positions < acc
    keep the (accepted) proposal, position acc carries the bonus token,
    the rest are zero padding (never committed)."""
    s, gamma = proposals.shape
    jidx = torch.arange(gamma + 1, device=proposals.device)[None, :]
    props_pad = torch.cat([proposals, proposals.new_zeros((s, 1))], dim=1)
    return torch.where(jidx < acc[:, None], props_pad,
                       torch.where(jidx == acc[:, None],
                                   bonus[:, None].to(proposals.dtype),
                                   torch.zeros_like(props_pad)))


def greedy_commit(proposals: torch.Tensor, tpred: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy-lane speculative commit: accept the longest prefix where the
    proposal equals the target argmax; bonus = the target argmax at the
    first miss. The committed stream is exactly the target's own greedy
    sequence. ONE definition shared by `spec_commit` (its greedy lane) and
    the all-greedy round of `DecodeServer`, so the two cannot drift."""
    gamma = proposals.shape[1]
    ok = proposals == tpred[:, :gamma]                       # [S, γ]
    acc = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)
    bonus = torch.gather(tpred, 1, acc[:, None])[:, 0]
    return _fill_cand(proposals, bonus, acc), acc


def spec_commit(proposals: torch.Tensor, qdist: torch.Tensor,
                pdist: torch.Tensor, tpred: torch.Tensor,
                sampled: torch.Tensor, u: torch.Tensor,
                resid_gens) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-decoding acceptance + commit math, standalone so its
    distribution guarantee is testable without a model.

    Greedy rows (``sampled[r]`` False): `greedy_commit` — the committed
    stream is exactly the target's greedy sequence.

    Sampled rows: speculative SAMPLING (Leviathan et al. 2023 / Chen et
    al. 2023): proposal j is accepted iff ``u_j < p_j(x_j) / q_j(x_j)``;
    at the first rejection the bonus draws from the residual
    ``max(p_j - q_j, 0)`` (normalized), and when every proposal is
    accepted from the target's ``p_{γ+1}``. The first committed token is
    then distributed EXACTLY as p (P[token] = q·min(1, p/q) + (1-α)·resid
    = p). The bonus of row r is drawn from ``resid_gens[r]``, its own
    ``torch.Generator``, so its bits differ from ``jax.random``'s and the
    lane is held to that distribution, not to the JAX package's tokens.

    Shapes: proposals [S, γ] int; qdist [S, γ, V] draft probabilities;
    pdist [S, γ+1, V] target probabilities; tpred [S, γ+1] target argmax;
    sampled [S] bool; u [S, γ] uniforms; ``resid_gens`` one generator (or
    None for a greedy row) per row. Returns (cand [S, γ+1] candidate
    tokens, acc [S] accepted proposal count); callers commit
    ``cand[:, :acc+1]``."""
    gamma = proposals.shape[1]
    cand_g, acc_g = greedy_commit(proposals, tpred)

    # sampled lane: rejection acceptance per position
    p_at = torch.gather(pdist[:, :gamma], 2, proposals[..., None])[..., 0]
    q_at = torch.gather(qdist, 2, proposals[..., None])[..., 0]
    ratio = p_at / torch.clamp_min(q_at, 1e-20)
    acc_s = torch.cumprod((u < ratio).to(torch.int64), dim=1).sum(dim=1)

    # bonus at the first non-accepted position from the residual; qdist
    # zero-padded at position γ makes the all-accepted case the same
    # formula (residual = p_{γ+1} - 0 = the target distribution)
    q_pad = torch.cat([qdist, torch.zeros_like(qdist[:, :1])], dim=1)
    at = acc_s[:, None, None].expand(-1, 1, pdist.shape[-1])
    p_acc = torch.gather(pdist, 1, at)[:, 0]                 # [S, V]
    q_acc = torch.gather(q_pad, 1, at)[:, 0]
    resid = torch.clamp_min(p_acc - q_acc, 0.0)
    mass = resid.sum(dim=1, keepdim=True)
    # p == q exactly → zero residual, but then rejection has probability
    # 0 under exact arithmetic; guard round-off by falling back to p
    resid = torch.where(mass > 1e-12, resid, p_acc)
    rows = [int(r) for r in torch.nonzero(sampled)[:, 0].tolist()]
    bonus_s = torch.zeros_like(acc_s)
    if rows:
        bonus_s[rows] = draw_sampled(resid[rows], [resid_gens[r] for r in rows])
    cand_s = _fill_cand(proposals, bonus_s, acc_s)

    acc = torch.where(sampled, acc_s, acc_g)
    cand = torch.where(sampled[:, None], cand_s, cand_g)
    return cand, acc


@dataclass
class _Replay:
    """One captured dispatch: the graph, the launches its capture recorded
    per counted wrapper, and the bytes of its private memory pool."""

    graph: torch.cuda.CUDAGraph
    launches: dict
    pool_bytes: int


def _argmax(logits) -> torch.Tensor:
    """Greedy picks over the vocab of logits (a tensor or `VocabShards`:
    per-shard maxima merged in shard order, ties to the lowest id as
    ``torch.argmax`` over the whole row)."""
    if isinstance(logits, VocabShards):
        return shard_argmax(logits.parts)
    return torch.argmax(logits, dim=-1)


def _whole(logits, device: torch.device) -> torch.Tensor:
    """The logits over the whole vocab on ``device``: `VocabShards` parts
    joined in shard order (what a speculative round's sampled rows and
    log-probabilities read: each row's whole distribution)."""
    if isinstance(logits, VocabShards):
        return torch.cat([p.to(device) for p in logits.parts], dim=-1)
    return logits


def _make_paged_ctx(pages: dict, tables: torch.Tensor,
                    lengths: torch.Tensor, start: int,
                    kernel: str) -> PagedContext:
    return PagedContext(pages["cached_k"], pages["cached_v"], tables, lengths,
                        k_scale_pages=pages.get("k_scale"),
                        v_scale_pages=pages.get("v_scale"),
                        start=start, kernel=kernel)


def _prefill(model: TransformerLM, prompt: torch.Tensor, true_len: int,
             prompt_len: int) -> tuple[dict, torch.Tensor]:
    """[1, P] prompt → (length-P row cache, logits [vocab] at the row's
    true length). Pad positions ≥ true_len leave garbage K/V in the cache
    tail; the slot cursor masks them until real tokens overwrite them."""
    cache = init_cache(model, 1, prompt_len)
    logits = decode_apply(model, cache, prompt, 0)
    return cache, logits[0, true_len - 1]


def _prefill_suffix(model: TransformerLM, prefix_cache: dict,
                    suffix: torch.Tensor, true_len: int, prefix_len: int,
                    prompt_len: int) -> tuple[dict, torch.Tensor]:
    """[1, P] suffix after a length-``prefix_len`` cached prefix (spliced
    into the head of a fresh cache) → (length-(prefix_len+P) row cache,
    first generated token's logits)."""
    cache = _splice_prefix(init_cache(model, 1, prefix_len + prompt_len),
                           prefix_cache)
    logits = decode_apply(model, cache, suffix, prefix_len)
    return cache, logits[0, true_len - 1]


def _prefill_suffix_paged(model: TransformerLM, prefix_cache: dict | None,
                          suffix: torch.Tensor, true_len: int,
                          prefix_len: int, prompt_len: int,
                          tables: torch.Tensor, plen: torch.Tensor,
                          pages: dict, *, start: int,
                          kernel: str) -> tuple[dict, torch.Tensor]:
    """The gather-free twin of `_prefill_suffix`: the radix-hit region
    [start, prefix_len) is NOT spliced — it stays zero and masked while
    the suffix attends it through the block table. Only the pool-level
    static prefix [0, start), if any, is spliced contiguously."""
    cache = init_cache(model, 1, prefix_len + prompt_len)
    if prefix_cache is not None:
        _splice_prefix(cache, prefix_cache)
    ctx = _make_paged_ctx(pages, tables, plen, start, kernel)
    logits = decode_apply(model, cache, suffix, prefix_len, paged=ctx)
    return cache, logits[0, true_len - 1]


def _chunk_init(model: TransformerLM, prefix_cache: dict | None,
                total: int) -> dict:
    """Fresh batch-1 length-``total`` cache with an optional contiguous
    prefix spliced in — the starting state of a chunked prefill."""
    cache = init_cache(model, 1, total)
    if prefix_cache is not None:
        _splice_prefix(cache, prefix_cache)
    return cache


def _prefill_chunk(model: TransformerLM, cache: dict, tok: torch.Tensor,
                   cursor: int, tables, plen, pages, *, start: int = 0,
                   kernel: str = "plain") -> torch.Tensor:
    """ONE chunk of a chunked prefill: ``tok`` [1, n] applies from
    ``cursor`` into ``cache`` (in place); returns the chunk's logits. N
    chunks build the identical cache and logits as one apply."""
    ctx = None
    if tables is not None:
        ctx = _make_paged_ctx(pages, tables, plen, start, kernel)
    return decode_apply(model, cache, tok, cursor, paged=ctx)


class DecodeServer:
    """Continuous-batching decode pool over a dense `TransformerLM`.

    ``slots`` concurrent sequences, each ≤ ``max_len`` total tokens;
    prompts are padded to the smallest ``prompt_buckets`` entry covering
    them (true lengths tracked exactly). Greedy requests match
    `engine.generate.generate(temperature=0)` token for token; sampled
    requests draw per-request seeded streams (on speculative pools the
    rejection scheme keeps them distribution-exact against the target).
    The model is moved to ``device`` (the card unless ``device="cpu"``;
    no card raises).

    ``draft=(draft_model, None)`` makes the pool speculative: the JAX
    package's ``(model, params)`` tuple becomes the draft ``nn.Module``,
    which carries its own weights, and ``None`` where the params stood.
    The draft proposes ``draft_len`` tokens a round and keeps its own
    contiguous per-row cache (on a paged pool only the target attends
    through the block table); it is not quantized by ``quantize``. Under
    a mesh it shards as the JAX package's draft does (module docstring).

    ``decode_graph`` is ``auto`` (``graph`` on CUDA, ``eager`` on the
    CPU), ``graph`` (replay each all-greedy dispatch as one captured CUDA
    graph; a failed capture raises) or ``eager``.

    Usage::

        srv = DecodeServer(model, slots=4, prompt_len=16, max_len=64)
        srv.submit([1, 2, 3], max_new=10)
        while srv.step():          # admit + decode_steps steps per call
            for done in srv.poll():
                ...
    """

    def __init__(self, model: TransformerLM, *, slots: int, prompt_len: int,
                 max_len: int, decode_steps: int = 1, quantize: str = "none",
                 eos_id: int | None = None, mesh=None, n_model: int = 1,
                 draft: tuple | None = None, draft_len: int = 4,
                 prompt_buckets: tuple[int, ...] | None = None,
                 track_logprobs: bool = False, penalties: bool = False,
                 prefix: list[int] | None = None, kv_block_size: int = 0,
                 kv_cache_blocks: int = 0, paged_kernel: str | None = None,
                 prefill_chunk: int = 0, decode_graph: str = "auto",
                 device: torch.device | str | None = None) -> None:
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize={quantize!r}: want none|int8")
        if not model.causal:
            raise ValueError("continuous batching needs a causal LM")
        if prompt_len > max_len:
            raise ValueError(f"prompt_len {prompt_len} > max_len {max_len}")
        self.prompt_buckets = tuple(sorted(set(prompt_buckets or ())))
        if self.prompt_buckets:
            if self.prompt_buckets[-1] != prompt_len:
                raise ValueError(
                    f"largest prompt bucket {self.prompt_buckets[-1]} must "
                    f"equal prompt_len {prompt_len}")
            if self.prompt_buckets[0] < 1:
                raise ValueError("prompt buckets must be >= 1")
        else:
            self.prompt_buckets = (prompt_len,)
        if decode_steps < 1:
            raise ValueError(f"decode_steps {decode_steps} must be >= 1")
        self.kv_block_size = int(kv_block_size)
        if self.kv_block_size < 0:
            raise ValueError(
                f"kv_block_size {kv_block_size} must be >= 0 (0 = off)")
        if kv_cache_blocks and not self.kv_block_size:
            raise ValueError("kv_cache_blocks needs kv_block_size > 0")
        if paged_kernel is not None and not self.kv_block_size:
            raise ValueError("paged_kernel needs kv_block_size > 0")
        if paged_kernel is not None and getattr(model, "ffn_factory",
                                                None) is not None:
            # the JAX package threads the paged context through its
            # scanned decode layout only, which routed blocks do not
            # take: MoE pools keep the gathered path
            raise ValueError("paged_kernel requires the scanned decode "
                             "layout (dense scan-compatible blocks)")
        mesh, n_model = self._resolve_mesh(mesh, int(n_model), slots,
                                           device)
        self.mesh, self.n_model = mesh, n_model
        self.device = mesh.lead if mesh is not None else resolve_device(device)
        if mesh is not None and len(mesh.distinct()) > 1:
            # a CUDA graph records one device's stream: a mesh of distinct
            # devices runs its dispatches eagerly
            if decode_graph == "graph":
                raise ValueError("decode_graph='graph' records one device; "
                                 "a mesh over distinct devices runs eager")
            decode_graph = "eager"
        self.decode_graph = resolve_decode_graph(decode_graph, self.device)
        self.paged_kernel = (None if paged_kernel is None else
                             resolve_paged_kernel(paged_kernel, self.device))
        self._paged = paged_kernel is not None
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be >= 0 (0 = off)")
        self._pending: dict | None = None   # in-flight chunked admission
        self._block_pool = self._radix = None
        self._held: dict[int, list] = {}   # live request id → pinned chain
        # optional per-node span recorder (utils/spans.py), set by the
        # serving layer after construction; None = tracing off, zero cost
        self.spans = None
        # optional cluster prefix cache (serve/cluster_prefix.py), set by
        # the serving layer after warmup; None = the local radix tier only
        self.cluster_prefix = None
        self.prefix = list(prefix) if prefix else None
        self._prefix_cache = None
        if self.prefix:
            for t in self.prefix:
                if not 0 <= t < model.vocab:
                    raise ValueError(f"prefix token {t} outside vocab "
                                     f"[0, {model.vocab})")
            if len(self.prefix) + max(self.prompt_buckets) > max_len:
                raise ValueError(
                    f"prefix of {len(self.prefix)} + prompt bucket "
                    f"{max(self.prompt_buckets)} exceeds max_len {max_len}")
        if draft is not None:
            # decode_steps on a speculative pool = draft+verify ROUNDS a
            # dispatch (each commits 1..draft_len+1 tokens per row)
            if draft_len < 1:
                raise ValueError(f"draft_len {draft_len} must be >= 1")
            if draft[1] is not None:
                raise ValueError("the draft carries its weights in its "
                                 "module: pass draft=(model, None)")
            if not draft[0].causal:
                raise ValueError("the draft model must be causal")
            if draft[0].vocab != model.vocab:
                raise ValueError(
                    f"draft vocab {draft[0].vocab} != target {model.vocab}")
            if getattr(model, "ffn_factory", None) is not None:
                # routed-FFN logits depend on the batch composition, so a
                # γ+1 verify chunk is not equivalent to per-token decode
                raise ValueError(
                    "speculative decoding requires a dense target "
                    "(routed-FFN logits are batch-composition-dependent, "
                    "so chunked verification is not equivalent to "
                    "per-token decode)")
            if penalties:
                # a verify chunk's later positions would need counts that
                # include tokens committed earlier in the same chunk
                raise ValueError(
                    "penalties are not supported on speculative pools "
                    "(count-dependent logits break the parallel verify)")
        self.quantize = quantize
        self.track_logprobs = bool(track_logprobs)
        self.penalties = bool(penalties)
        self._pl_static = len(self.prefix) if self.prefix else 0
        self.model = model.to(self.device).eval()
        if quantize == "int8":
            # decode re-reads every weight per step: int8 residency halves
            # those bytes against bf16; the dequantize runs in each forward
            self.model = quantize_tree(copy.deepcopy(self.model))
        # what every decode call runs: the model, or its tensor-parallel
        # decoder over the mesh (the same weights, cut per shard). A
        # routed target over a data-only mesh decodes as one replica on
        # the lead for the whole batch: routing couples the rows of a
        # batch, and the JAX package routes them together (a routed
        # target with n_model > 1 takes ShardedLM's refusal)
        routed_dp = n_model == 1 and getattr(model, "ffn_factory",
                                             None) is not None
        self._dec = (self.model if mesh is None or routed_dp
                     else ShardedLM(self.model, mesh))
        self.slots = slots
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.decode_steps = decode_steps
        self.eos_id = eos_id
        self.draft_len = draft_len
        self._draft_model = self._draft_dec = self._draft_cache = None
        self._draft_prefix_cache = None
        if draft is not None:
            self._draft_model = draft[0].to(self.device).eval()
            self._draft_dec = self._draft_decoder(self._draft_model)
            self._draft_cache = init_cache(self._draft_dec, slots, max_len)
        # the captured all-greedy dispatch (graph pools), made at the first
        # such dispatch; replayed and eager dispatch counts
        self._replay: _Replay | None = None
        self._dispatch_counts = {"replayed": 0, "eager": 0}

        dev = self.device
        i64 = torch.int64
        self._tokens = torch.zeros((slots, max_len), dtype=i64, device=dev)
        self._cache = init_cache(self._dec, slots, max_len)
        self._cursors = torch.zeros((slots,), dtype=i64, device=dev)
        self._remaining = torch.zeros((slots,), dtype=i64, device=dev)
        # paged decode state: per-slot block table + paged-region length
        # (always a block multiple). Width = the longest possible radix
        # hit (one block short of the largest bucket). Retired rows leave
        # stale entries behind, gated by remaining == 0.
        self._tables = self._plens = None
        if self._paged:
            self._max_chain = max(1, (prompt_len - 1) // self.kv_block_size)
            self._tables = torch.zeros((slots, self._max_chain),
                                       dtype=torch.int32, device=dev)
            self._plens = torch.zeros((slots,), dtype=torch.int32, device=dev)
        # host copy of (remaining, cursors), fetched in one transfer and
        # reused until a device-side mutation invalidates it
        self._rc_cache: np.ndarray | None = None
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._top_ps = torch.ones((slots,), dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros((slots,), dtype=i64, device=dev)
        self._gens: list[torch.Generator | None] = [None] * slots
        self._logprobs = torch.zeros(
            (slots, max_len if self.track_logprobs else 0),
            dtype=torch.float32, device=dev)
        self._pres = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._freq = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._counts = torch.zeros(
            (slots, model.vocab if self.penalties else 0), dtype=i64,
            device=dev)

        # host state
        self._queue: deque[Request] = deque()
        self._live: dict[int, Request] = {}       # slot → request
        self._done: list[Completion] = []
        self._next_id = 0
        self._cancelled: set[int] = set()     # ids cancelled while live
        self._stats = {"dispatches": 0, "admitted": 0, "completed": 0,
                       "tokens_generated": 0, "cancelled": 0,
                       # padded suffix tokens computed by admission
                       # prefills — the work the prefix cache shrinks
                       "prefill_tokens": 0,
                       "prefill_chunks": 0, "kv_gather_bytes_saved": 0,
                       "kv_handoff_requests": 0, "kv_handoff_bytes": 0,
                       "kv_handoff_fallbacks": 0}
        self._pc_lookups = self._pc_hits = self._pc_tokens_saved = 0
        self._dispatched_ever = False

        # shared-prefix cache (system prompt): prefilled ONCE here; every
        # admission then prefills only its suffix from a spliced copy.
        if self.prefix:
            pf = torch.tensor([self.prefix], dtype=i64, device=dev)
            pl = len(self.prefix)
            with torch.no_grad():
                self._prefix_cache, _ = _prefill(self._row_dec(0), pf, pl,
                                                 pl)
                if self._draft_model is not None:
                    self._draft_prefix_cache, _ = _prefill(
                        self._draft_row_dec(0), pf, pl, pl)

        if self.kv_block_size:
            from idunno_tpu_torch.engine.kv_blocks import KVBlockPool
            from idunno_tpu_torch.serve.prefix_cache import RadixPrefixCache
            nblocks = int(kv_cache_blocks) or slots * (
                (prompt_len + self.kv_block_size - 1) // self.kv_block_size)
            self._block_pool = KVBlockPool(
                self.model, nblocks, self.kv_block_size,
                mesh=mesh if isinstance(self._dec, ShardedLM) else None,
                device=dev)
            self._radix = RadixPrefixCache(self._block_pool)

    @staticmethod
    def _resolve_mesh(mesh, n_model: int, slots: int, device):
        """The pool's mesh and model-axis extent (the JAX package's rules):
        ``n_model > 1`` with no mesh builds a pure-TP mesh; a mesh is
        authoritative, and a conflicting ``n_model`` raises."""
        from idunno_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                    Mesh, make_mesh,
                                                    virtual_mesh)
        if n_model < 1:
            raise ValueError(f"n_model {n_model} must be >= 1")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if mesh is None and n_model > 1:
            dev = resolve_device(device)
            # the CPU is one device: its pools shard over a virtual mesh
            # (the JAX tests' forced host devices); cards must be distinct
            mesh = (virtual_mesh(1, n_model, dev) if dev.type == "cpu"
                    else make_mesh(1, n_model))
        if mesh is None:
            return None, n_model
        mesh_model = mesh.shape[MODEL_AXIS]
        if n_model == 1:
            n_model = mesh_model            # the mesh is authoritative
        elif n_model != mesh_model:
            raise ValueError(f"n_model={n_model} conflicts with the mesh's "
                             f"model axis extent {mesh_model}")
        if device is not None and torch.device(device).type != \
                mesh.lead.type:
            raise ValueError(f"device={device} but the mesh's devices are "
                             f"{mesh.lead.type}")
        n_data = mesh.shape[DATA_AXIS]
        if slots % n_data:
            raise ValueError(f"slots={slots} must divide over the mesh "
                             f"data axis ({n_data})")
        return mesh, n_model

    def _group(self, slot: int) -> int:
        """The data group (mesh row) that holds pool slot ``slot``: 0
        when one decoder runs the whole batch."""
        if not isinstance(self._dec, ShardedLM):
            return 0
        return self._dec.group_of(slot, self.slots)

    def _row_dec(self, slot: int):
        """What a batch-1 prefill for slot ``slot`` runs: the model, or the
        tensor-parallel decoder of the slot's data group."""
        if not isinstance(self._dec, ShardedLM):
            return self._dec
        return self._dec.for_group(self._group(slot))

    def _draft_decoder(self, draft: TransformerLM):
        """What the draft decodes through (the JAX package's placement):
        the draft itself without a mesh; under one, its own `ShardedLM`
        when its Q heads divide ``n_model``, else a `ShardedLM` over a
        mesh of the data groups' lead devices (one whole replica a
        group, the JAX ``replicate``). A routed draft cannot shard and
        stays itself, on the lead, for the whole batch (routing couples
        the rows of a batch, which the JAX package routes together)."""
        from idunno_tpu_torch.parallel.mesh import make_mesh

        mesh = self.mesh
        if mesh is None or getattr(draft, "ffn_factory", None) is not None:
            return draft
        if draft.num_heads % self.n_model == 0:
            return ShardedLM(draft, mesh)
        leads = [row[0] for row in mesh.devices]
        return ShardedLM(draft, make_mesh(len(leads), 1, devices=leads,
                                          virtual=True))

    def _draft_row_dec(self, slot: int):
        """The draft's counterpart of `_row_dec`: its decoder of the data
        group that holds slot ``slot``."""
        dec = self._draft_dec
        if not isinstance(dec, ShardedLM):
            return dec
        return dec.for_group(dec.group_of(slot, self.slots))

    # -- client surface ---------------------------------------------------

    def validate(self, tokens: list[int], max_new: int,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, presence_penalty: float = 0.0,
                 frequency_penalty: float = 0.0,
                 stop: list[list[int]] | None = None) -> None:
        """Raise ValueError if the request can't fit this server's static
        buckets; shared by every submission front-end."""
        if not tokens:
            raise ValueError("empty prompt")
        for t in tokens:
            if not 0 <= t < self.model.vocab:
                raise ValueError(f"prompt token {t} outside vocab "
                                 f"[0, {self.model.vocab})")
        if len(tokens) > self.prompt_len:
            raise ValueError(f"prompt of {len(tokens)} tokens exceeds the "
                             f"prompt_len bucket {self.prompt_len}")
        # a verify chunk may overshoot the last token
        headroom = (self.draft_len + 1 if self._draft_model is not None
                    else 0)
        pl = len(self.prefix) if self.prefix else 0
        if pl + len(tokens) + max_new + headroom > self.max_len:
            raise ValueError(
                (f"{pl} prefix + " if pl else "")
                + f"{len(tokens)} prompt + {max_new} new"
                + (f" + {headroom} speculative headroom" if headroom
                   else "")
                + f" > max_len {self.max_len}")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if temperature < 0.0:
            raise ValueError(f"temperature {temperature} must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p {top_p} must be in (0, 1]")
        if top_k < 0 or top_k != int(top_k):
            raise ValueError(f"top_k {top_k} must be a non-negative int")
        if (presence_penalty or frequency_penalty) and not self.penalties:
            raise ValueError(
                "this pool was built without penalties=True; "
                "presence/frequency penalties need the count buffer")
        for seq in stop or ():
            if not seq:
                raise ValueError("empty stop sequence")
            for t in seq:
                if not 0 <= t < self.model.vocab:
                    raise ValueError(f"stop token {t} outside vocab "
                                     f"[0, {self.model.vocab})")

    def submit(self, tokens: list[int], max_new: int, *,
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               stop: list[list[int]] | None = None,
               seed: int | None = None,
               trace: tuple | None = None) -> int:
        """Queue a prompt; returns the request id. ``temperature`` 0 =
        greedy; > 0 samples with a per-request stream seeded by ``seed``
        (default: the request id); ``top_k`` > 0 then ``top_p`` < 1
        restrict it, exactly as in `engine.generate`."""
        self.validate(tokens, max_new, temperature, top_p, top_k,
                      presence_penalty, frequency_penalty, stop)
        rid = self._next_id
        self._next_id += 1
        self._queue.append(Request(id=rid, tokens=list(tokens),
                                   max_new=max_new,
                                   temperature=temperature, top_p=top_p,
                                   top_k=int(top_k),
                                   presence_penalty=float(presence_penalty),
                                   frequency_penalty=float(frequency_penalty),
                                   stop=([list(q) for q in stop]
                                         if stop else None),
                                   seed=seed,
                                   trace=(tuple(trace) if trace else None)))
        return rid

    def poll(self) -> list[Completion]:
        """Completions finished since the last poll (ownership transfers)."""
        out, self._done = self._done, []
        return out

    def cancel(self, rid: int) -> str:
        """Best-effort cancel: "queued" (dropped before admission), "live"
        (the row stops at the next retirement pass and completes with
        ``cancelled=True``), or "unknown"."""
        if self._pending is not None and self._pending["req"].id == rid:
            p, self._pending = self._pending, None
            if p["hit_chain"]:          # the temporary hit pins
                self._radix.release(p["hit_chain"])
            if p["span"] is not None:
                self.spans.finish(p["span"], cancelled=True,
                                  chunks=p["chunks"])
            full = (self.prefix or []) + list(p["per_req"])
            self._done.append(Completion(
                id=rid, tokens=full, prompt_len=len(full), cancelled=True,
                logprobs=[] if self.track_logprobs else None))
            self._stats["cancelled"] += 1
            return "queued"
        for i, req in enumerate(self._queue):
            if req.id == rid:
                del self._queue[i]
                full = (self.prefix or []) + list(req.tokens)
                self._done.append(Completion(
                    id=rid, tokens=full, prompt_len=len(full),
                    cancelled=True,
                    logprobs=[] if self.track_logprobs else None))
                self._stats["cancelled"] += 1
                return "queued"
        for slot, req in self._live.items():
            if req.id == rid:
                # a row whose budget is already exhausted is COMPLETE
                if int(self._remaining_cursors()[0][slot]) == 0:
                    return "unknown"
                self._remaining[slot] = 0
                self._rc_invalidate()
                self._cancelled.add(rid)
                self._stats["cancelled"] += 1
                return "live"
        return "unknown"

    def snapshot(self) -> list[dict]:
        """Progress of every LIVE row — id, tokens so far (prompt +
        generated), prompt length."""
        if not self._live:
            return []
        cursors = self._remaining_cursors()[1]
        tokens = self._tokens.cpu().numpy()
        return [{"id": req.id,
                 "tokens": [int(t) for t in tokens[slot][:cursors[slot] + 1]],
                 "prompt_len": len(req.tokens)}
                for slot, req in sorted(self._live.items())]

    def pending(self) -> int:
        return (len(self._queue) + len(self._live)
                + (1 if self._pending is not None else 0))

    def stats(self) -> dict:
        """Serving counters (decode dispatches, requests admitted/
        completed, generated tokens, occupancy) and the pool's serving
        configuration."""
        m = self.model
        config = {
            "vocab": m.vocab, "dim": m.dim, "depth": m.depth,
            "heads": m.num_heads, "kv_heads": m.kv_heads,
            "kv_cache_dtype": m.kv_cache_dtype,
            "quantize": self.quantize,
            "track_logprobs": self.track_logprobs,
            "penalties": self.penalties,
            "prefix_len": len(self.prefix) if self.prefix else 0,
            "decode_steps": self.decode_steps,
            "prompt_len": self.prompt_len, "max_len": self.max_len,
            "speculative_draft_len": (self.draft_len
                                      if self._draft_model is not None
                                      else None),
            "kv_block_size": self.kv_block_size,
            "paged_kernel": self.paged_kernel,
            "prefill_chunk": self.prefill_chunk,
            "kv_cache_blocks": (self._block_pool.num_blocks
                                if self._block_pool is not None else 0),
            "device": str(self.device),
            # tensor parallelism: model-axis extent + estimated reduction
            # payload per decode step (2 row-parallel reductions per
            # block over a [slots, 1, dim] activation; 0 when TP is off)
            "n_model": self.n_model,
            "tp_collective_bytes": tp_collective_bytes(
                m, self.slots, self.n_model),
            # vocab-sharded sampling tail: per-row scalar merge payload
            # instead of a gathered [S, vocab]; 0 when TP is off or the
            # vocab replicates
            "sampling_collective_bytes": sampling_collective_bytes(
                m, self.slots, self.n_model),
        }
        out = dict(self._stats, live=len(self._live),
                   queued=len(self._queue), slots=self.slots,
                   config=config)
        if self._radix is not None:
            out["prefix_cache"] = self.prefix_cache_stats()
        return out

    def graph_stats(self) -> dict:
        """How dispatches ran (outside `stats()`, whose keys are the JAX
        package's): ``replayed`` (one CUDA-graph replay each) and
        ``eager`` counts, the resolved ``decode_graph`` mode, the
        captured graph's private memory pool in bytes and the kernel
        launches one replay makes (by wrapper name; 0 and {} before a
        capture)."""
        r = self._replay
        return dict(self._dispatch_counts, mode=self.decode_graph,
                    graph_pool_bytes=r.pool_bytes if r else 0,
                    launches_per_replay=({fn.__name__: n for fn, n
                                          in r.launches.items()}
                                         if r else {}))

    def prefix_cache_stats(self) -> dict:
        """Radix prefix-cache gauges (kv_block_size pools): hit rate over
        admissions, prompt tokens whose prefill was skipped, block-pool
        occupancy, tree churn counters, plus the cluster prefix-cache
        counters (zeros when the cluster tier is off, so dashboards see a
        stable gauge set)."""
        out = {
            "prefix_hit_rate": (self._pc_hits / self._pc_lookups
                                if self._pc_lookups else 0.0),
            "lookups": self._pc_lookups,
            "hits": self._pc_hits,
            "cached_tokens_saved": self._pc_tokens_saved,
            "kv_blocks_free": self._block_pool.num_free,
            "kv_blocks_used": self._block_pool.num_used,
            "evictions": self._radix.evictions,
            "insert_skips": self._radix.insert_skips,
            "inserted_blocks": self._radix.inserted_blocks,
            "nodes": self._radix.num_nodes(),
            "prefix_remote_hits": 0,
            "prefix_published_chains": 0,
            "prefix_warm_blocks": 0,
            "prefix_fetch_bytes": 0,
        }
        if self.cluster_prefix is not None:
            out.update(self.cluster_prefix.stats())
        return out

    # -- cluster prefix cache (serve/cluster_prefix.py) -------------------

    def _cluster_fetch(self, per_req: list, local: int, want: int) -> int:
        """Probe the ring for a chain longer than the ``local`` radix
        depth, fetch the missing depths [local, found) and graft them.
        Returns new blocks grafted (0 = miss/failure — the admission
        proceeds on its local hit)."""
        cp = self.cluster_prefix
        bs = self.kv_block_size
        depth = cp.probe(per_req[:want * bs], start_depth=local)
        if depth <= local:
            return 0
        fetched = cp.fetch(per_req, local, depth)
        if not fetched:
            return 0
        wrote = self._radix.graft(per_req, fetched, local)
        if wrote:
            cp.remote_hits += 1
        return wrote

    def prefix_probe(self, tokens: list[int]) -> dict:
        """`prefix_probe` verb: local radix depth vs the deepest
        published depth for this prompt. Pure read (the lookup only
        touches LRU stamps)."""
        cp = self._require_cluster()
        local = len(self._radix.lookup(list(tokens)))
        remote = cp.probe(list(tokens))
        return {"local_blocks": local, "remote_blocks": remote,
                "namespace": cp.namespace,
                "block_size": self.kv_block_size}

    def prefix_warm(self, tokens: list[int] | None = None,
                    tenant: str | None = None) -> dict:
        """`prefix_fetch` verb: pull published chains into the radix
        tree WITHOUT an admission — the warm-at-spawn primitive. With
        ``tenant`` (and no tokens) the per-tenant warm index names the
        prefixes to pull. Fetched blocks count as ``warm_blocks``;
        grafting reuses chunks already present, so a replayed warm
        converges."""
        cp = self._require_cluster()
        targets = []
        if tokens is not None:
            targets.append([int(t) for t in tokens])
        elif tenant is not None:
            targets = [e.get("tokens", []) for e in
                       cp.tenant_entries(str(tenant))]
        else:
            raise ValueError("prefix_fetch needs tokens or tenant")
        fetched_blocks = 0
        for toks in targets:
            want = len(toks) // self.kv_block_size
            if want < 1:
                continue
            local = len(self._radix.lookup(toks))
            if local >= want:
                continue
            depth = cp.probe(toks[:want * self.kv_block_size],
                             start_depth=local)
            if depth <= local:
                continue
            blobs = cp.fetch(toks, local, depth)
            if blobs:
                fetched_blocks += self._radix.graft(toks, blobs, local)
        cp.warm_blocks += fetched_blocks
        return {"fetched_blocks": fetched_blocks,
                "targets": len(targets), "bytes": cp.fetch_bytes}

    def prefix_publish(self, tokens: list[int] | None = None,
                       tenant: str | None = None) -> dict:
        """`prefix_publish` verb: push cached chains to the ring. With
        ``tokens``, the longest local chain for that prompt; without,
        every root-to-leaf path in the radix tree (min-hits policy
        bypassed — an explicit publish is an operator decision)."""
        cp = self._require_cluster()
        chains = []
        if tokens is not None:
            chain = self._radix.lookup([int(t) for t in tokens])
            if chain:
                chains.append(chain)
        else:
            stack = [[nd] for nd in self._radix._root.children.values()]
            while stack:
                path = stack.pop()
                kids = path[-1].children
                if not kids:
                    chains.append(path)
                    continue
                for nd in kids.values():
                    stack.append(path + [nd])
        published = blocks = 0
        for chain in chains:
            toks = [t for nd in chain for t in nd.chunk]
            out = cp.publish(
                toks, len(chain),
                (lambda ch: lambda j: self._block_pool.read_block(
                    ch[j].block))(chain),
                tenant=tenant, force=True)
            published += out["published"]
            blocks += out["blocks"]
        return {"published_blocks": published, "chains": len(chains),
                "blocks": blocks}

    def _require_cluster(self):
        if self.cluster_prefix is None or self._radix is None:
            raise ValueError("pool has no cluster prefix cache "
                             "(serve with cluster_prefix= and "
                             "kv_block_size > 0)")
        return self.cluster_prefix

    # -- KV handoff (prefill replica → decode replica) ----------------------
    #
    # A prefill-role replica fills the block-aligned head of a long prompt,
    # encodes the populated blocks as KVC1 blobs, and the decode replica
    # grafts them into its own radix tree — point-to-point over the
    # transport, no store round trip. The handoff state machine lives in
    # `serve/lm_manager.py`; these legs are its pool-local half and need
    # only the radix tier (kv_block_size > 0), not the cluster cache.

    def _require_handoff(self) -> None:
        if self._radix is None:
            raise ValueError("pool has no KV block tier "
                             "(serve with kv_block_size > 0)")

    def handoff_probe(self, tokens: list[int]) -> dict:
        """`kv_handoff` probe leg: the local radix depth for ``tokens``
        plus the pool's block geometry, so a prefill replica ships only
        the block suffix this replica does not hold yet. Pure read (the
        lookup only touches LRU stamps)."""
        self._require_handoff()
        toks = [int(t) for t in tokens]
        bs = self.kv_block_size
        return {"depth": len(self._radix.lookup(toks)),
                "want": max(0, (len(toks) - 1) // bs),
                "block_size": bs}

    @torch.no_grad()
    def _prefill_head(self, head: list[int], hit_chain: list) -> list:
        """Prefill the missing block-aligned suffix of ``head`` (the
        handoff export's fill leg) and insert the chain — `_admit`'s
        one-shot prefill branches with the block head in place of the
        full prompt, so paged (K3 on a card), gathered and prefix pools
        fill through their own machinery. Returns the ACQUIRED chain for
        ``head`` (the caller releases it)."""
        pl = len(self.prefix) if self.prefix else 0
        bs = self.kv_block_size
        dev = self.device
        dec = self._row_dec(0)
        hit = len(hit_chain) * bs
        head_true = len(head)
        while True:
            rest = head_true - hit
            bucket = next(
                (b for b in self.prompt_buckets
                 if b >= rest and pl + hit + b <= self.max_len), None)
            if bucket is not None:
                break
            if hit <= 0:
                raise ValueError(
                    f"no prompt bucket fits a {head_true}-token "
                    "handoff head")
            hit -= bs
        hit_chain = hit_chain[:hit // bs]
        if hit_chain:
            self._radix.acquire(hit_chain)
        try:
            suffix = torch.zeros((1, bucket), dtype=torch.int64)
            suffix[0, :head_true - hit] = torch.tensor(head[hit:])
            suffix = suffix.to(dev)
            self._stats["prefill_tokens"] += bucket
            if self._paged and hit:
                tab = torch.tensor([[nd.block for nd in hit_chain]],
                                   dtype=torch.int32, device=dev)
                plen = torch.tensor([hit], dtype=torch.int32, device=dev)
                row_cache, _ = _prefill_suffix_paged(
                    dec, self._prefix_cache, suffix, head_true - hit,
                    pl + hit, bucket, tab, plen,
                    self._block_pool.kv_pages(), start=pl,
                    kernel=self.paged_kernel)
            elif hit:
                gathered = self._block_pool.gather(
                    [nd.block for nd in hit_chain])
                pre = (concat_kv_prefix(self._prefix_cache, gathered)
                       if self.prefix else gathered)
                row_cache, _ = _prefill_suffix(
                    dec, pre, suffix, head_true - hit, pl + hit, bucket)
            elif self.prefix:
                row_cache, _ = _prefill_suffix(
                    dec, self._prefix_cache, suffix, head_true, pl, bucket)
            else:
                row_cache, _ = _prefill(dec, suffix, head_true, bucket)
            return self._radix.insert(head, row_cache, pl)
        finally:
            if hit_chain:
                self._radix.release(hit_chain)

    def handoff_export(self, tokens: list[int], from_depth: int = 0,
                       trace: tuple | None = None) -> dict:
        """`kv_handoff` export leg (prefill replica): ensure the radix
        tree holds the full usable block chain for ``tokens`` —
        prefilling the missing block-aligned region if needed — then
        encode depths [``from_depth``, want) as KVC1 blobs. ``want``
        always leaves ≥ 1 suffix token for the decode side's own
        admission prefill (the same cap `_admit` applies), so the first
        generated token's logits are computed there, token-exactly."""
        from idunno_tpu_torch.store.kv_chain import encode_block

        self._require_handoff()
        toks = [int(t) for t in tokens]
        bs = self.kv_block_size
        want = max(0, (len(toks) - 1) // bs)
        from_depth = max(0, int(from_depth))
        if want <= from_depth:
            return {"blobs": [], "depth": from_depth, "blocks": 0,
                    "bytes": 0, "block_size": bs}
        t0 = (self.spans.clock()
              if self.spans is not None and trace else None)
        head = toks[:want * bs]
        chain = self._radix.lookup(head)
        if len(chain) < want:
            chain = self._prefill_head(head, chain)
        else:
            self._radix.acquire(chain)
        try:
            if len(chain) < want:
                raise ValueError(
                    f"handoff export covered {len(chain)} of {want} "
                    "blocks (block pool exhausted; ship refused)")
            blobs, nbytes = [], 0
            for j in range(from_depth, want):
                chunk = head[j * bs:(j + 1) * bs]
                blob = encode_block(
                    {"tokens": chunk, "depth": j, "block_size": bs},
                    self._block_pool.read_block(chain[j].block))
                blobs.append(blob)
                nbytes += len(blob)
        finally:
            self._radix.release(chain)
        self._stats["kv_handoff_requests"] += 1
        self._stats["kv_handoff_bytes"] += nbytes
        if t0 is not None:
            self.spans.record(
                "lm.handoff_export", trace=trace[0], parent=trace[1],
                t_start=t0, attrs={"blocks": want - from_depth,
                                   "from_depth": from_depth,
                                   "bytes": nbytes})
        return {"blobs": blobs, "depth": from_depth,
                "blocks": want - from_depth, "bytes": nbytes,
                "block_size": bs}

    def handoff_adopt(self, tokens: list[int], blobs: list[bytes],
                      start_depth: int = 0,
                      trace: tuple | None = None) -> dict:
        """`kv_handoff` adopt leg (decode replica): decode each KVC1
        blob against the expected token chunk — ``expect_tokens=`` makes
        a stale/wrong-content blob a typed refusal, never a graft — and
        splice the verified blocks via `RadixPrefixCache.graft`, which
        REUSES chunks already held. A duplicated/replayed adopt therefore
        converges on the same block-pool state, and the next admission's
        radix lookup turns the shipped range into a prefix hit: zero
        re-prefill for shipped blocks, structurally."""
        from idunno_tpu_torch.store.kv_chain import decode_block

        self._require_handoff()
        toks = [int(t) for t in tokens]
        bs = self.kv_block_size
        start_depth = max(0, int(start_depth))
        t0 = (self.spans.clock()
              if self.spans is not None and trace else None)
        fetched, nbytes = [], 0
        for i, blob in enumerate(blobs):
            j = start_depth + i
            chunk = toks[j * bs:(j + 1) * bs]
            if len(chunk) < bs:
                raise ValueError(
                    f"handoff blob at depth {j} extends past the "
                    "prompt's full blocks")
            _, arrays = decode_block(blob, expect_tokens=chunk)
            fetched.append((chunk, arrays))
            nbytes += len(blob)
        wrote = self._radix.graft(toks, fetched, start_depth)
        self._stats["kv_handoff_bytes"] += nbytes
        depth = len(self._radix.lookup(toks))
        if t0 is not None:
            self.spans.record(
                "lm.handoff_adopt", trace=trace[0], parent=trace[1],
                t_start=t0, attrs={"blocks": len(fetched), "wrote": wrote,
                                   "start_depth": start_depth,
                                   "bytes": nbytes, "depth": depth})
        return {"adopted": len(fetched), "wrote": wrote,
                "depth": depth, "bytes": nbytes}

    def handoff_fallback(self) -> dict:
        """Count a ship that degraded to decode-side prefill (the
        manager's fallback transition); the request itself is unharmed —
        it forwards through the normal path and re-prefills there."""
        self._require_handoff()
        self._stats["kv_handoff_fallbacks"] += 1
        return {"fallbacks": self._stats["kv_handoff_fallbacks"]}

    # -- serving loop -----------------------------------------------------

    def _remaining_cursors(self) -> tuple[np.ndarray, np.ndarray]:
        """Host view of (remaining, cursors) — one transfer, cached until
        `_rc_invalidate` (every device-side mutation site)."""
        if self._rc_cache is None:
            self._rc_cache = torch.stack(
                [self._remaining, self._cursors]).cpu().numpy()
        return self._rc_cache[0], self._rc_cache[1]

    def _rc_invalidate(self) -> None:
        self._rc_cache = None

    def _retire_finished(self) -> None:
        if not self._live:
            return
        remaining, cursors = self._remaining_cursors()
        for slot in [s for s, r in enumerate(remaining)
                     if r == 0 and s in self._live]:
            req = self._live.pop(slot)
            total = int(cursors[slot]) + 1
            row = self._tokens[slot, :total].tolist()
            was_cancelled = req.id in self._cancelled
            self._cancelled.discard(req.id)
            lps = None
            if self.track_logprobs:
                lps = self._logprobs[slot, len(req.tokens):total].tolist()
            self._done.append(Completion(
                id=req.id, tokens=[int(t) for t in row],
                prompt_len=len(req.tokens),
                service_s=time.monotonic() - req.t_admit,
                cancelled=was_cancelled, logprobs=lps,
                cold_start=req.cold))
            if not was_cancelled:
                self._stats["completed"] += 1
            self._stats["tokens_generated"] += total - len(req.tokens)
            self._gens[slot] = None
            if self._radix is not None:       # unpin the request's chain
                chain = self._held.pop(req.id, None)
                if chain:
                    self._radix.release(chain)

    def _admit(self) -> None:
        if self._pending is not None:
            # a chunked prefill is in flight: admissions stay FIFO behind it
            return
        free = [s for s in range(self.slots) if s not in self._live]
        dev = self.device
        while free and self._queue:
            slot = free.pop(0)
            dec = self._row_dec(slot)
            req = self._queue.popleft()
            req.t_admit = time.monotonic()
            req.cold = not self._dispatched_ever
            t_prefill0 = (self.spans.clock()
                          if self.spans is not None and req.trace else None)
            per_req = list(req.tokens)      # pre-prefix request tokens
            suffix_true = len(per_req)
            pl = len(self.prefix) if self.prefix else 0
            # radix prefix cache: longest block-aligned cached chain,
            # capped one block short of the prompt so the suffix apply
            # always has ≥ 1 real token, and shrunk block by block until
            # prefix+hit+bucket fits max_len
            hit, hit_chain = 0, []
            if self._radix is not None:
                self._pc_lookups += 1
                hit_chain = self._radix.lookup(per_req)
                bs = self.kv_block_size
                want = (suffix_true - 1) // bs   # usable depth in blocks
                # cluster prefix cache: a local miss (or shorter local
                # hit) probes the store for a longer published chain and
                # grafts ONLY the missing block suffix into the radix
                # tree; the re-lookup then extends the hit so the prefill
                # covers just the remainder. Degrades to the local hit on
                # any store or transport failure.
                if (self.cluster_prefix is not None
                        and len(hit_chain) < want):
                    if self._cluster_fetch(per_req, len(hit_chain), want):
                        hit_chain = self._radix.lookup(per_req)
                hit = min(len(hit_chain) * bs,
                          ((suffix_true - 1) // bs) * bs)
            while True:
                rest = suffix_true - hit
                suffix_bucket = next(
                    (b for b in self.prompt_buckets
                     if b >= rest and pl + hit + b <= self.max_len), None)
                if suffix_bucket is not None:
                    break
                if hit <= 0:   # unreachable: validate()/__init__ checks
                    raise RuntimeError(
                        f"no prompt bucket fits {suffix_true} tokens")
                hit -= self.kv_block_size
            if hit:
                hit_chain = hit_chain[:hit // self.kv_block_size]
                # pin before use: a later insert's eviction must not
                # free these
                self._radix.acquire(hit_chain)
                self._pc_hits += 1
                self._pc_tokens_saved += hit
            elif hit_chain:
                hit_chain = []
            suffix = np.zeros((1, suffix_bucket), np.int64)
            suffix[0, :suffix_true - hit] = per_req[hit:]
            self._stats["prefill_tokens"] += suffix_bucket
            # paged pools never gather the hit back: the batch-1 table
            # lets the suffix attend the hit region through the blocks
            tab = plen = None
            if self._paged and hit:
                nb = hit // self.kv_block_size
                tab = torch.tensor([[nd.block for nd in hit_chain[:nb]]],
                                   dtype=torch.int32, device=dev)
                plen = torch.tensor([hit], dtype=torch.int32, device=dev)
            suffix_t = torch.from_numpy(suffix).to(dev)
            if self.prefill_chunk and suffix_bucket > self.prefill_chunk:
                # chunked prefill: park the admission as `_pending` and
                # apply `prefill_chunk` tokens per step() call, decode
                # steps of resident rows landing between chunks
                total = pl + hit + suffix_bucket
                if hit and tab is None:
                    gathered = self._block_pool.gather(
                        [nd.block for nd in hit_chain],
                        group=self._group(slot))
                    pre = (concat_kv_prefix(self._prefix_cache, gathered)
                           if self.prefix else gathered)
                else:   # paged hit (hit region stays zero) or no hit
                    pre = self._prefix_cache if self.prefix else None
                sp = None
                if t_prefill0 is not None:
                    sp = self.spans.start(
                        "lm.prefill", trace=req.trace[0],
                        parent=req.trace[1],
                        attrs={"id": req.id, "prompt_len": suffix_true,
                               "prefix_hit": hit,
                               "bucket": suffix_bucket, "chunked": True})
                    sp.t_start = t_prefill0
                self._pending = {
                    "req": req, "slot": slot,
                    "cache": _chunk_init(dec, pre, total), "dec": dec,
                    "suffix": suffix_t, "true": suffix_true - hit,
                    "suffix_true": suffix_true, "cursor0": pl + hit,
                    "bucket": suffix_bucket, "off": 0, "hit": hit,
                    "hit_chain": hit_chain, "per_req": per_req, "pl": pl,
                    "last": None, "total": total, "tables": tab,
                    "plen": plen, "span": sp, "chunks": 0}
                self._advance_prefill()   # first chunk lands this step
                return
            if hit and tab is not None:
                row_cache, last_logits = _prefill_suffix_paged(
                    dec, self._prefix_cache, suffix_t,
                    suffix_true - hit, pl + hit, suffix_bucket, tab, plen,
                    self._block_pool.kv_pages(), start=pl,
                    kernel=self.paged_kernel)
            elif hit:
                gathered = self._block_pool.gather(
                    [nd.block for nd in hit_chain], group=self._group(slot))
                pre = (concat_kv_prefix(self._prefix_cache, gathered)
                       if self.prefix else gathered)
                row_cache, last_logits = _prefill_suffix(
                    dec, pre, suffix_t, suffix_true - hit, pl + hit,
                    suffix_bucket)
            elif self.prefix:
                row_cache, last_logits = _prefill_suffix(
                    dec, self._prefix_cache, suffix_t, suffix_true,
                    pl, suffix_bucket)
            else:
                row_cache, last_logits = _prefill(
                    dec, suffix_t, suffix_true, suffix_bucket)
            self._finish_admission(
                req, slot, row_cache, last_logits, hit=hit,
                hit_chain=hit_chain, per_req=per_req, pl=pl,
                suffix_true=suffix_true, suffix_bucket=suffix_bucket,
                suffix=suffix, t_prefill0=t_prefill0)

    def _advance_prefill(self) -> None:
        """Apply ONE chunk of the pending chunked admission (once per
        `step`, before `_admit`), so every chunk of a long prompt has a
        decode dispatch of the resident rows between it and the next."""
        p = self._pending
        n = min(self.prefill_chunk, p["bucket"] - p["off"])
        tok = p["suffix"][:, p["off"]:p["off"] + n]
        cursor = p["cursor0"] + p["off"]
        logits = _prefill_chunk(
            p["dec"], p["cache"], tok, cursor, p["tables"], p["plen"],
            self._block_pool.kv_pages() if p["tables"] is not None else None,
            start=p["pl"], kernel=self.paged_kernel or "plain")
        # the first-token logits live at true-1 (suffix coordinates)
        t = p["true"]
        if p["off"] <= t - 1 < p["off"] + n:
            p["last"] = logits[0, t - 1 - p["off"]]
        p["chunks"] += 1
        self._stats["prefill_chunks"] += 1
        if p["span"] is not None:
            self.spans.record(
                "lm.prefill_chunk", trace=p["span"].trace_id,
                parent=p["span"].span_id,
                attrs={"id": p["req"].id, "chunk": p["chunks"] - 1,
                       "tokens": int(n)})
        p["off"] += n
        if p["off"] >= p["bucket"]:
            self._pending = None
            self._finish_admission(
                p["req"], p["slot"], p["cache"], p["last"], hit=p["hit"],
                hit_chain=p["hit_chain"], per_req=p["per_req"],
                pl=p["pl"], suffix_true=p["suffix_true"],
                suffix_bucket=p["bucket"], suffix=p["suffix"],
                open_span=p["span"], chunks=p["chunks"])

    def _finish_admission(self, req, slot: int, row_cache: dict,
                          last_logits: torch.Tensor, *, hit: int,
                          hit_chain: list, per_req: list, pl: int,
                          suffix_true: int, suffix_bucket: int, suffix,
                          t_prefill0=None, open_span=None,
                          chunks: int = 0) -> None:
        """Everything after the row cache exists: radix insert + pinning,
        paged table install, slot copy, per-slot sampler state, spans.
        Shared by the one-shot and chunked prefill paths."""
        dev = self.device
        if self._radix is not None:
            # seed/extend the tree from this prefill's row cache and pin
            # the request's full chain for its lifetime; the temporary hit
            # pins drop. On the paged path the hit region of the row cache
            # is zero — insert walks the existing (hit) nodes without
            # writing them.
            chain = self._radix.insert(per_req, row_cache, pl)
            if hit_chain:
                self._radix.release(hit_chain)
            if chain:
                self._held[req.id] = chain
            cp = self.cluster_prefix
            if (cp is not None and chain
                    and hit // self.kv_block_size >= cp.publish_min_hits):
                # publish the request's full chain: a local hit of at
                # least `publish_min_hits` blocks proved the prompt head
                # is shared (0 = publish every inserted chain). Content-
                # addressed names make a replayed publish converge, and
                # every failure degrades to a skip (cp.errors).
                cp.publish(per_req, len(chain),
                           lambda j: self._block_pool.read_block(
                               chain[j].block))
        if self._paged:
            nb = hit // self.kv_block_size
            tab = torch.zeros((self._max_chain,), dtype=torch.int32)
            if nb:
                tab[:nb] = torch.tensor([nd.block for nd in hit_chain[:nb]],
                                        dtype=torch.int32)
                self._stats["kv_gather_bytes_saved"] += (
                    nb * self._block_pool.bytes_per_block)
            self._tables[slot] = tab.to(dev)
            self._plens[slot] = hit
        if hit or self.prefix:
            # downstream state sees the FULL prompt
            prompt = np.zeros((pl + hit + suffix_bucket,), np.int64)
            if self.prefix:
                prompt[:pl] = self.prefix
                req = dataclasses.replace(req, tokens=self.prefix + per_req)
            prompt[pl:pl + suffix_true] = per_req
            true_len = pl + suffix_true
        else:
            prompt = np.zeros((suffix_bucket,), np.int64)
            prompt[:suffix_true] = per_req
            true_len = suffix_true
        bucket = len(prompt)
        gen = None
        if req.temperature > 0.0:
            seed = req.id if req.seed is None else req.seed
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        first = pick_token(last_logits, req.temperature, gen, req.top_p,
                           req.top_k)
        # insert: prompt tokens, the first generated token, the row cache
        self._tokens[slot, :bucket] = torch.from_numpy(prompt).to(dev)
        self._tokens[slot, true_len] = first
        _insert_cache(self._cache, row_cache, slot)
        if self._draft_model is not None:
            # the draft needs the FULL request prompt through its own
            # weights (a radix hit only covers the target's cache)
            dbucket = next(b for b in self.prompt_buckets
                           if b >= suffix_true)
            dsuffix = torch.zeros((1, dbucket), dtype=torch.int64)
            dsuffix[0, :suffix_true] = torch.tensor(per_req)
            dsuffix = dsuffix.to(dev)
            ddec = self._draft_row_dec(slot)
            if self.prefix:
                drow, _ = _prefill_suffix(
                    ddec, self._draft_prefix_cache, dsuffix, suffix_true, pl,
                    dbucket)
            else:
                drow, _ = _prefill(ddec, dsuffix, suffix_true, dbucket)
            _insert_cache(self._draft_cache, drow, slot)
        self._cursors[slot] = true_len
        self._temps[slot] = req.temperature
        self._top_ps[slot] = req.top_p
        self._top_ks[slot] = req.top_k
        self._gens[slot] = gen
        if self.track_logprobs:   # the prefill-picked token's logprob
            self._logprobs[slot, true_len] = token_logprob(last_logits,
                                                           first)
        if self.penalties:   # fresh row; the first token counts
            self._pres[slot] = req.presence_penalty
            self._freq[slot] = req.frequency_penalty
            self._counts[slot] = 0
            self._counts[slot, first] = 1
        rem = req.max_new - 1
        if self.eos_id is not None and first == self.eos_id:
            rem = 0                   # the prompt's very next token
        self._remaining[slot] = rem
        self._rc_invalidate()
        if open_span is not None:
            # chunked path: close the span opened at admission
            sp = self.spans.finish(open_span, chunks=chunks)
            req = dataclasses.replace(req, trace=(req.trace[0], sp.span_id))
        elif t_prefill0 is not None:
            sp = self.spans.record(
                "lm.prefill", trace=req.trace[0], parent=req.trace[1],
                t_start=t_prefill0,
                attrs={"id": req.id, "prompt_len": suffix_true,
                       "prefix_hit": hit, "bucket": suffix_bucket})
            # decode-step spans chain under the prefill
            req = dataclasses.replace(req, trace=(req.trace[0], sp.span_id))
        self._live[slot] = req
        self._stats["admitted"] += 1

    def _apply_stops(self) -> None:
        """Host-side stop-sequence pass (after a dispatch, before
        retirement): truncate each live row at the earliest-ending match
        in its GENERATED tokens (the stop sequence is kept), moving its
        cursor back and zeroing its budget. Each pass scans only what one
        dispatch can have added, plus a max-seq-1 overlap."""
        stops = {slot: req.stop for slot, req in self._live.items()
                 if req.stop}
        if not stops:
            return
        bound = self.decode_steps * (
            self.draft_len + 1 if self._draft_model is not None else 1)
        cursors = self._remaining_cursors()[1]
        for slot, seqs in stops.items():
            gen_start = len(self._live[slot].tokens)
            end = int(cursors[slot]) + 1
            overlap = max(len(q) for q in seqs) - 1
            # bound + 1: the first post-admission dispatch has bound+1
            # unscanned tokens (the admission-picked token plus `bound`)
            lo = max(gen_start, end - bound - 1 - overlap)
            row = self._tokens[slot, :end].tolist()
            best = None                      # earliest END of any match
            for seq in seqs:
                n = len(seq)
                for at in range(lo, end - n + 1):
                    if row[at:at + n] == list(seq):
                        best = at + n if best is None else min(best, at + n)
                        break
            if best is None:
                continue
            self._cursors[slot] = best - 1
            self._remaining[slot] = 0
            self._rc_invalidate()

    def _decode(self) -> None:
        """One decode dispatch: ``decode_steps`` model steps (speculative
        pools: rounds) for all slots, the state updated in place. On a
        graph pool a dispatch in which no live row samples replays the
        captured graph; the first such dispatch runs eagerly on a side
        stream (building the kernels) and is then captured. A dispatch in
        which a live row samples runs eagerly, each sampled row drawing
        from its own generator."""
        sampled = sorted(s for s, r in self._live.items()
                         if r.temperature > 0.0)
        if self.decode_graph == "graph" and not sampled:
            if self._replay is not None:
                self._replay.graph.replay()
                for fn, n in self._replay.launches.items():
                    fn.launches += n
                self._dispatch_counts["replayed"] += 1
                return
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._dispatch(())
            cur.wait_stream(side)
            self._replay = self._capture()
        else:
            self._dispatch(sampled)
        self._dispatch_counts["eager"] += 1

    def _capture(self) -> _Replay:
        """Record the all-greedy dispatch as one CUDA graph (nothing runs:
        the state is untouched). The counted wrappers' launches made while
        recording are taken back and added on each replay instead. A body
        that fails to record (one that syncs the host, say) raises, after
        `_abandon_capture` has put the process back out of capture."""
        dev = self.device
        before = {fn: fn.launches for fn in _COUNTED}
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.current_stream(dev)
        # thread_local: the serving loop's other threads may touch the
        # card while this one records
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self._dispatch(())
        except BaseException:
            for fn in _COUNTED:
                fn.launches = before[fn]
            _abandon_capture(dev, pool, stream)
            raise
        launches = {}
        for fn in _COUNTED:
            launches[fn] = fn.launches - before[fn]
            fn.launches = before[fn]
        return _Replay(graph, launches,
                       torch.cuda.memory_reserved(dev) - reserved)

    def _dispatch(self, sampled: list[int] | tuple) -> None:
        """The body of one dispatch, eager or being recorded. ``sampled``
        lists the live rows that sample (empty in a recorded dispatch)."""
        ctx = None
        if self._paged:
            ctx = _make_paged_ctx(self._block_pool.kv_pages(), self._tables,
                                  self._plens, self._pl_static,
                                  self.paged_kernel)
        filtered = any(self._live[s].top_p < 1.0 or self._live[s].top_k > 0
                       for s in sampled)
        for _ in range(self.decode_steps):
            if self._draft_model is not None:
                self._spec_round(ctx, sampled, filtered)
                continue
            tok = self._tokens.gather(1, self._cursors[:, None])
            logits = decode_apply(self._dec, self._cache, tok,
                                  self._cursors, paged=ctx)
            _, cursors, remaining, _, _ = fused_decode_tail(
                logits[:, 0], self._tokens, self._cursors, self._remaining,
                self._temps, self._top_ps, self._top_ks, self._gens,
                self._logprobs, self._pres, self._freq, self._counts,
                max_len=self.max_len, eos_id=self.eos_id,
                track=self.track_logprobs, pen=self.penalties,
                sampled=sampled, filtered=filtered)
            # tokens, logprobs and counts were written in place; the
            # graph's fixed buffers take the new cursors and budgets
            self._cursors.copy_(cursors)
            self._remaining.copy_(remaining)

    def _sample_probs(self, logits: torch.Tensor, rows: list[int],
                      filtered: bool) -> torch.Tensor:
        """The sampling distribution of slots ``rows`` from their logits
        ``[R, n, V]``: temperature-scaled softmax, top-k/top-p filtered
        where the row asks for it (per row, as the JAX round selects)."""
        scaled = logits / torch.clamp_min(self._temps[rows], 1e-6)[:, None,
                                                                   None]
        probs = torch.softmax(scaled, dim=-1)
        if not filtered:
            return probs
        top_ps, top_ks = self._top_ps[rows][:, None], self._top_ks[rows][:, None]
        return torch.where(filter_on(top_ps, top_ks)[..., None],
                           filtered_probs(scaled, top_ps, top_ks), probs)

    def _spec_round(self, ctx: PagedContext | None, sampled: list[int] | tuple,
                    filtered: bool) -> None:
        """One speculative round for all slots, in place:

          1. the draft runs ``draft_len`` single-token steps → proposals
             (greedy rows: argmax; sampled rows: a draw from the draft's
             temperature-scaled, filtered distribution), through its
             `ShardedLM` under a mesh (a routed draft: itself);
          2. the target verifies committed-last + all proposals in ONE
             chunked per-row apply (``draft_len + 1`` positions; under a
             mesh through its `ShardedLM`, K3 per shard on a paged pool);
          3. `greedy_commit` (no live row samples) or `spec_commit`, the
             EOS cut, and the token and logprob writes.

        Rejected positions leave stale K/V in both caches strictly past
        the new cursors; they are overwritten when those positions are
        really ingested. Retired rows idle: their writes land past their
        final cursor and their state is gated on ``remaining > 0``."""
        gamma = self.draft_len
        tokens, cursors, remaining = self._tokens, self._cursors, self._remaining
        dev = tokens.device
        active = remaining > 0
        prev = tokens.gather(1, cursors[:, None])[:, 0]            # [S]
        gens = [self._gens[r] for r in sampled]

        props, qrows = [], []
        tok, dcur = prev, cursors
        for _ in range(gamma):
            dl = decode_apply(self._draft_dec, self._draft_cache,
                              tok[:, None], dcur)[:, 0]            # [S, V]
            nxt = _argmax(dl)
            if sampled:
                q = self._sample_probs(_whole(dl, dev)[sampled][:, None],
                                       sampled, filtered)[:, 0]
                nxt[sampled] = draw_sampled(q, gens)
                qrows.append(q)
            props.append(nxt)
            tok, dcur = nxt, dcur + 1
        proposals = torch.stack(props, dim=1)                      # [S, γ]

        tin = torch.cat([prev[:, None], proposals], dim=1)         # [S, γ+1]
        logits = decode_apply(self._dec, self._cache, tin, cursors,
                              paged=ctx)                           # f32
        tpred = _argmax(logits)                                    # [S, γ+1]
        if sampled or self.track_logprobs:
            logits = _whole(logits, dev)

        if sampled:
            s, v = logits.shape[0], logits.shape[-1]
            qdist = logits.new_zeros((s, gamma, v))
            qdist[sampled] = torch.stack(qrows, dim=1)
            pdist = logits.new_zeros(logits.shape)
            pdist[sampled] = self._sample_probs(logits[sampled], sampled,
                                                filtered)
            u = logits.new_zeros((s, gamma))
            u[sampled] = torch.stack([
                torch.rand(gamma, generator=g, device=dev) for g in gens])
            mask = torch.zeros(s, dtype=torch.bool, device=dev)
            mask[sampled] = True
            cand, acc = spec_commit(proposals, qdist, pdist, tpred, mask, u,
                                    self._gens)
        else:
            cand, acc = greedy_commit(proposals, tpred)

        jidx = torch.arange(gamma + 1, device=dev)[None, :]
        commit = torch.minimum(acc + 1, remaining)        # ≥ 1 when active
        if self.eos_id is not None:
            hit = (cand == self.eos_id) & (jidx < commit[:, None])
            any_eos = hit.any(dim=1)
            eos_pos = hit.to(torch.int8).argmax(dim=1)
            commit = torch.where(any_eos, eos_pos + 1, commit)
            rem_after = torch.where(any_eos, torch.zeros_like(remaining),
                                    remaining - commit)
        else:
            rem_after = remaining - commit
        wpos = torch.clamp(cursors[:, None] + 1 + jidx, 0, self.max_len - 1)
        keep = (jidx < commit[:, None]) & active[:, None]
        tokens.scatter_(1, wpos, torch.where(keep, cand.to(tokens.dtype),
                                             tokens.gather(1, wpos)))
        if self.track_logprobs:
            # the RAW model distribution, as the plain decode tail reports
            shifted = logits - logits.amax(dim=-1, keepdim=True)
            lse = torch.log(torch.exp(shifted).sum(dim=-1))
            lp = torch.gather(shifted, 2, cand[..., None])[..., 0] - lse
            self._logprobs.scatter_(1, wpos, torch.where(
                keep, lp, self._logprobs.gather(1, wpos)))
        self._cursors.copy_(torch.where(active, cursors + commit, cursors))
        self._remaining.copy_(torch.where(active, rem_after, remaining))

    @torch.no_grad()
    def step(self) -> int:
        """Retire finished rows, admit queued prompts into free slots, run
        one decode dispatch (``decode_steps`` tokens for every live row).
        Returns live rows + still-queued requests — 0 means drained."""
        self._retire_finished()
        if self._pending is not None:
            # one chunk of the in-flight long admission, THEN the decode
            # dispatch below — resident rows advance between chunks
            self._advance_prefill()
        self._admit()
        self._retire_finished()           # max_new == 1 admissions
        if self._live:
            t_step0 = (self.spans.clock() if self.spans is not None
                       and any(r.trace for r in self._live.values())
                       else None)
            self._decode()
            self._stats["dispatches"] += 1
            self._dispatched_ever = True
            if t_step0 is not None:
                batch = len(self._live)
                for req in self._live.values():
                    if req.trace:
                        self.spans.record(
                            "lm.decode_step", trace=req.trace[0],
                            parent=req.trace[1], t_start=t_step0,
                            attrs={"id": req.id, "batch": batch})
            self._rc_invalidate()         # the dispatch advanced the rows
            self._apply_stops()
            self._retire_finished()
        return (len(self._live) + len(self._queue)
                + (1 if self._pending is not None else 0))

    def run_until_drained(self, max_steps: int = 10_000) -> list[Completion]:
        """Drive `step` until queue and slots are empty; returns every
        completion (including earlier un-polled ones)."""
        for _ in range(max_steps):
            if self.step() == 0:
                break
        else:
            raise RuntimeError(f"not drained after {max_steps} steps")
        self._retire_finished()
        return self.poll()

    def warmup(self) -> float:
        """Run one throwaway request through prefill, insert and a decode
        dispatch BEFORE serving traffic (the first launches build the CUDA
        kernels); returns the wall seconds spent. Afterwards request ids
        restart at 0 and the stats and prefix-cache counters re-zero.
        Call only on an idle pool."""
        if self._queue or self._live:
            raise RuntimeError("warmup() needs an idle pool")
        toks = [t % self.model.vocab for t in (1, 2, 3)][:self.prompt_len]
        headroom = (self.draft_len + 1 if self._draft_model is not None
                    else 0)
        pl = len(self.prefix) if self.prefix else 0
        max_new = max(1, min(self.decode_steps + 1,
                             self.max_len - pl - len(toks) - headroom))
        t0 = time.perf_counter()
        self.submit(toks, max_new=max_new)
        self.run_until_drained()
        warm_s = time.perf_counter() - t0
        self._next_id = 0
        for k in self._stats:
            self._stats[k] = 0
        self._pc_lookups = self._pc_hits = self._pc_tokens_saved = 0
        if self.cluster_prefix is not None:
            self.cluster_prefix.reset_counters()
        return warm_s
