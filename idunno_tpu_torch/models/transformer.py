"""Causal transformer LM with pluggable attention, in PyTorch.

A port of ``idunno_tpu/models/transformer.py``: ``rope``,
``MultiHeadAttention`` (GQA, the int8 KV cache, scalar and per-row decode
cursors, the paged split with its merge), ``Block`` (a dense MLP or a
pluggable FFN), ``TransformerLM`` (``ffn_factory``/``ffn_every``, the
routed FFN of ``models/moe.py``; ``remat``), ``make_attn_fn`` and
``decode_apply``. Parameter names follow the flax
tree (``models/convert.py:lm_state_dict_from_flax`` carries the JAX
package's weights across).

Two ways through the model:

- the full forward, ``model(tokens)``: attention through ``attn_fn`` —
  the hand-written CUDA flash kernels on a card (K2 forward, K4/K5
  backward when training), the plain reference attention on the CPU
  (``make_attn_fn("auto")``);
- the cached decode step, ``decode_apply(model, cache, tokens, cursors,
  paged)``: single tokens or chunks against a depth-stacked KV cache
  ``{"cached_k": [L, S, T, KVH, D], ...}`` (the JAX package's scanned
  layout), written in place. ``cursors`` is an int (the scalar cursor:
  every row at the same depth, chunked prefill) or an int64 [S] tensor
  (per-row cursors: continuous batching). Cursors are owned by the caller
  and never advanced here.

Mixed precision follows flax's ``dtype``/``param_dtype``: the parameters
keep their dtype (f32 master weights in training) while the activations
run in ``compute_dtype`` (bf16 on the card). ``Dense`` casts its weight
and bias to the activations' dtype before the product; the embedding is
gathered from the table and then cast (the same values as flax's cast of
the table, and an f32 gradient sum); ``LayerNorm`` keeps its statistics
in f32 and returns the activations' dtype; the residual stream and the
block outputs stay in the compute dtype; the logits are cast to f32.
``torch.autocast`` would differ: it runs LayerNorm and softmax-like ops
in f32 and returns their f32 outputs, so the residual stream turns f32
after the first block, and it decides per op rather than per module, so
it would not reproduce the JAX model's bf16 block outputs. The port does
not use it.
"""
from __future__ import annotations

import copy
import dataclasses
from collections.abc import Callable
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from idunno_tpu_torch.models.mixed import Dense
from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.ops.paged_attention import (PagedContext,
                                                  merge_attention,
                                                  paged_attention_grouped)
from idunno_tpu_torch.ops.sampling import VocabShards

AttnFn = Callable[..., torch.Tensor]     # (q, k, v, *, causal) -> out

# cache leaves that carry per-token K/V state (int8 caches add scales)
KV_LEAF_KEYS = ("cached_k", "cached_v", "k_scale", "v_scale")
LN_EPS = 1e-6                            # flax LayerNorm's epsilon


def auto_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False) -> torch.Tensor:
    """The flash kernel on a CUDA tensor, the plain reference attention on
    the CPU (what ``make_attn_fn("auto")`` returns)."""
    if q.device.type == "cuda":
        from idunno_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    return full_attention(q, k, v, causal=causal)


def make_attn_fn(kind: str = "auto", *, mesh=None, axis: str = "data",
                 **kw) -> AttnFn:
    """One knob for the attention family:

      full    — the plain reference attention (``ops/attention.py``)
      flash   — the CUDA flash kernels, trainable
                (``ops/flash_attention.py``: K2 forward, K4/K5 backward
                through ``FlashAttention``)
      auto    — flash on a CUDA tensor, full on the CPU
      ring, ulysses — sequence parallelism: not ported yet, they raise

    The CUDA kernel has fixed 64 x 64 tiles, so no kind takes kwargs."""
    del axis
    if kind in ("ring", "ulysses"):
        raise ValueError(f"attn kind {kind!r} comes with the parallelism "
                         "slice (ROADMAP.md, modules item 10)")
    if mesh is not None:
        raise ValueError(f"attn kind {kind!r} ignores mesh; sequence "
                         "parallelism is not ported yet")
    if kw:
        raise TypeError(f"attn kind {kind!r} takes no kwargs, got {kw}")
    if kind == "full":
        return full_attention
    if kind == "flash":
        from idunno_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention
    if kind == "auto":
        return auto_attention
    raise ValueError(f"unknown attention kind {kind!r}; "
                     "want auto|full|flash|ring|ulysses")


_FREQS: dict = {}


def _rope_freqs(half: int, base: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies ``base^(-i/half)``, made once per (half,
    base, device) and kept: made from a host scalar, they would copy it to
    the card on every call, which a CUDA-graph capture refuses."""
    key = (half, base, device)
    freqs = _FREQS.get(key)
    if freqs is None:
        freqs = torch.pow(
            torch.tensor(base, dtype=torch.float32, device=device),
            -torch.arange(0, half, dtype=torch.float32, device=device) / half)
        _FREQS[key] = freqs
    return freqs


def rope(x: torch.Tensor, *, base: float = 10000.0,
         positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary embedding over [B, T, H, D] rotating halves; ``positions``
    overrides the default 0..T-1 — shape [T] (shared across the batch) or
    [B, T] (per-row positions, continuous-batching decode)."""
    b, t, h, d = x.shape
    half = d // 2
    freqs = _rope_freqs(half, base, x.device)
    if positions is None:
        positions = torch.arange(t, dtype=torch.float32, device=x.device)
    angles = positions.to(torch.float32)[..., None] * freqs   # [..., half]
    if angles.dim() == 2:                        # [T, half] → [1, T, half]
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]       # [1|B, T, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim: [.., kv_heads, d] → (int8 values,
    f32 scale [.., kv_heads])."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    vals = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return vals.to(torch.int8), s


def _softmax_parts(scores: torch.Tensor):
    """(max, exp(s - max), sum) over the last axis, spelled out so the
    dense and the paged decode branches share one arithmetic: a row whose
    paged chain is empty reproduces the dense branch bit for bit."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return m, p, p.sum(dim=-1, keepdim=True)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that normalizes in its parameters' dtype and
    returns the input's (flax ``LayerNorm``: f32 statistics, output in the
    compute dtype). f32 parameters under bf16 compute normalize in f32;
    bf16 parameters take PyTorch's bf16 kernel, which keeps its statistics
    and scale in f32 and rounds once, as flax does, with no cast launches
    (casting every input to f32 cost a bf16 forward 100 launches and 6%
    of its device time, PERF.md §6)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache: dict, cursors, paged: PagedContext | None = None,
                     *, kv_cache_dtype: str = "native", use_rope: bool = True,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The cached attention of one decode step, between the projections:
    ``q`` [B, t, H, D] and the step's ``k``/``v`` [B, t, KVH, D] (H a
    multiple of KVH) against one layer's cache ``{"cached_k": [B, T_max,
    KVH, D], ...}``, written in place. Returns [B, t, H, D] in
    ``out_dtype`` (default ``q``'s). `MultiHeadAttention.decode_step`
    runs it on all heads; a tensor-parallel shard (`ShardedLM`) on its own
    heads and its cache's KV heads. The cursor shapes, the overflow
    poisoning and the paged split are `MultiHeadAttention.decode_step`'s."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if kv_cache_dtype not in ("native", "int8"):
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: "
                         "want native|int8")
    quant = kv_cache_dtype == "int8"
    b, t, h, d = q.shape
    kvh = k.shape[2]
    ck, cv = cache["cached_k"], cache["cached_v"]
    ks = cache.get("k_scale")
    vs = cache.get("v_scale")
    max_len = ck.shape[1]
    dev = q.device
    if isinstance(cursors, torch.Tensor) and cursors.dim() == 1:
        i = cursors.to(dev)
        pos_bt = i[:, None] + torch.arange(t, device=dev)[None, :]
        overflow = i + t > max_len                      # [B]
        if use_rope:
            p = pos_bt.to(torch.float32)
            q, k = rope(q, positions=p), rope(k, positions=p)
        slot = torch.clamp(pos_bt, 0, max_len - 1)      # [B, t]
        rows = torch.arange(b, device=dev)[:, None]
        if quant:
            (k_st, k_sc), (v_st, v_sc) = _q8(k), _q8(v)
        else:
            k_st, v_st = k, v
        # overflow gating on the VALUES: an overflowing row writes its
        # old cache entries back (a no-op)
        ovr = overflow[:, None, None, None]
        ck[rows, slot] = torch.where(ovr, ck[rows, slot], k_st.to(ck.dtype))
        cv[rows, slot] = torch.where(ovr, cv[rows, slot], v_st.to(cv.dtype))
        if quant:
            ovr_s = overflow[:, None, None]
            ks[rows, slot] = torch.where(ovr_s, ks[rows, slot], k_sc)
            vs[rows, slot] = torch.where(ovr_s, vs[rows, slot], v_sc)
        ax = torch.arange(max_len, device=dev)[None, None, :]
        live = ax <= pos_bt[:, :, None]                 # [B, t, T]
        if paged is not None:
            start = paged.start
            live = live & ~((ax >= start)
                            & (ax < start + paged.lengths.to(dev)
                               .long()[:, None, None]))
        mask = live[:, None]                            # [B, 1, t, T]
        poison = overflow[:, None, None, None, None]
    else:
        i = int(cursors)
        pos = (i + torch.arange(t, device=dev)).to(torch.float32)
        overflow = i + t > max_len
        if use_rope:
            q, k = rope(q, positions=pos), rope(k, positions=pos)
        if quant:
            (k_st, k_sc), (v_st, v_sc) = _q8(k), _q8(v)
        else:
            k_st, v_st = k, v
        if not overflow:
            ck[:, i:i + t] = k_st.to(ck.dtype)
            cv[:, i:i + t] = v_st.to(cv.dtype)
            if quant:
                ks[:, i:i + t] = k_sc
                vs[:, i:i + t] = v_sc
        ax = torch.arange(max_len, device=dev)[None, :]
        live = ax <= (i + torch.arange(t, device=dev))[:, None]  # [t, T]
        if paged is not None:
            # batch-1 in the scalar-cursor shape: one chain length
            start = paged.start
            live = live & ~((ax >= start)
                            & (ax < start + paged.lengths.to(dev)
                               .long()[0]))
        mask = live[None, None]
        poison = overflow
    # grouped attention against the (possibly narrower) cache: query
    # heads reshape to [.., kv_heads, group, d]; no repeat of the cache
    group = h // kvh
    new_k, new_v = ck, cv
    if quant:
        new_k = ck.to(torch.float32) * ks[..., None]
        new_v = cv.to(torch.float32) * vs[..., None]
    q5 = q.reshape(b, t, kvh, group, d)
    scores = torch.einsum("bqhgd,bthd->bhgqt", q5.to(torch.float32),
                          new_k.to(torch.float32)) / (d ** 0.5)
    mask = mask[:, :, None]          # broadcast over the group axis
    if isinstance(poison, torch.Tensor):
        scores = torch.where(poison, torch.full_like(scores, float("nan")),
                             scores)
    elif poison:
        scores = torch.full_like(scores, float("nan"))
    scores = torch.where(mask, scores,
                         torch.full_like(scores, float("-inf")))
    m_l, p_l, l_l = _softmax_parts(scores)
    # normalize BEFORE the value product in both branches
    o_l = torch.einsum("bhgqt,bthd->bqhgd", p_l / l_l,
                       new_v.to(torch.float32))
    if paged is None:
        out = o_l.to(out_dtype)
    else:
        lse_l = (m_l + torch.log(l_l))[..., 0].permute(0, 3, 1, 2)
        o_p, lse_p = paged_attention_grouped(
            q5.to(torch.float32), paged.k_pages, paged.v_pages,
            paged.tables, paged.lengths,
            k_scale_pages=paged.k_scale_pages,
            v_scale_pages=paged.v_scale_pages, kernel=paged.kernel)
        out = merge_attention(o_l, lse_l, o_p, lse_p).to(out_dtype)
    return out.reshape(b, t, h, d)


class MultiHeadAttention(nn.Module):
    """Pluggable-kernel attention; ``decode_step`` is the KV-cached
    serving path. ``num_kv_heads`` < num_heads is grouped-query attention:
    the decode cache holds ``num_kv_heads`` heads; the full forward repeats
    K/V up to the query heads so every ``attn_fn`` runs unchanged.
    ``kv_cache_dtype="int8"`` stores K/V as symmetric per-(row, position,
    head) int8 with f32 scales."""

    def __init__(self, dim: int, num_heads: int,
                 num_kv_heads: int | None = None, causal: bool = True,
                 attn_fn: AttnFn = full_attention, use_rope: bool = True,
                 kv_cache_dtype: str = "native") -> None:
        super().__init__()
        kv = num_heads if num_kv_heads is None else num_kv_heads
        if kv < 1:
            raise ValueError(f"num_kv_heads {kv} must be >= 1 "
                             "(1 = MQA; None = MHA)")
        if num_heads % kv:
            raise ValueError(f"num_heads {num_heads} must be a multiple of "
                             f"num_kv_heads {kv}")
        self.dim, self.num_heads, self.kv_heads = dim, num_heads, kv
        self.head_dim = dim // num_heads
        self.causal, self.attn_fn, self.use_rope = causal, attn_fn, use_rope
        self.kv_cache_dtype = kv_cache_dtype
        hd = self.head_dim
        self.q = Dense(dim, num_heads * hd)
        self.k = Dense(dim, kv * hd)
        self.v = Dense(dim, kv * hd)
        self.out = Dense(num_heads * hd, dim)
        # flax's DenseGeneral layouts of q/k/v (kernel [dim, heads, hd],
        # bias [heads, hd]), by which int8 weights are grouped
        # (ops/quantize.py)
        for proj, heads in ((self.q, num_heads), (self.k, kv), (self.v, kv)):
            proj.flax_views = {"weight": ((heads, hd, dim), 1),
                               "bias": ((heads, hd), 1)}

    def _qkv(self, x):
        b, t, _ = x.shape
        hd = self.head_dim
        return (self.q(x).view(b, t, self.num_heads, hd),
                self.k(x).view(b, t, self.kv_heads, hd),
                self.v(x).view(b, t, self.kv_heads, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        q, k, v = self._qkv(x)
        if self.use_rope:
            q, k = rope(q), rope(k)
        if self.kv_heads != self.num_heads:
            rep = self.num_heads // self.kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = self.attn_fn(q, k, v, causal=self.causal)
        return self.out(out.reshape(b, t, self.num_heads * self.head_dim))

    def decode_step(self, x: torch.Tensor, cache: dict, cursors,
                    paged: PagedContext | None = None) -> torch.Tensor:
        """Autoregressive serving against this layer's KV cache
        (``cache[name]`` [B, T_max, KVH, D], scales [B, T_max, KVH]),
        written in place — three shapes:

        scalar cursor (int), t=1: one token in, one out;
        scalar cursor, t>1: chunked prefill — K/V written at
          cursor..cursor+t-1, causal within the chunk;
        per-row cursors (int64 [B]): continuous batching — row r writes
          K/V at cursors[r]..cursors[r]+t-1.

        A row that would write past T_max keeps its cache intact and gets
        NaN scores, so misuse is loud. ``paged`` splits the key space:
        cache positions [start, start + lengths[r]) of row r are excluded
        from the local mask and served from the block pool through the
        block table instead; the two normalized partials merge exactly via
        their log-sum-exps (`merge_attention`)."""
        if not self.causal:
            raise ValueError("decode requires causal=True (autoregressive "
                             "serving of a bidirectional model would "
                             "silently change its semantics)")
        b, t, _ = x.shape
        q, k, v = self._qkv(x)
        out = decode_attention(q, k, v, cache, cursors, paged,
                               kv_cache_dtype=self.kv_cache_dtype,
                               use_rope=self.use_rope, out_dtype=x.dtype)
        return self.out(out.reshape(b, t, self.num_heads * self.head_dim))


class Block(nn.Module):
    """Pre-LN block: attention and a GELU (tanh) MLP, flax epsilon. ``ffn``
    replaces the dense MLP with another FFN module (a routed one,
    ``models/moe.py:SwitchFFN``), stored under the name ``ffn`` as the JAX
    block stores it."""

    def __init__(self, dim: int, num_heads: int,
                 num_kv_heads: int | None = None, mlp_ratio: int = 4,
                 causal: bool = True, attn_fn: AttnFn = full_attention,
                 use_rope: bool = True, kv_cache_dtype: str = "native",
                 ffn: nn.Module | None = None) -> None:
        super().__init__()
        self.ln1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads,
                                       num_kv_heads=num_kv_heads,
                                       causal=causal, attn_fn=attn_fn,
                                       use_rope=use_rope,
                                       kv_cache_dtype=kv_cache_dtype)
        self.ln2 = LayerNorm(dim, eps=LN_EPS)
        self.ffn = ffn
        if ffn is None:
            self.mlp_up = Dense(dim, dim * mlp_ratio)
            self.mlp_down = Dense(dim * mlp_ratio, dim)

    def _mlp(self, x):
        if self.ffn is not None:
            return self.ffn(x)
        return self.mlp_down(F.gelu(self.mlp_up(x), approximate="tanh"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self._mlp(self.ln2(x))

    def decode(self, x: torch.Tensor, cache: dict, cursors,
               paged: PagedContext | None = None) -> torch.Tensor:
        x = x + self.attn.decode_step(self.ln1(x), cache, cursors, paged)
        return x + self._mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """Minimal causal LM (the JAX package's ``TransformerLM``). ``dtype`` is
    the parameters' dtype; ``compute_dtype`` the activations' (flax's
    ``dtype``), by default ``None``: the parameters' dtype. The logits come
    out in f32.

    ``ffn_factory`` (``make(dim) -> nn.Module``, e.g.
    ``models/moe.py:switch_ffn_factory``) swaps the dense MLP for another
    FFN on every ``ffn_every``-th block, counting from the last block
    backwards (the Switch-Transformer interleave: the last block always
    has it); the remaining blocks keep the dense MLP. ``remat`` recomputes
    each block's activations in the backward pass instead of storing
    them (``torch.utils.checkpoint``; flax's ``nn.remat``): the same
    values, activation memory O(T·d) instead of O(depth·T·d), at about a
    third more FLOPs."""

    def __init__(self, vocab: int = 1024, dim: int = 128, depth: int = 2,
                 num_heads: int = 4, num_kv_heads: int | None = None,
                 causal: bool = True, attn_fn: AttnFn = full_attention,
                 ffn_factory: Callable[[int], nn.Module] | None = None,
                 ffn_every: int = 1, kv_cache_dtype: str = "native",
                 remat: bool = False, dtype: torch.dtype = torch.float32,
                 compute_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        if ffn_every < 1:
            raise ValueError(f"ffn_every={ffn_every}: must be >= 1")
        self._compute_dtype = compute_dtype
        self.vocab, self.dim, self.depth = vocab, dim, depth
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.causal, self.kv_cache_dtype = causal, kv_cache_dtype
        self.ffn_factory, self.ffn_every = ffn_factory, ffn_every
        self.remat = remat
        self.embed = nn.Embedding(vocab, dim)
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, num_kv_heads=num_kv_heads, causal=causal,
                  attn_fn=attn_fn, kv_cache_dtype=kv_cache_dtype,
                  ffn=(ffn_factory(dim) if ffn_factory is not None
                       and (depth - 1 - i) % ffn_every == 0 else None))
            for i in range(depth))
        self.ln_f = LayerNorm(dim, eps=LN_EPS)
        self.head = Dense(dim, vocab)
        self.to(dtype)

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype; follows ``model.to(...)``. Read from a
        LayerNorm, which int8 quantization leaves dense."""
        return self.ln_f.weight.dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        """The activations' (and so the KV cache's) dtype."""
        return self._compute_dtype or self.dtype

    def set_attn_fn(self, attn_fn: AttnFn) -> "TransformerLM":
        """Swap the full forward's attention kernel in place."""
        for blk in self.blocks:
            blk.attn.attn_fn = attn_fn
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens).to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            # the model draws no random numbers: no RNG state to stash
            x = (checkpoint(blk, x, use_reentrant=False,
                            preserve_rng_state=False) if remat else blk(x))
        return self.head(self.ln_f(x)).to(torch.float32)


def decode_apply(model: TransformerLM, cache: dict, tokens: torch.Tensor,
                 cursors, paged: PagedContext | None = None) -> torch.Tensor:
    """THE decode-step entry point: ``tokens`` [B, t] against the
    depth-stacked ``cache`` (written in place) from ``cursors`` (int or
    int64 [B]); ``paged`` carries depth-stacked page stores
    (``[L, N, bs, ...]``, `engine.kv_blocks.KVBlockPool.kv_pages`), read in
    place, never gathered. Returns f32 logits [B, t, vocab]. A
    `ShardedLM` runs its tensor-parallel step on its `ShardedCache` and
    returns the logits as `ops/sampling.py:VocabShards`."""
    if isinstance(model, ShardedLM):
        return model.decode_apply(cache, tokens, cursors, paged)
    x = model.embed(tokens).to(model.compute_dtype)
    for i, blk in enumerate(model.blocks):
        layer = {name: leaf[i] for name, leaf in cache.items()}
        x = blk.decode(x, layer, cursors,
                       None if paged is None else paged.layer(i))
    return model.head(model.ln_f(x)).to(torch.float32)


# -- tensor-parallel decode -------------------------------------------------


class ShardDense:
    """One model shard of a ``Dense``: its cut of the weight (a tensor, or
    an int8 `parallel/sharding.py:QParam` dequantized on each call as
    ``ops/quantize.py`` does) and of the bias, or no bias (a row shard,
    whose bias is added once after the reduction)."""

    def __init__(self, weight, bias) -> None:
        self.weight, self.bias = weight, bias

    @staticmethod
    def _read(p):
        return p.dequantize() if hasattr(p, "dequantize") else p

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self._read(self.bias).to(x.dtype)
        return F.linear(x, self._read(self.weight).to(x.dtype), b)


@dataclass
class ShardedCache:
    """The decode cache of a `ShardedLM`: ``parts[i][m]`` is the
    depth-stacked cache dict (``init_cache``'s layout) of the ``i``-th data
    group the decoder spans (its rows of the batch) on model shard ``m``,
    holding that shard's KV heads (all of them where the KV heads
    replicate), on that shard's device."""

    parts: list


class ShardedLM:
    """Tensor-parallel decode of a dense `TransformerLM` over a
    ``parallel/mesh.py:Mesh`` (the JAX package's GSPMD split, written out).

    Model shard ``m`` holds its cut of every block (`parallel/sharding.py:
    lm_tp_specs`): the Q heads ``[m·H/n, (m+1)·H/n)`` and its KV heads
    (all of them where the KV heads do not divide ``n``), its slice of the
    MLP's hidden features, and its vocab slice of the unembed where the
    vocab divides. A block runs, per shard, the column shards (q/k/v,
    ``mlp_up``), the attention on the shard's heads against the shard's
    cache (K3 per shard on a paged pool), and the row shards (``out``,
    ``mlp_down``); each row shard's partial outputs are summed in shard
    order, in f32, on the data group's lead device, then its bias is added
    once: two reductions per block, and a stream that does not depend on
    timing. The embedding and the norms run once, on the lead device.

    ``groups`` are the data groups this decoder serves (default all): a
    batch splits over them in order (the pool's slots over the data
    axis), each group on its own row of the mesh. `for_group` gives the
    decoder of one group, which a single-row prefill uses. Routed (MoE)
    blocks refuse: expert parallelism is ROADMAP.md §1 step 3e."""

    def __init__(self, model: TransformerLM, mesh, *,
                 groups: tuple[int, ...] | None = None) -> None:
        from idunno_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
        from idunno_tpu_torch.parallel.sharding import shard_lm_params

        if getattr(model, "ffn_factory", None) is not None:
            raise ValueError(
                "n_model > 1 requires the scanned decode layout (dense "
                "scan-compatible blocks): routed blocks under tensor "
                "parallelism come with expert parallelism (ROADMAP.md §1, "
                "step 3e)")
        self.model, self.mesh = model, mesh
        self.n_data = mesh.shape[DATA_AXIS]
        self.n_model = n = mesh.shape[MODEL_AXIS]
        self.groups = (tuple(range(self.n_data)) if groups is None
                       else tuple(groups))
        self.kv_shard = model.kv_heads % n == 0
        self.vocab_shard = n > 1 and model.vocab % n == 0
        self.head_dim = model.dim // model.num_heads
        self.q_heads = model.num_heads // n
        self.kv_local = model.kv_heads // n if self.kv_shard \
            else model.kv_heads
        # each model shard's weights per (device, shard), and the model
        # (embedding, norms, row shards' biases) per data group's lead
        self._shards: dict = {}
        self._replicas: dict = {}
        src_dev = model.ln_f.weight.device
        for g, row in enumerate(mesh.devices):
            lead = row[0]
            if lead not in self._replicas:
                self._replicas[lead] = (model if lead == src_dev else
                                        copy.deepcopy(model).to(lead))
            if all((dev, m) in self._shards for m, dev in enumerate(row)):
                continue
            for m, params in enumerate(shard_lm_params(mesh, model, g)):
                blocks = [{
                    mod: ShardDense(
                        params[f"blocks.{i}.{path}.weight"],
                        None if mod in ("out", "mlp_down")
                        else params[f"blocks.{i}.{path}.bias"])
                    for mod, path in (("q", "attn.q"), ("k", "attn.k"),
                                      ("v", "attn.v"), ("out", "attn.out"),
                                      ("mlp_up", "mlp_up"),
                                      ("mlp_down", "mlp_down"))}
                    for i in range(model.depth)]
                head = (ShardDense(params["head.weight"], params["head.bias"])
                        if self.vocab_shard else None)
                self._shards[row[m], m] = {"blocks": blocks, "head": head}

    def for_group(self, group: int) -> "ShardedLM":
        """This decoder over data group ``group`` alone (same weights)."""
        view = copy.copy(self)
        view.groups = (group,)
        return view

    def group_of(self, slot: int, slots: int) -> int:
        """The data group that holds pool slot ``slot`` of ``slots``."""
        return slot // (slots // self.n_data)

    def _devices(self, g: int) -> tuple:
        return self.mesh.devices[g]

    def init_cache(self, batch: int, max_len: int) -> ShardedCache:
        """Zeroed cache for ``batch`` rows split over this decoder's data
        groups (``init_cache``'s depth-stacked leaves per shard, KV heads
        cut where they shard)."""
        ng = len(self.groups)
        if batch % ng:
            raise ValueError(f"batch {batch} must divide over {ng} data "
                             "groups")
        m = self.model
        quant = m.kv_cache_dtype == "int8"
        dt = torch.int8 if quant else m.compute_dtype
        parts = []
        for g in self.groups:
            row = []
            for dev in self._devices(g):
                shape = (m.depth, batch // ng, max_len, self.kv_local,
                         self.head_dim)
                c = {"cached_k": torch.zeros(shape, dtype=dt, device=dev),
                     "cached_v": torch.zeros(shape, dtype=dt, device=dev)}
                if quant:
                    c["k_scale"] = torch.zeros(shape[:-1],
                                               dtype=torch.float32,
                                               device=dev)
                    c["v_scale"] = torch.zeros(shape[:-1],
                                               dtype=torch.float32,
                                               device=dev)
                row.append(c)
            parts.append(row)
        return ShardedCache(parts)

    @staticmethod
    def _reduce(parts: list, lead: torch.device, bias: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """Sum a row shard's partial outputs in shard order, in f32, on
        ``lead``, then add the bias once."""
        acc = parts[0].to(lead, torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(lead, torch.float32)
        return (acc + bias.to(torch.float32)).to(dtype)

    def _paged_shard(self, paged: PagedContext, dev, m: int, i: int,
                     rows: slice) -> PagedContext:
        def pick(pages):
            return None if pages is None else pages[dev, m][i]
        return dataclasses.replace(
            paged, k_pages=pick(paged.k_pages), v_pages=pick(paged.v_pages),
            k_scale_pages=pick(paged.k_scale_pages),
            v_scale_pages=pick(paged.v_scale_pages),
            tables=paged.tables[rows].to(dev),
            lengths=paged.lengths[rows].to(dev))

    def _group_apply(self, g: int, cache: list, tokens: torch.Tensor,
                     cursors, paged: PagedContext | None,
                     rows: slice) -> list:
        devs = self._devices(g)
        lead = devs[0]
        rep = self._replicas[lead]
        hd, hq = self.head_dim, self.q_heads
        x = rep.embed(tokens.to(lead)).to(self.model.compute_dtype)
        b, t, _ = x.shape
        for i, blk in enumerate(rep.blocks):
            h = blk.ln1(x)
            parts = []
            for m, dev in enumerate(devs):
                w = self._shards[dev, m]["blocks"][i]
                hm = h.to(dev)
                q = w["q"](hm).view(b, t, hq, hd)
                k = w["k"](hm).view(b, t, self.kv_local, hd)
                v = w["v"](hm).view(b, t, self.kv_local, hd)
                h0 = m * hq
                if not self.kv_shard:
                    # replicated KV heads: the shard's Q heads sit at
                    # their places among all H heads (zeros elsewhere)
                    # so every head meets its own KV head
                    full = q.new_zeros((b, t, self.model.num_heads, hd))
                    full[:, :, h0:h0 + hq] = q
                    q = full
                layer = {name: leaf[i] for name, leaf in cache[m].items()}
                ctx = (None if paged is None
                       else self._paged_shard(paged, dev, m, i, rows))
                o = decode_attention(
                    q, k, v, layer, cursors, ctx,
                    kv_cache_dtype=blk.attn.kv_cache_dtype,
                    use_rope=blk.attn.use_rope, out_dtype=x.dtype)
                if not self.kv_shard:
                    o = o[:, :, h0:h0 + hq]
                parts.append(w["out"](o.reshape(b, t, hq * hd)))
            x = x + self._reduce(parts, lead, blk.attn.out.bias, x.dtype)
            h = blk.ln2(x)
            parts = []
            for m, dev in enumerate(devs):
                w = self._shards[dev, m]["blocks"][i]
                up = F.gelu(w["mlp_up"](h.to(dev)), approximate="tanh")
                parts.append(w["mlp_down"](up))
            x = x + self._reduce(parts, lead, blk.mlp_down.bias, x.dtype)
        y = rep.ln_f(x)
        if not self.vocab_shard:
            return [rep.head(y).to(torch.float32)]
        return [self._shards[dev, m]["head"](y.to(dev)).to(torch.float32)
                for m, dev in enumerate(devs)]

    def decode_apply(self, cache: ShardedCache, tokens: torch.Tensor,
                     cursors, paged: PagedContext | None = None):
        """`decode_apply` over the mesh: ``tokens`` [B, t] split over the
        data groups in order (so are per-row ``cursors`` and the paged
        context's tables and lengths); ``paged`` carries the pool's page
        stores per ``(device, shard)`` (`KVBlockPool(mesh=).kv_pages`).
        Returns the f32 logits [B, t, vocab] as `VocabShards`: one part
        per vocab shard, on data group 0's device of that shard (one
        part, on the lead device, where the vocab replicates)."""
        ng = len(self.groups)
        per = tokens.shape[0] // ng
        outs = []
        for gi, g in enumerate(self.groups):
            rows = slice(gi * per, (gi + 1) * per)
            cur = (cursors[rows] if isinstance(cursors, torch.Tensor)
                   and cursors.dim() == 1 else cursors)
            outs.append(self._group_apply(g, cache.parts[gi], tokens[rows],
                                          cur, paged, rows))
        if ng == 1:
            return VocabShards(outs[0])
        devs = self._devices(self.groups[0])
        return VocabShards([
            torch.cat([o[m].to(devs[m]) for o in outs])
            for m in range(len(outs[0]))])

