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

from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from idunno_tpu_torch.models.mixed import Dense
from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.ops.paged_attention import (PagedContext,
                                                  merge_attention,
                                                  paged_attention_grouped)

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
        if self.kv_cache_dtype not in ("native", "int8"):
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}: "
                             "want native|int8")
        quant = self.kv_cache_dtype == "int8"
        b, t, _ = x.shape
        q, k, v = self._qkv(x)
        h, d, kvh = self.num_heads, self.head_dim, self.kv_heads
        ck, cv = cache["cached_k"], cache["cached_v"]
        ks = cache.get("k_scale")
        vs = cache.get("v_scale")
        max_len = ck.shape[1]
        dev = x.device
        if isinstance(cursors, torch.Tensor) and cursors.dim() == 1:
            i = cursors.to(dev)
            pos_bt = i[:, None] + torch.arange(t, device=dev)[None, :]
            overflow = i + t > max_len                      # [B]
            if self.use_rope:
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
            if self.use_rope:
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
            out = o_l.to(x.dtype)
        else:
            lse_l = (m_l + torch.log(l_l))[..., 0].permute(0, 3, 1, 2)
            o_p, lse_p = paged_attention_grouped(
                q5.to(torch.float32), paged.k_pages, paged.v_pages,
                paged.tables, paged.lengths,
                k_scale_pages=paged.k_scale_pages,
                v_scale_pages=paged.v_scale_pages, kernel=paged.kernel)
            out = merge_attention(o_l, lse_l, o_p, lse_p).to(x.dtype)
        return self.out(out.reshape(b, t, h * d))


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
    place, never gathered. Returns f32 logits [B, t, vocab]."""
    x = model.embed(tokens).to(model.compute_dtype)
    for i, blk in enumerate(model.blocks):
        layer = {name: leaf[i] for name, leaf in cache.items()}
        x = blk.decode(x, layer, cursors,
                       None if paged is None else paged.layer(i))
    return model.head(model.ln_f(x)).to(torch.float32)
