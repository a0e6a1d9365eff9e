"""Shared sampling transforms for the generation tiers, in PyTorch.

A port of ``idunno_tpu/ops/sampling.py``. One implementation of top-k and
nucleus (top-p) filtering serves both one-shot `engine.generate` and the
continuous-batching pool (`engine.serve_lm`), so the two tiers filter
identically. Two forms of it:

- `sample_keep_mask`/`masked_sample_logits`: the token-exact hot path
  (generate loop, `fused_decode_tail`, the prefill pick). Thresholds come
  from exact bit-bisection over f32 patterns, so the whole tail is
  elementwise ops + per-row reductions, and the mask is the JAX package's
  on identical logits.
- `filtered_probs`/`nucleus_probs`: the sort-based normalized
  distribution, the reference the keep mask is held to, and what
  speculative verification (`engine.serve_lm.spec_commit`) compares:
  its contract is distribution-exact, so it needs actual probabilities.

Randomness: JAX's per-row ``[slots, 2]`` keys become one
``torch.Generator`` per row, and a draw is the Gumbel-max construction
``argmax(logits + gumbel)`` over uniforms from that generator (the
construction ``jax.random.categorical`` uses). The two frameworks give
different bits from the same seed, so sampled streams are compared by
their distribution, never token for token.

The vocab-sharded tail: a tensor-parallel pool's unembed is cut over the
vocab (`parallel/sharding.py`), so its logits come as `VocabShards`, one
``[..., V/n]`` part per model shard. `fused_decode_tail` and the helpers
below resolve greedy, sampled and filtered picks and log-probabilities
from per-shard statistics merged in shard order on the lead device (row
maxima, counts and mass sums, argmax values and indices), as the JAX
package's GSPMD-partitioned tail does, so the ``[rows, vocab]`` logits
are never gathered whole. A Gumbel-max draw reads the same uniforms from
the row's generator as the unsharded draw, so on the same logits both
pick the same token.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch


class VocabShards:
    """Logits ``[..., vocab]`` held as parts cut along the vocab: part
    ``m`` is ``[..., V_m]`` (on model shard ``m``'s device), covering
    vocab ids ``[offset_m, offset_m + V_m)``. Indexing applies to every
    part (leading axes only)."""

    def __init__(self, parts: Sequence[torch.Tensor]) -> None:
        self.parts = list(parts)

    def __getitem__(self, key) -> "VocabShards":
        return VocabShards([p[key] for p in self.parts])


def _sum_in_order(parts: Sequence[torch.Tensor],
                  lead: torch.device) -> torch.Tensor:
    """Per-shard partials summed in shard order on ``lead``."""
    out = parts[0].to(lead)
    for p in parts[1:]:
        out = out + p.to(lead)
    return out


def _merge_max(parts: Sequence[torch.Tensor]
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (max, global argmax) over vocab parts, merged in shard
    order on the first part's device; ties go to the lowest vocab id, as
    ``torch.argmax`` over the whole row gives them."""
    lead = parts[0].device
    vals, idxs, off = [], [], 0
    for p in parts:
        v, i = p.max(dim=-1)
        vals.append(v.to(lead))
        idxs.append((i + off).to(lead))
        off += p.shape[-1]
    vals_t, idxs_t = torch.stack(vals), torch.stack(idxs)
    best = vals_t.argmax(dim=0, keepdim=True)      # first shard holding it
    return vals_t.gather(0, best)[0], idxs_t.gather(0, best)[0]


def shard_argmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``argmax`` over the whole vocab of ``VocabShards.parts``."""
    return _merge_max(parts)[1]


def shard_logsumexp(parts: Sequence[torch.Tensor]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (max, log-sum-exp of the logits less that max) over vocab
    parts: the row max merged first, then each part's mass summed in
    shard order (f32, on the first part's device)."""
    mx = _merge_max(parts)[0]
    s = _sum_in_order([torch.exp(p.float() - mx.to(p.device)[..., None])
                       .sum(dim=-1) for p in parts], parts[0].device)
    return mx, torch.log(s)


def shard_take(parts: Sequence[torch.Tensor],
               idx: torch.Tensor) -> torch.Tensor:
    """The logit at global vocab id ``idx`` of each row ([rows] → [rows],
    on the first part's device): each part gives its value where it holds
    the id, zero elsewhere, and the parts are summed."""
    vals, off = [], 0
    for p in parts:
        n = p.shape[-1]
        local = (idx.to(p.device) - off)
        held = (local >= 0) & (local < n)
        val = torch.gather(p, -1, torch.clamp(local, 0, n - 1)[..., None])
        vals.append(torch.where(held, val[..., 0],
                                torch.zeros_like(val[..., 0])))
        off += n
    return _sum_in_order(vals, parts[0].device)


def shard_keep_masks(parts: Sequence[torch.Tensor], top_p: torch.Tensor,
                     top_k: torch.Tensor) -> list[torch.Tensor]:
    """`sample_keep_mask` over vocab parts, one mask per part: the row max,
    the count predicate and the mass predicate of both bit-bisections
    merge per-shard statistics (exact integer counts; f32 mass sums in
    shard order)."""
    lead = parts[0].device
    v = sum(p.shape[-1] for p in parts)
    rows = tuple(parts[0].shape[:-1])
    mx = _merge_max(parts)[0]
    es = [torch.exp((p - mx.to(p.device)[..., None]).to(torch.float32))
          for p in parts]
    k = torch.clamp(top_k, 0, v)
    k_off = (k <= 0) | (k >= v)
    kth = _largest_true_bits(
        lambda t: _sum_in_order([(e >= t.to(e.device)[..., None])
                                 .sum(dim=-1) for e in es], lead) >= k,
        rows, lead)
    keep_k = [(e >= kth.to(e.device)[..., None])
              | k_off.to(e.device)[..., None] for e in es]
    masked = [torch.where(kk, e, torch.zeros_like(e))
              for kk, e in zip(keep_k, es)]
    z = _sum_in_order([mk.sum(dim=-1) for mk in masked], lead)
    target = torch.clamp_min(top_p * z, 1e-38)

    def mass(t):
        return _sum_in_order([
            torch.where(mk >= t.to(mk.device)[..., None], mk,
                        torch.zeros_like(mk)).sum(dim=-1)
            for mk in masked], lead)

    cut = _largest_true_bits(lambda t: mass(t) >= target, rows, lead)
    p_off = top_p >= 1.0
    return [kk & ((e >= cut.to(e.device)[..., None])
                  | p_off.to(e.device)[..., None])
            for kk, e in zip(keep_k, es)]


def shard_masked_sample_logits(parts: Sequence[torch.Tensor],
                               top_p: torch.Tensor,
                               top_k: torch.Tensor) -> list[torch.Tensor]:
    """`masked_sample_logits` over vocab parts."""
    keeps = shard_keep_masks(parts, top_p, top_k)
    off = ~filter_on(top_p, top_k)
    return [torch.where(kk | off.to(p.device)[..., None], p,
                        torch.full_like(p, float("-inf")))
            for kk, p in zip(keeps, parts)]


def shard_categorical(parts: Sequence[torch.Tensor],
                      generator: torch.Generator | None) -> torch.Tensor:
    """`categorical` over vocab parts: the uniforms of the whole row are
    drawn from ``generator`` on the first part's device exactly as the
    unsharded draw draws them, and each part takes its slice of the Gumbel
    noise; the argmax merges per-shard maxima."""
    lead = parts[0].device
    v = sum(p.shape[-1] for p in parts)
    u = torch.rand(tuple(parts[0].shape[:-1]) + (v,), generator=generator,
                   device=lead, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    noisy, off = [], 0
    for p in parts:
        n = p.shape[-1]
        noisy.append(p.float() + gumbel[..., off:off + n].to(p.device))
        off += n
    return shard_argmax(noisy)


def nucleus_probs(scaled_logits: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits → nucleus-filtered, renormalized
    probabilities over the LAST axis (``top_p`` broadcasts over the
    leading shape): `filtered_probs` with top-k off, so the nucleus cut
    has one definition (the JAX package's ``_nucleus_on_probs`` is the
    same cut over the unnormalized cumulative sum)."""
    return filtered_probs(scaled_logits, top_p,
                          torch.zeros(top_p.shape, dtype=torch.int64,
                                      device=top_p.device))


def filtered_probs(scaled_logits: torch.Tensor, top_p: torch.Tensor,
                   top_k: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits → top-k then nucleus filtered,
    renormalized probabilities over the LAST axis (ties at the k-th
    probability all kept; the nucleus is taken over the renormalized top-k
    distribution). With both filters off this is the plain softmax."""
    probs = torch.softmax(scaled_logits, dim=-1)
    v = probs.shape[-1]
    k = torch.clamp(top_k, 0, v)
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    idx = torch.clamp(k - 1, 0, v - 1).long()
    kth = torch.gather(sorted_p, -1,
                       idx[..., None].expand(probs.shape[:-1] + (1,)))
    k_off = (k[..., None] <= 0) | (k[..., None] >= v)
    keep_k = (probs >= kth) | k_off
    masked_sorted = torch.where((sorted_p >= kth) | k_off, sorted_p,
                                torch.zeros_like(sorted_p))
    z = masked_sorted.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(masked_sorted, dim=-1) / z
    target = torch.minimum(top_p[..., None], cum[..., -1:])
    k_idx = (cum >= target).to(torch.int8).argmax(dim=-1)
    cutoff = torch.gather(masked_sorted, -1, k_idx[..., None])
    keep = keep_k & ((probs >= cutoff) | (top_p[..., None] >= 1.0))
    filt = torch.where(keep, probs, torch.zeros_like(probs))
    return filt / filt.sum(dim=-1, keepdim=True)


# float32 1.0 bit pattern: the bisection space for values in [0, 1]
_ONE_BITS = 0x3F800000


def _largest_true_bits(pred, rows: tuple, device) -> torch.Tensor:
    """Largest f32 ``t`` in [0, nextafter(1)] with ``pred(t)`` True, per
    row. Non-negative IEEE floats order like their int32 bit patterns, so
    an exact binary search over the bit space finds the exact float where
    a monotone (non-increasing) predicate flips. 31 rounds cover the
    ~2^30-wide pattern range."""
    lo = torch.zeros(rows, dtype=torch.int32, device=device)
    hi = torch.full(rows, _ONE_BITS + 1, dtype=torch.int32, device=device)
    for _ in range(31):
        mid = (lo + hi) >> 1
        ok = pred(mid.view(torch.float32))
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo.view(torch.float32)


def sample_keep_mask(scaled: torch.Tensor, top_p: torch.Tensor,
                     top_k: torch.Tensor) -> torch.Tensor:
    """Top-k + nucleus survivor mask over the LAST axis: the same set as
    ``filtered_probs(scaled, top_p, top_k) > 0``, with both thresholds
    found by exact bit-bisection on the unnormalized softmax numerator
    ``e = exp(scaled - max)``:

      k-th value   = largest t with  count(e >= t)          >= k
      nucleus cut  = largest t with  mass(kept & e >= t)    >= top_p·Z
    """
    v = scaled.shape[-1]
    rows = tuple(scaled.shape[:-1])
    e = torch.exp((scaled - scaled.amax(dim=-1, keepdim=True))
                  .to(torch.float32))
    k = torch.clamp(top_k, 0, v)
    k_off = (k <= 0) | (k >= v)
    kth = _largest_true_bits(
        lambda t: (e >= t[..., None]).sum(dim=-1) >= k, rows, scaled.device)
    keep_k = (e >= kth[..., None]) | k_off[..., None]
    masked = torch.where(keep_k, e, torch.zeros_like(e))
    z = masked.sum(dim=-1)
    # the tiny floor makes top_p→0 keep the argmax tie-set (the mass
    # predicate must fail above the largest kept value, not everywhere)
    target = torch.clamp_min(top_p * z, 1e-38)
    cut = _largest_true_bits(
        lambda t: torch.where(masked >= t[..., None], masked,
                              torch.zeros_like(masked)).sum(dim=-1) >= target,
        rows, scaled.device)
    p_off = top_p >= 1.0
    return keep_k & ((e >= cut[..., None]) | p_off[..., None])


def filter_on(top_p: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Per-row: does this row ask for any sampling filter at all?"""
    return (top_p < 1.0) | (top_k > 0)


def masked_sample_logits(scaled: torch.Tensor, top_p: torch.Tensor,
                         top_k: torch.Tensor) -> torch.Tensor:
    """Per-row sampling logits in the masked-scaled form: filtered rows keep
    their scaled logits on the survivor set and -inf elsewhere; filter-off
    rows pass through untouched. A Gumbel-max draw is shift-invariant per
    row, so drawing from these equals drawing from ``log(filtered_probs)``."""
    keep = sample_keep_mask(scaled, top_p, top_k)
    off = ~filter_on(top_p, top_k)
    return torch.where(keep | off[..., None], scaled,
                       torch.full_like(scaled, float("-inf")))


def safe_log(probs: torch.Tensor) -> torch.Tensor:
    """log with EXACT -inf outside the support: a filtered-out token has
    probability zero, not e^-87."""
    return torch.where(probs > 0.0, torch.log(torch.clamp_min(probs, 1e-38)),
                       torch.full_like(probs, float("-inf")))


def categorical(logits: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row of ``logits [..., V]`` (int64 [...]) by Gumbel-max
    over uniforms from ``generator``: ``argmax(logits + gumbel)``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def draw_sampled(probs: torch.Tensor,
                 generators: Sequence) -> torch.Tensor:
    """One draw per row of the probability rows ``probs [R, V]``, row i
    from its own ``generators[i]`` (int64 [R]): a Gumbel-max draw over
    ``safe_log(probs)``, so a zero-probability token is never drawn. The
    speculative round's draft draws and residual bonus draws; each row's
    stream depends on its own generator alone."""
    logp = safe_log(probs)
    return torch.stack([categorical(logp[i], g)
                        for i, g in enumerate(generators)])


def fused_decode_tail(l_raw: torch.Tensor, tokens: torch.Tensor,
                      cursors: torch.Tensor, remaining: torch.Tensor,
                      temps: torch.Tensor, top_ps: torch.Tensor,
                      top_ks: torch.Tensor, generators: Sequence,
                      logprobs: torch.Tensor, pres: torch.Tensor,
                      freq: torch.Tensor, counts: torch.Tensor, *,
                      max_len: int, eos_id: int | None, track: bool,
                      pen: bool, sampled: Sequence[int] = (),
                      filtered: bool = False) -> tuple:
    """The post-model tail of one continuous-batching decode step:
    penalties → temperature/top-k/top-p pick → token/logprob write →
    cursor/remaining/EOS bookkeeping → count update. ``l_raw`` is the raw
    [S, vocab] model logits; ``tokens``, ``logprobs`` and ``counts`` are
    updated in place. Returns ``(tokens, cursors, remaining, logprobs,
    counts)``.

    ``sampled`` lists the rows that sample (temperature > 0) and
    ``filtered`` whether any of them asks for a top-k/top-p filter — both
    known on the host, so an all-greedy pool runs no sampling op at all.
    Each sampled row draws from its own generator ``generators[row]``, so
    its stream depends on its seed alone, never on its co-residents.
    Inactive rows (``remaining == 0``) keep their state. ``l_raw`` may
    be `VocabShards` (a tensor-parallel pool's logits): the picks and the
    log-probabilities then come from per-shard statistics."""
    active = remaining > 0
    s = tokens.shape[0]
    rows = torch.arange(s, device=tokens.device)
    if isinstance(l_raw, VocabShards):
        nxt, lp = _sharded_picks(l_raw, temps, top_ps, top_ks, generators,
                                 pres, freq, counts, track=track, pen=pen,
                                 sampled=sampled, filtered=filtered)
    else:
        l = l_raw
        if pen:   # counts cover this row's GENERATED tokens only
            l = (l - pres[:, None] * (counts > 0)
                 - freq[:, None] * counts.to(l.dtype))
        nxt = torch.argmax(l, dim=-1)
        if sampled:
            rows_s = torch.as_tensor(list(sampled), device=l.device)
            scaled = (l[rows_s]
                      / torch.clamp_min(temps[rows_s], 1e-6)[:, None])
            if filtered:
                scaled = masked_sample_logits(scaled, top_ps[rows_s],
                                              top_ks[rows_s])
            drawn = torch.stack([categorical(scaled[i], generators[r])
                                 for i, r in enumerate(sampled)])
            nxt = nxt.clone()
            nxt[rows_s] = drawn
        lp = None
        if track:
            # logprobs report the RAW model distribution even on
            # penalized rows
            l32 = l_raw.float()
            shifted = l32 - l32.amax(dim=-1, keepdim=True)
            lse = torch.log(torch.exp(shifted).sum(dim=-1))
            lp = shifted[rows, nxt] - lse
    wpos = torch.clamp(cursors + 1, 0, max_len - 1)
    old = tokens[rows, wpos]
    tokens[rows, wpos] = torch.where(active, nxt.to(tokens.dtype), old)
    if track:
        lp_old = logprobs[rows, wpos]
        logprobs[rows, wpos] = torch.where(active, lp, lp_old)
    cursors = torch.where(active, cursors + 1, cursors)
    new_remaining = remaining - 1
    if eos_id is not None:
        new_remaining = torch.where(nxt == eos_id,
                                    torch.zeros_like(new_remaining),
                                    new_remaining)
    remaining = torch.where(active, new_remaining, remaining)
    if pen:
        counts[rows, nxt] += active.to(counts.dtype)
    return tokens, cursors, remaining, logprobs, counts


def _sharded_picks(l_raw: VocabShards, temps, top_ps, top_ks, generators,
                   pres, freq, counts, *, track: bool, pen: bool,
                   sampled: Sequence[int], filtered: bool) -> tuple:
    """The picks (int64 [S]) and, with ``track``, the raw-distribution
    log-probabilities of `fused_decode_tail` over vocab parts."""
    parts = l_raw.parts
    if pen:   # counts cover this row's GENERATED tokens only
        pen_parts, off = [], 0
        for p in parts:
            c = counts[:, off:off + p.shape[-1]].to(p.device)
            pen_parts.append(p - pres.to(p.device)[:, None] * (c > 0)
                             - freq.to(p.device)[:, None] * c.to(p.dtype))
            off += p.shape[-1]
        parts = pen_parts
    nxt = shard_argmax(parts)
    if sampled:
        lead = nxt.device
        rows_s = torch.as_tensor(list(sampled), device=lead)
        scale = torch.clamp_min(temps[rows_s], 1e-6)
        scaled = [p[rows_s.to(p.device)] / scale.to(p.device)[:, None]
                  for p in parts]
        if filtered:
            scaled = shard_masked_sample_logits(scaled, top_ps[rows_s],
                                                top_ks[rows_s])
        drawn = torch.stack([
            shard_categorical([sp[i] for sp in scaled], generators[r])
            for i, r in enumerate(sampled)])
        nxt = nxt.clone()
        nxt[rows_s] = drawn
    lp = None
    if track:
        raw = [p.float() for p in l_raw.parts]
        mx, lse = shard_logsumexp(raw)
        lp = (shard_take(raw, nxt) - mx) - lse
    return nxt, lp


def pick_token(logits, temp: float, gen: torch.Generator | None,
               top_p: float, top_k: int) -> int:
    """One row's token from its logits ``[vocab]`` (a tensor or
    `VocabShards`): greedy at ``temp <= 0``, else a draw from the
    temperature-scaled, top-k/top-p masked logits (the decode tail's
    masked-scaled form)."""
    sharded = isinstance(logits, VocabShards)
    if temp <= 0.0:
        return int(shard_argmax(logits.parts) if sharded
                   else torch.argmax(logits))
    parts = logits.parts if sharded else [logits]
    dev = parts[0].device
    scaled = [(p / max(temp, 1e-6))[None] for p in parts]
    if top_p < 1.0 or top_k > 0:
        tp = torch.tensor([top_p], dtype=torch.float32, device=dev)
        tk = torch.tensor([top_k], dtype=torch.int64, device=dev)
        scaled = (shard_masked_sample_logits(scaled, tp, tk) if sharded
                  else [masked_sample_logits(scaled[0], tp, tk)])
    if sharded:
        return int(shard_categorical([s[0] for s in scaled], gen))
    return int(categorical(scaled[0][0], gen))


def token_logprob(logits, token: int) -> torch.Tensor:
    """log-softmax of one row's logits ``[vocab]`` (a tensor or
    `VocabShards`) at ``token``."""
    if not isinstance(logits, VocabShards):
        return torch.log_softmax(logits.float(), dim=-1)[token]
    raw = [p.float()[None] for p in logits.parts]
    mx, lse = shard_logsumexp(raw)
    idx = torch.tensor([token], device=raw[0].device)
    return ((shard_take(raw, idx) - mx) - lse)[0]
