"""Autoregressive LM generation: KV-cached greedy/temperature decoding.

A port of ``idunno_tpu/engine/generate.py`` (``decode_model``,
``init_cache``, ``generate``, ``stepwise_logits``). The whole decode —
prompt teacher-forcing and generation — runs one token per step through
``models/transformer.py:decode_apply`` with the scalar cursor against a
static-length cache, exactly the step the serving pool runs, so the
pool's greedy streams can be held against ``generate`` token for token.
``beam_search`` and the ``save_lm``/``load_lm`` store verbs wait for the
port of the store.
"""
from __future__ import annotations

import torch

from idunno_tpu_torch.models.transformer import TransformerLM, decode_apply
from idunno_tpu_torch.ops.sampling import categorical, sample_keep_mask


def decode_model(model: TransformerLM, max_len: int) -> TransformerLM:
    """The serving twin of a model. In the port the decode step is a
    function of the same module (`decode_apply`) and the cache carries its
    own length, so the model itself serves; kept so callers of the JAX
    package's API read the same."""
    del max_len
    return model


def _device_of(model: TransformerLM) -> torch.device:
    return model.embed.weight.device


def init_cache(model: TransformerLM, batch: int, max_len: int,
               device: torch.device | str | None = None) -> dict:
    """Zeroed depth-stacked KV cache for a [batch] decode of ≤ max_len
    tokens: ``cached_k``/``cached_v`` [L, batch, max_len, KVH, D] in the
    model's compute dtype (int8 for an int8 cache, which adds f32 ``k_scale``/
    ``v_scale`` [L, batch, max_len, KVH])."""
    dev = _device_of(model) if device is None else torch.device(device)
    hd = model.dim // model.num_heads
    shape = (model.depth, batch, max_len, model.kv_heads, hd)
    quant = model.kv_cache_dtype == "int8"
    dt = torch.int8 if quant else model.compute_dtype
    cache = {"cached_k": torch.zeros(shape, dtype=dt, device=dev),
             "cached_v": torch.zeros(shape, dtype=dt, device=dev)}
    if quant:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
    return cache


@torch.no_grad()
def generate(model: TransformerLM, prompt: torch.Tensor, prompt_len: int,
             max_new: int, *, temperature: float = 0.0, top_p: float = 1.0,
             top_k: int = 0, presence_penalty: float = 0.0,
             frequency_penalty: float = 0.0,
             rng: torch.Generator | int | None = None,
             prompt_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Generate ``max_new`` tokens after ``prompt[:, :prompt_len]``.

    prompt: int [B, prompt_len]. Returns int64 [B, prompt_len + max_new].
    temperature 0 → greedy argmax; > 0 → softmax sampling from ``rng`` (a
    ``torch.Generator`` on the model's device, or a seed; default seed 0);
    ``top_k`` > 0 then ``top_p`` < 1 restrict it (`ops.sampling.
    sample_keep_mask`, the mask the serving tail builds). Presence and
    frequency penalties subtract ``presence·1[count>0] + frequency·count``
    from every raw logit, counting this row's generated tokens only.

    Ragged batches: ``prompt_lens`` (int [B], 1 ≤ len ≤ prompt_len) with
    right-padded prompts — each row is teacher-forced only through its own
    length and generates from there."""
    if prompt.shape[1] != prompt_len:
        raise ValueError(f"prompt is [B, {prompt.shape[1]}] but "
                         f"prompt_len={prompt_len}; slice/pad upstream")
    dev = _device_of(model)
    b = prompt.shape[0]
    total = prompt_len + max_new
    cache = init_cache(model, b, total)
    tokens = torch.cat([prompt.to(dev, torch.int64),
                        torch.zeros((b, max_new), dtype=torch.int64,
                                    device=dev)], dim=1)
    if rng is None or isinstance(rng, int):
        rng = torch.Generator(device=dev).manual_seed(rng or 0)
    plens = (torch.full((b,), prompt_len, dtype=torch.int64, device=dev)
             if prompt_lens is None else prompt_lens.to(dev, torch.int64))
    penalized = presence_penalty != 0.0 or frequency_penalty != 0.0
    counts = torch.zeros((b, model.vocab if penalized else 0),
                         dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    for t in range(total - 1):
        logits = decode_apply(model, cache, tokens[:, t:t + 1], t)[:, 0]
        if penalized:
            logits = (logits - presence_penalty * (counts > 0)
                      - frequency_penalty * counts.to(logits.dtype))
        if temperature > 0.0:
            scaled = logits / temperature
            if top_p < 1.0 or top_k > 0:
                keep = sample_keep_mask(
                    scaled, torch.full((b,), top_p, device=dev),
                    torch.full((b,), top_k, dtype=torch.int64, device=dev))
                scaled = torch.where(keep, scaled,
                                     torch.full_like(scaled, float("-inf")))
            nxt = categorical(scaled, rng)
        else:
            nxt = torch.argmax(logits, dim=-1)
        # per row: teacher-force while inside its prompt; append past it
        keep_prompt = (t + 1) < plens
        nxt = torch.where(keep_prompt, tokens[:, t + 1], nxt)
        tokens[:, t + 1] = nxt
        if penalized:   # teacher-forced (prompt) tokens never count
            counts[rows, nxt] += (~keep_prompt).to(counts.dtype)
    return tokens


@torch.no_grad()
def stepwise_logits(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced single-token decode over a full [B, T] sequence,
    returning [B, T, vocab] — must equal the batched full forward; the
    correctness oracle for the cache (tests)."""
    b, t = tokens.shape
    cache = init_cache(model, b, t)
    tokens = tokens.to(_device_of(model))
    outs = [decode_apply(model, cache, tokens[:, i:i + 1], i)[:, 0]
            for i in range(t)]
    return torch.stack(outs, dim=1)
