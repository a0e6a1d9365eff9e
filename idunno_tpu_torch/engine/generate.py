"""Autoregressive LM generation: KV-cached greedy/temperature decoding.

A port of ``idunno_tpu/engine/generate.py`` (``decode_model``,
``init_cache``, ``generate``, ``beam_search`` with ``gather_beams``,
``stepwise_logits``, and the store verbs ``save_lm``/``load_lm``). The
whole decode — prompt teacher-forcing and
generation — runs one token per step through
``models/transformer.py:decode_apply`` with the scalar cursor against a
static-length cache, exactly the step the serving pool runs, so the
pool's greedy streams can be held against ``generate`` token for token.
"""
from __future__ import annotations

import torch

from idunno_tpu_torch.engine.checkpoint import decode_state, encode_state
from idunno_tpu_torch.models.convert import dense_state_dict
from idunno_tpu_torch.models.transformer import (ShardedLM, TransformerLM,
                                                 decode_apply)
from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.ops.sampling import categorical, sample_keep_mask


def decode_model(model: TransformerLM, max_len: int) -> TransformerLM:
    """The serving twin of a model. In the port the decode step is a
    function of the same module (`decode_apply`) and the cache carries its
    own length, so the model itself serves; kept so callers of the JAX
    package's API read the same."""
    del max_len
    return model


def _device_of(model: TransformerLM) -> torch.device:
    return model.ln_f.weight.device


def init_cache(model: TransformerLM, batch: int, max_len: int,
               device: torch.device | str | None = None) -> dict:
    """Zeroed depth-stacked KV cache for a [batch] decode of ≤ max_len
    tokens: ``cached_k``/``cached_v`` [L, batch, max_len, KVH, D] in the
    model's compute dtype (int8 for an int8 cache, which adds f32 ``k_scale``/
    ``v_scale`` [L, batch, max_len, KVH]). A `ShardedLM` gives its
    `ShardedCache` (each shard's part on its own device)."""
    if isinstance(model, ShardedLM):
        return model.init_cache(batch, max_len)
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


def gather_beams(x, parent: torch.Tensor, axis: int = 0):
    """Re-gather the beams of ``x`` (a tensor, or a dict of them, whose
    ``axis`` holds B·W rows in row-major [b0w0..b0wW-1, b1w0, ...] order)
    to follow their parent beams ``parent`` [B, W]."""
    b, w = parent.shape
    flat = (torch.arange(b, device=parent.device)[:, None] * w
            + parent).reshape(-1)
    if isinstance(x, dict):
        return {k: v.index_select(axis, flat) for k, v in x.items()}
    return x.index_select(axis, flat)


@torch.no_grad()
def beam_search(model: TransformerLM, prompt: torch.Tensor, prompt_len: int,
                max_new: int, *, beam_width: int = 4
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decoding with the same KV cache as `generate`.

    prompt int [B, prompt_len] → (sequences int64 [B, prompt_len +
    max_new], total log-prob f32 [B]) of the best beam. The prompt
    prefills the cache at batch B (paid once, not per beam), the cache is
    then replicated to B·W rows, and each generated position keeps the top
    W of the W·V continuations, re-gathering the KV caches to follow their
    parent beams. No EOS handling: every beam has length max_new, so the
    scores are comparable log-probs."""
    if prompt.shape[1] != prompt_len:
        raise ValueError(f"prompt is [B, {prompt.shape[1]}] but "
                         f"prompt_len={prompt_len}; slice/pad upstream")
    dev = _device_of(model)
    b, w = prompt.shape[0], beam_width
    total = prompt_len + max_new
    prompt = prompt.to(dev, torch.int64)

    cache_b = init_cache(model, b, total)
    for t in range(prompt_len - 1):
        decode_apply(model, cache_b, prompt[:, t:t + 1], t)
    # the cache leads with depth: beams run along axis 1
    cache = {k: v.repeat_interleave(w, dim=1) for k, v in cache_b.items()}
    tokens = torch.cat([prompt, torch.zeros((b, max_new), dtype=torch.int64,
                                            device=dev)],
                       dim=1).repeat_interleave(w, dim=0)   # [B*W, total]
    # only beam 0 is live before the first expansion (identical beams
    # would count the same continuation several times)
    scores = torch.where(torch.arange(w, device=dev) == 0,
                         torch.zeros((), device=dev),
                         torch.full((), -1e30, device=dev)).repeat(b)
    for t in range(prompt_len - 1, total - 1):
        logits = decode_apply(model, cache, tokens[:, t:t + 1], t)[:, 0]
        logp = torch.log_softmax(logits.float(), dim=-1)
        vocab = logp.shape[-1]
        cand = (scores[:, None] + logp).reshape(b, w * vocab)
        new_scores, flat_idx = torch.topk(cand, w, dim=-1)  # [B, W]
        parent = flat_idx // vocab                # the beam each came from
        tokens = gather_beams(tokens, parent)
        cache = gather_beams(cache, parent, axis=1)
        tokens[:, t + 1] = (flat_idx % vocab).reshape(-1)
        scores = new_scores.reshape(-1)
    scores = scores.reshape(b, w)
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(b, device=dev)
    return tokens.reshape(b, w, total)[rows, best], scores[rows, best]


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


# -- LM persistence: a servable (config + weights) unit in the store --------
#
# LMs carry their hyperparameters with their weights, so any node can
# rebuild the module and serve `generate` without out-of-band config. The
# config fields are the JAX package's (`_LM_CONFIG_FIELDS` plus the two
# dtypes, by their names); the blob is the port's checkpoint format
# (`engine/checkpoint.py`: JSON header + state dict) under ``lm.pt/<name>``,
# one atomic store object, so any historical version pairs its architecture
# with its own weights. Dense and switch-MoE architectures persist (the MoE
# factory publishes a declarative twin, `models/moe.py:switch_ffn_factory(
# ...).lm_store_ffn`, stored as ``ffn``); a custom attention or a custom
# ``ffn_factory`` is code, not config, and is refused. An expert-parallel
# model's mesh is placement, not config: its experts are stored joined
# (`models/convert.py:dense_state_dict`) and it loads dense.

_LM_CONFIG_FIELDS = ("vocab", "dim", "depth", "num_heads",
                     "num_kv_heads", "causal", "ffn_every",
                     "kv_cache_dtype", "remat")


def lm_store_name(name: str) -> str:
    return f"lm.pt/{name}"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def lm_config(model: TransformerLM) -> dict:
    """The architecture `save_lm` stores beside the weights: the JAX
    package's config fields, the routed FFN's declarative twin as ``ffn``
    (a factory without one gives ``None``, which `save_lm` refuses), and
    the two dtypes, by their names."""
    config = {f: getattr(model, f) for f in _LM_CONFIG_FIELDS}
    if model.ffn_factory is not None:
        ffn = getattr(model.ffn_factory, "lm_store_ffn", None)
        config["ffn"] = None if ffn is None else dict(ffn)
    config["dtype"] = _dtype_name(model.compute_dtype)
    config["param_dtype"] = _dtype_name(model.dtype)
    return config


def save_lm(store, name: str, model: TransformerLM) -> int:
    """Version a TransformerLM (architecture + weights, one atomic object)
    into the replicated store under ``lm.pt/<name>``; returns the store
    version. The JAX package's ``save_lm(store, name, model, params)``
    takes the params apart; the port's model holds its own."""
    if any(blk.attn.attn_fn is not full_attention for blk in model.blocks):
        raise ValueError(
            "save_lm stores models with the default full_attention only "
            "(a custom attn_fn is code, not serializable config; "
            "set_attn_fn(full_attention) before saving if it is "
            "numerically equivalent)")
    config = lm_config(model)
    if model.ffn_factory is not None and config["ffn"] is None:
        raise ValueError(
            "save_lm stores dense or switch-MoE LMs only (this custom "
            "ffn_factory is code, not serializable config)")
    # an expert-parallel model stores its experts joined, as the JAX
    # package stores its params: a stored model loads dense
    return store.put_bytes(lm_store_name(name),
                           encode_state(dense_state_dict(model.state_dict()),
                                        {"lm": config}))


def load_lm(store, name: str, version: int | None = None,
            device: torch.device | str | None = None) -> TransformerLM:
    """Rebuild a stored LM (latest or one historical version) on
    ``device`` (the card unless ``device="cpu"``; no card raises), in eval
    mode with gradients off. Returns the model alone: the JAX package's
    ``load_lm`` returns ``(model, params)``, but the port's model holds its
    own weights."""
    from idunno_tpu_torch.engine.inference import resolve_device

    dev = resolve_device(device)
    blob, _ = store.get_bytes(lm_store_name(name), version=version)
    header, state = decode_state(blob)
    config = header.get("lm")
    if not isinstance(config, dict):
        raise ValueError(f"stored object {lm_store_name(name)!r} is not an "
                         "LM (its header has no 'lm' config)")
    ffn_factory = None
    ffn = config.get("ffn")
    if ffn is not None:
        ffn = dict(ffn)
        kind = ffn.pop("kind", None)
        if kind != "switch":
            raise ValueError(f"stored LM {name!r} uses unknown ffn kind "
                             f"{kind!r}")
        from idunno_tpu_torch.models.moe import switch_ffn_factory
        ffn_factory = switch_ffn_factory(
            n_experts=int(ffn["n_experts"]),
            capacity_factor=float(ffn["capacity_factor"]),
            hidden_ratio=int(ffn["hidden_ratio"]), k=int(ffn["k"]))
    param_dtype = getattr(torch, config["param_dtype"])
    compute_dtype = getattr(torch, config["dtype"])
    with torch.device("meta"):
        model = TransformerLM(
            vocab=config["vocab"], dim=config["dim"], depth=config["depth"],
            num_heads=config["num_heads"],
            num_kv_heads=config["num_kv_heads"], causal=config["causal"],
            ffn_factory=ffn_factory,
            ffn_every=int(config.get("ffn_every", 1)),
            kv_cache_dtype=config["kv_cache_dtype"],
            remat=bool(config.get("remat", False)), dtype=param_dtype,
            compute_dtype=(None if compute_dtype == param_dtype
                           else compute_dtype))
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev).eval().requires_grad_(False)
