"""What the LM drivers share: the program's model and serving pool built
from a configuration and a mix, its counters read at a boundary, and the
output check of served tokens.

The check takes a sample of the finished requests, drawn from the seed
with the longest among them, and runs the float32 reference
(``reference/gpt2.py``) once over each prompt with its served tokens.
``logit_gap`` is the widest gap, over every served token, by which the
reference's logit of the served token lies below the reference's best at
that position, and ``logit_gap_mean`` that gap's mean over the served
tokens. The control puts the fp8 reference in the program's place:
at each position of the same sequences, the gap of the token that the fp8
reference puts first.
"""
from __future__ import annotations

import torch

from perfbench import harness, traffic, weights


def build_model(cell, seed: int, device, *, dtype=torch.bfloat16,
                compute_dtype=None, attn: str | None = None):
    """The program's ``TransformerLM`` at the configuration's widths,
    holding the seeded weights (made on the device in ``dtype``)."""
    from idunno_tpu_torch.models.transformer import (TransformerLM,
                                                     make_attn_fn)

    c = cell.config
    if c["n_inner"] != 4 * c["n_embd"]:
        raise ValueError("the program's block has an MLP ratio of 4")
    kw = {} if attn is None else {"attn_fn": make_attn_fn(attn)}
    with torch.device(device):
        model = TransformerLM(vocab=c["vocab_size"], dim=c["n_embd"],
                              depth=c["n_layer"], num_heads=c["n_head"],
                              causal=True, dtype=dtype,
                              compute_dtype=compute_dtype, **kw)
    model.load_state_dict(seeded(cell, seed, device, dtype))
    return model


def seeded(cell, seed: int, device, dtype) -> dict:
    return weights.make(weights.lm_shapes(cell.config), seed, device, dtype,
                        depth=cell.config["n_layer"])


def build_pool(model, pool: dict, device):
    from idunno_tpu_torch.engine.serve_lm import DecodeServer

    return DecodeServer(
        model.eval().requires_grad_(False), slots=pool["slots"],
        prompt_len=pool["prompt_len"], max_len=pool["max_len"],
        decode_steps=pool["decode_steps"],
        kv_block_size=pool["kv_block_size"], paged_kernel="auto",
        prompt_buckets=tuple(pool.get("prompt_buckets") or ()),
        device=device)


def counters(srv) -> dict:
    """The pool's counters at a boundary: tokens generated by retired and
    live rows, admissions, prompt tokens the radix cache saved."""
    st = srv.stats()
    live = sum(len(r["tokens"]) - r["prompt_len"] for r in srv.snapshot())
    pc = st.get("prefix_cache", {})
    return {"generated": st["tokens_generated"] + live,
            "admitted": st["admitted"],
            "cached_tokens_saved": pc.get("cached_tokens_saved", 0)}


def sample(seed: int, finished: list, n: int) -> list:
    """``n`` of the finished (prompt, served) pairs, drawn from the seed,
    the one with the most served tokens always among them."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rest = [i for i in range(len(finished)) if i != longest]
    gen = traffic.rng(seed, "sample")
    pick = list(gen.permutation(rest)[:max(0, n - 1)])
    return [finished[i] for i in [longest] + pick]


@torch.no_grad()
def served_check(cell, seed: int, device, picked: list, control: bool,
                 batch: int = 4) -> dict:
    """``logit_gap`` and ``logit_gap_mean`` (and with ``control`` the
    control's) over the picked (prompt, served tokens) pairs;
    ``served_tokens`` counts the tokens compared."""
    from perfbench.reference import common, gpt2

    common.strict_f32()
    cfg = cell.config
    w = {k: v.float() for k, v in seeded(cell, seed, device,
                                         torch.bfloat16).items()}
    out = {"logit_gap": 0.0, "served_tokens": 0}
    total = ctotal = 0.0
    if control:
        out["control.logit_gap"] = 0.0
    for lo in range(0, len(picked), batch):
        group = picked[lo:lo + batch]
        seqs = [p + s[:-1] for p, s in group]
        t = max(len(s) for s in seqs)
        toks = torch.zeros((len(seqs), t), dtype=torch.int64, device=device)
        for i, s in enumerate(seqs):
            toks[i, :len(s)] = torch.tensor(s, device=device)
        rows, cols, served = [], [], []
        for i, (p, s) in enumerate(group):
            rows += [i] * len(s)
            cols += list(range(len(p) - 1, len(p) - 1 + len(s)))
            served += s
        rows_t = torch.tensor(rows, device=device)
        cols_t = torch.tensor(cols, device=device)
        served_t = torch.tensor(served, device=device)
        h = gpt2.hidden(w, cfg, toks)[rows_t, cols_t]
        ref = gpt2.head(w, h)
        best = ref.max(-1).values
        gap = best - ref.gather(1, served_t[:, None])[:, 0]
        out["logit_gap"] = max(out["logit_gap"], float(gap.max()))
        out["served_tokens"] += len(served)
        total += float(gap.double().sum())
        if control:
            hc = gpt2.hidden(w, cfg, toks, fp8=True)[rows_t, cols_t]
            pick = gpt2.head(w, hc, fp8=True).argmax(-1)
            cgap = best - ref.gather(1, pick[:, None])[:, 0]
            out["control.logit_gap"] = max(out["control.logit_gap"],
                                           float(cgap.max()))
            ctotal += float(cgap.double().sum())
        del h, ref
    n = max(out["served_tokens"], 1)
    out["logit_gap_mean"] = total / n
    if control:
        out["control.logit_gap_mean"] = ctotal / n
    harness.free_device(device)
    return out
