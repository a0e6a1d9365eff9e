"""Seeded weights, made on the device in one draw.

Both sides of a cell get the same weights: the program in the dtype it
serves or trains in, the reference the same values in float32. The
parameter names and layouts are the ones the program's modules take
(``weight`` [out, in] as ``nn.Linear`` holds it), so a state dict goes to
the program as it is; the reference reads the same names.

One ``torch.randn`` call fills a flat buffer from a ``torch.Generator``
seeded with ``--seed`` on the device; each parameter is a view of it,
scaled and shifted in place: matrices, embeddings and position tables
with std 0.02, the residual branch's output projections with
0.02/sqrt(2·depth) (GPT-2's own initialisation), biases with std 0.02,
LayerNorm scales 1 + 0.05·n and offsets 0.02·n.
"""
from __future__ import annotations

import math

import torch

STD = 0.02


def vit_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every ViT parameter, in the names of
    ``idunno_tpu_torch/models/vit.py:ViT``."""
    d, p, c = cfg["embed_dim"], cfg["patch_size"], cfg["in_chans"]
    ff = int(d * cfg["mlp_ratio"])
    n = (cfg["img_size"] // p) ** 2
    out = [("cls", (1, 1, d), "normal"), ("pos_embed", (1, n + 1, d), "normal"),
           ("embed.weight", (d, c, p, p), "normal"), ("embed.bias", (d,), "bias")]
    for i in range(cfg["depth"]):
        out += _block(f"blocks.{i}.", d, ff, "normal")
    out += [("ln_f.weight", (d,), "ln_scale"), ("ln_f.bias", (d,), "bias"),
            ("head.weight", (cfg["num_classes"], d), "normal"),
            ("head.bias", (cfg["num_classes"],), "bias")]
    return out


def lm_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every LM parameter, in the names of
    ``idunno_tpu_torch/models/transformer.py:TransformerLM``."""
    d, ff, v = cfg["n_embd"], cfg["n_inner"], cfg["vocab_size"]
    out = [("embed.weight", (v, d), "normal")]
    for i in range(cfg["n_layer"]):
        out += _block(f"blocks.{i}.", d, ff, "residual")
    out += [("ln_f.weight", (d,), "ln_scale"), ("ln_f.bias", (d,), "bias"),
            ("head.weight", (v, d), "normal"), ("head.bias", (v,), "bias")]
    return out


def _block(pre: str, d: int, ff: int, out_kind: str) -> list:
    return [(pre + "ln1.weight", (d,), "ln_scale"), (pre + "ln1.bias", (d,), "bias"),
            (pre + "attn.q.weight", (d, d), "normal"), (pre + "attn.q.bias", (d,), "bias"),
            (pre + "attn.k.weight", (d, d), "normal"), (pre + "attn.k.bias", (d,), "bias"),
            (pre + "attn.v.weight", (d, d), "normal"), (pre + "attn.v.bias", (d,), "bias"),
            (pre + "attn.out.weight", (d, d), out_kind),
            (pre + "attn.out.bias", (d,), "bias"),
            (pre + "ln2.weight", (d,), "ln_scale"), (pre + "ln2.bias", (d,), "bias"),
            (pre + "mlp_up.weight", (ff, d), "normal"), (pre + "mlp_up.bias", (ff,), "bias"),
            (pre + "mlp_down.weight", (d, ff), out_kind),
            (pre + "mlp_down.bias", (d,), "bias")]


def make(shapes: list, seed: int, device, dtype: torch.dtype,
         depth: int = 1) -> dict[str, torch.Tensor]:
    """The seeded parameters of ``shapes`` on ``device`` in ``dtype``:
    views of one flat buffer drawn in one call."""
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    scale = {"normal": (STD, 0.0), "residual": (STD / math.sqrt(2 * depth), 0.0),
             "bias": (STD, 0.0), "ln_scale": (0.05, 1.0)}
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        std, mean = scale[kind]
        view = flat[at:at + n].view(shape)
        view.mul_(std).add_(mean)
        out[name] = view
        at += n
    return out
