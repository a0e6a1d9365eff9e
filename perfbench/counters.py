"""The work a cell does, counted from shapes: operations (FLOPs, a
multiply-add counted as two) and bytes of device memory traffic.

Copied from the program's own counters where they were sound, so that the
yardstick does not move when the program does:
``idunno_tpu_torch/bench.py:vit_forward_flops`` (ViT, ≈9.2 GFLOP an image
for ViT-S/16) and ``idunno_tpu_torch/utils/train_bench.py:
lm_flops_per_token`` (6N + an attention term a trained token). Two
departures, both lowering the count to what the inputs need: the token
embedding is a gather and does no multiply, so the LM's N is the weights
that enter a matrix product (the head among them); and causal attention
needs on average half the keys of each query, so its term is half of the
non-causal 12·T·d·L.

Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again.
"""
from __future__ import annotations


def vit_forward_flops(cfg: dict) -> float:
    """Forward FLOPs an image of a ViT configuration (``configs/vit-*``):
    the patch embedding, then per block qkv and projection 8·T·d², MLP
    2·2·r·T·d² and attention scores and their application 4·T²·d, then the
    head on the class token. LayerNorm and softmax are left out."""
    n = (cfg["img_size"] // cfg["patch_size"]) ** 2
    t = n + 1
    d, r = cfg["embed_dim"], cfg["mlp_ratio"]
    total = 2.0 * n * (cfg["patch_size"] ** 2 * cfg["in_chans"]) * d
    total += cfg["depth"] * (2.0 * (4 + 2 * r) * t * d * d
                             + 4.0 * t * t * d)
    total += 2.0 * d * cfg["num_classes"]
    return total


def lm_matmul_params(cfg: dict) -> int:
    """Weights of an LM configuration (``configs/gpt2-*``) that enter a
    matrix product: per block q, k, v, out (4·d²) and the MLP (2·d·ff),
    plus the head (d·V). The token embedding is a gather."""
    d, ff = cfg["n_embd"], cfg["n_inner"]
    return cfg["n_layer"] * (4 * d * d + 2 * d * ff) + d * cfg["vocab_size"]


def decode_flops_per_token(cfg: dict) -> float:
    """FLOPs of one generated or prefilled token through the weights:
    2·N. The attention over the cached context is left out."""
    return 2.0 * lm_matmul_params(cfg)


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """FLOPs of one trained token: forward 2N and backward 4N through the
    weights, plus causal attention, 2·T·d a block forward (half of the
    non-causal 4·T·d) and twice that backward."""
    return (6.0 * lm_matmul_params(cfg)
            + 6.0 * seq * cfg["n_embd"] * cfg["n_layer"])


def k1_bytes(batch: int, crop: int, channels: int = 3) -> float:
    """K1 (crop and normalise): the uint8 crop read once, the bf16 NHWC
    crop written once."""
    return batch * crop * crop * channels * (1 + 2)


def attention_cost(b: int, t: int, h: int, d: int, *, causal: bool,
                   backward: bool = False, itemsize: int = 2
                   ) -> tuple[float, float]:
    """(FLOPs, bytes) of attention over [b, t, h, d] in ``itemsize``-byte
    elements. Forward: QKᵀ and PV, 4·t²·d a head, q, k and v read, o
    written. With ``backward``: the forward plus the backward's dV, dP, dQ
    and dK products (8·t²·d a head, no recompute counted), q, k, v, o and
    dO read and dQ, dK, dV written. Causal attention needs half the
    products."""
    pairs = b * h * t * t * d * (0.5 if causal else 1.0)
    tensor = b * t * h * d * itemsize
    if not backward:
        return 4.0 * pairs, 4.0 * tensor
    return 12.0 * pairs, 4.0 * tensor + 8.0 * tensor


def kv_bytes_per_token(cfg: dict, itemsize: int = 2) -> float:
    """Bytes of one token's keys and values in one layer."""
    return 2.0 * cfg["n_embd"] * itemsize
