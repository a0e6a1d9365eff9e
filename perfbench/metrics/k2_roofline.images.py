"""K2 (flash attention forward) in the ViT against its roofline: per call
the non-causal attention of the engine batch over the class token and
the patches, [B, T, heads, head_dim] (``counters.attention_cost``), over
K2's traced device time."""
from perfbench.counters import attention_cost
from perfbench.readers import K2, roofline


def read(r):
    c = r.config
    t = (c["img_size"] // c["patch_size"]) ** 2 + 1
    flops, nbytes = attention_cost(r.traffic["engine_batch"], t,
                                   c["num_heads"],
                                   c["embed_dim"] // c["num_heads"],
                                   causal=False)
    return roofline(r, K2, flops, nbytes)
