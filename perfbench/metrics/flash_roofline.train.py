"""K2, K4 and K5 (flash attention forward and backward) in the train step
against their roofline: per layer and step the causal attention of the
batch forward and backward (``counters.attention_cost``), over the three
kernels' traced device time. A layer's backward is one K4 call."""
from perfbench.counters import attention_cost
from perfbench.readers import K2, K4, K5, roofline
from perfbench.trace import kernel_seconds


def read(r):
    if r.trace is None:
        return None
    c, t = r.config, r.traffic
    flops, nbytes = attention_cost(t["batch"], t["seq"], c["n_head"],
                                   c["n_embd"] // c["n_head"], causal=True,
                                   backward=True)
    calls = kernel_seconds(r.trace, K4)[1]
    return roofline(r, K2 + K4 + K5, flops, nbytes, calls=calls)
