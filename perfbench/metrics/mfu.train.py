"""The train step's share of the card's bf16 peak: trained tokens in the
window times 6·N plus causal attention a token
(``counters.train_flops_per_token``), over the window."""
from perfbench.counters import train_flops_per_token
from perfbench.readers import mfu


def read(r):
    c = r.counters
    return mfu(r, c["tokens"] * train_flops_per_token(r.config, c["seq"]))
