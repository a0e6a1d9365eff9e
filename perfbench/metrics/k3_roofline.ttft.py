"""K3 (paged attention) in the chat pool against its roofline: the keys
and values of the radix-hit chain that each live row reads in each layer
of each decode step, and each admission's suffix prefill reads once a
layer, read once, at the card's HBM bandwidth, over K3's traced device
time. A live row's chain is the pool's mean hit over the window (every
request of the mix hits its system prompt); rows that hold no request
are not counted."""
from perfbench.counters import kv_bytes_per_token
from perfbench.readers import K3, roofline, traced_delta


def read(r):
    generated = traced_delta(r, "generated")
    if not generated:
        return None
    c = r.config
    nbytes = (generated * r.counters["mean_hit"] * c["n_layer"]
              * kv_bytes_per_token(c))
    return roofline(r, K3, 0.0, nbytes, calls=1)
