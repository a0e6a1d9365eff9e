"""The model step's share of the card's bf16 peak: images classified in
the window times the ViT's forward FLOPs an image
(``counters.vit_forward_flops``), over the window."""
from perfbench.counters import vit_forward_flops
from perfbench.readers import mfu


def read(r):
    return mfu(r, r.counters["images"] * vit_forward_flops(r.config))
