"""K1 (crop and normalise) against its roofline: per call the engine
batch's uint8 crop read and its bf16 crop written (``counters.k1_bytes``)
at the card's HBM bandwidth, over K1's traced device time."""
from perfbench.counters import k1_bytes
from perfbench.readers import K1, roofline


def read(r):
    return roofline(r, K1, 0.0, k1_bytes(r.traffic["engine_batch"],
                                         r.config["img_size"]))
