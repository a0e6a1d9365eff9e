"""% of the traced sub-window the card spent copying host memory in
(memcpy HtoD device time): the engine's upload of each batch."""


def read(r):
    if r.trace is None or r.trace["window_s"] <= 0:
        return None
    h2d = r.trace["memcpy_s"].get("HtoD", 0.0)
    return 100.0 * h2d / r.trace["window_s"] if h2d > 0 else None
