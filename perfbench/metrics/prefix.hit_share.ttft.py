"""% of the prompt tokens admitted in the window whose prefill the radix
cache saved (``prefix_cache_stats()["cached_tokens_saved"]``)."""


def read(r):
    c = r.counters
    if not c.get("prompt_tokens"):
        return None
    return 100.0 * c["cached_tokens_saved"] / c["prompt_tokens"]
