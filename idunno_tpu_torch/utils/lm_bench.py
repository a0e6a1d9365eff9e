"""The LM configuration and the shared-prefix serving workload of the JAX
package's LM bench (``idunno_tpu/utils/lm_bench.py``).

``lm_bench_config`` returns the full-width sizes the JAX bench runs on a
TPU: a ``TransformerLM`` of dim 1024, depth 12, 16 heads and vocab 32768
(218,298,368 parameters), and its serving and prefill shapes.
``prefix_bench_workload`` builds the shared-prefix prompts from a numpy
seed, so the port and the JAX package serve the same token streams.
"""
from __future__ import annotations

import numpy as np


def lm_bench_config() -> dict:
    """Model/workload sizing at full width: the JAX bench's TPU config,
    the keys this package's paths read."""
    return {
        "dim": 1024,
        "depth": 12,
        "heads": 16,
        "vocab": 32768,
        "slots": 16,
        "prompt_len": 64,
        "max_len": 512,
        "decode_steps": 128,
        "prefill_batch": 4,
        "prefill_seq": 1024,
    }


def prefix_bench_workload(cfg: dict, block_size: int
                          ) -> tuple[list[list[int]], int, tuple[int, ...]]:
    """(prompts, shared_prefix_len, prompt_buckets) for the shared-prefix
    serving workload: ``3·slots`` full-length prompts sharing a block-
    aligned head of ~3/4 prompt_len (a system/few-shot prompt) with
    unique tails. The bucket ladder lets a radix hit prefill only its
    tail at the small bucket while a cache-off pool pays the full bucket
    every admission."""
    pl = cfg["prompt_len"]
    shared_len = max(block_size, (pl * 3 // 4) // block_size * block_size)
    if shared_len >= pl:
        shared_len = max(0, pl - block_size)
    buckets = tuple(sorted({pl, max(1, pl // 2), max(1, pl - shared_len)}))
    rng = np.random.default_rng(7)
    head = [int(t) for t in rng.integers(1, cfg["vocab"], size=shared_len)]
    prompts = []
    for _ in range(cfg["slots"] * 3):
        tail = [int(t) for t in rng.integers(1, cfg["vocab"],
                                             size=pl - shared_len)]
        prompts.append(head + tail)
    return prompts, shared_len, buckets


def serving_max_new(cfg: dict) -> int:
    """``max_new`` of the shared-prefix serving phase: one decode dispatch
    plus the prefill's token, within the cache (the JAX bench's rule)."""
    return min(cfg["decode_steps"] + 1, cfg["max_len"] - cfg["prompt_len"])
