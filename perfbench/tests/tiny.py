"""The benchmark's cells at sizes the CPU tests can hold: each cell with
its configuration and mix cut down, its limits and metrics as they are.
The image and train cells, built but not yet in ``BENCHMARK.json``, are
loaded from their files by name with their end-to-end metric."""
from __future__ import annotations

import copy

from perfbench import spec

CONFIGS = {
    "vit": {"img_size": 32, "patch_size": 16, "embed_dim": 32, "depth": 1,
            "num_heads": 2, "num_classes": 10},
    "lm": {"n_embd": 64, "n_layer": 2, "n_head": 2, "n_inner": 256,
           "vocab_size": 97},
}
TRAFFIC = {
    "image_closed_loop": {"query_images": 8, "distinct_queries": 2,
                          "stored_image_size": 36, "engine_batch": 4},
    "lm_open_loop": {"rate_per_s": 20.0, "system_prompts": 2,
                     "system_prompt_tokens": 32, "tail_tokens": [8, 24],
                     "new_tokens": [4, 8],
                     "pool": {"slots": 4, "prompt_len": 56, "max_len": 72,
                              "decode_steps": 2, "kv_block_size": 8,
                              "prompt_buckets": [8, 16, 24, 40, 48, 56]},
                     "tail_seconds": 1, "drain_seconds": 30, "check": {"requests": 4}},
    "lm_closed_loop": {"clients": 4, "prompt_tokens": 16, "new_tokens": 12,
                       "pool": {"slots": 4, "prompt_len": 16, "max_len": 32,
                                "decode_steps": 2, "kv_block_size": 8,
                                "prompt_buckets": [16]},
                       "check": {"requests": 3}},
    "lm_train": {"batch": 4, "seq": 16, "batches": 4, "reference_rows": 2},
}


# cells whose files are in perfbench/ but not in BENCHMARK.json
BUILT = {"vit-s16.bulk": ("images_per_s", "images/s"),
         "gpt2-medium.train": ("train_tokens_per_s", "tokens/s")}


def full(name: str) -> spec.Cell:
    """The cell ``name`` at its own size."""
    if name not in BUILT:
        return spec.find_cell(name)
    config, traffic = name.split(".")
    metric, unit = BUILT[name]
    return spec.load_cell(name, config, traffic, end_to_end=[
        {"name": "setup_s", "unit": "s"}, {"name": metric, "unit": unit}])


def cell(name: str, **traffic) -> spec.Cell:
    """The cell ``name`` cut to CPU size; ``traffic`` overrides the mix."""
    c = copy.deepcopy(full(name))
    c.config.update(CONFIGS[c.config["family"]])
    c.traffic.update(copy.deepcopy(TRAFFIC[c.traffic["driver"]]))
    c.traffic.update(traffic)
    return c
