"""ImageNet category names.

The reference downloads ``imagenet_classes.txt`` from the pytorch hub repo at
call time (`alexnet_resnet.py:29-38`) and maps top-1 indices to names
(`:41-42, 87`). We load the same file if it exists locally (search path:
$IDUNNO_IMAGENET_CLASSES, ./imagenet_classes.txt), else fall back to synthetic
``class_<idx>`` names — zero-egress environments must still classify.
"""
from __future__ import annotations

import functools
import os


@functools.lru_cache(maxsize=1)
def imagenet_categories() -> tuple[str, ...]:
    for path in (os.environ.get("IDUNNO_IMAGENET_CLASSES"),
                 "imagenet_classes.txt"):
        if path and os.path.exists(path):
            with open(path) as f:
                names = tuple(s.strip() for s in f if s.strip())
            if len(names) >= 1000:
                return names[:1000]
    return tuple(f"class_{i}" for i in range(1000))
