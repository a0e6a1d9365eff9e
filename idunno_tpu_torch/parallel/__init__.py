"""Parallelism, a port of ``idunno_tpu/parallel/``.

Only the single-device half of expert routing is here so far
(``parallel/expert.py:switch_dispatch``); meshes, sharding, sequence,
pipeline and expert parallelism come with the parallelism slice
(ROADMAP.md §1, step 3).
"""
