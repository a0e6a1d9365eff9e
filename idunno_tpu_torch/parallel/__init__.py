"""Parallelism, a port of ``idunno_tpu/parallel/``.

Here so far: device meshes (``parallel/mesh.py``: a ``(data, model)``
grid of devices, virtual meshes over one device), the sharding policies
(``parallel/sharding.py``: the Megatron split of the LM, the CNN specs)
that tensor-parallel decode runs over (``models/transformer.py:
ShardedLM``), and the single-device half of expert routing
(``parallel/expert.py:switch_dispatch``). Multi-host init, data
parallelism and FSDP, sequence, pipeline and expert parallelism come
later (ROADMAP.md §1, step 3).
"""
