"""Parallelism, a port of ``idunno_tpu/parallel/``.

Here so far: device meshes (``parallel/mesh.py``: a ``(data, model)``
grid of devices, virtual meshes over one device, meshes across
``torch.distributed`` processes), the data-axis collectives
(``parallel/data.py``: batches cut over the data groups, gradient and
BatchNorm reductions, the FSDP gather), the sharding policies
(``parallel/sharding.py``: the Megatron split of the LM, the CNN specs
and the column split of wide layers) that tensor-parallel decode runs
over (``models/transformer.py:ShardedLM``), and the single-device half of
expert routing (``parallel/expert.py:switch_dispatch``). Sequence,
pipeline and expert parallelism come later (ROADMAP.md §1, step 3).
"""
