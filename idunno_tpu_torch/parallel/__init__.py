"""Parallelism, a port of ``idunno_tpu/parallel/``.

Device meshes (``parallel/mesh.py``: a ``(data, model)`` or ``(data,
stage)`` grid of devices, virtual meshes over one device, meshes across
``torch.distributed`` processes), the data-axis collectives
(``parallel/data.py``: batches cut over the data groups, gradient and
BatchNorm reductions, the FSDP gather), the sharding policies
(``parallel/sharding.py``: the Megatron split of the LM, the CNN specs
and the column split of wide layers) that tensor-parallel decode runs
over (``models/transformer.py:ShardedLM``), sequence parallelism (ring
attention, ``parallel/ring_attention.py``, and Ulysses,
``parallel/ulysses.py``), the GPipe schedule (``parallel/pipeline.py``)
and expert routing (``parallel/expert.py``: ``switch_dispatch``, and
``expert_parallel_apply``, the all-to-all exchange over an expert axis).
Across processes every tensor crosses through ``parallel/transport.py``.
``ring_attention`` is not re-exported here: the name would hide its
module, ``parallel.ring_attention``.
"""
from idunno_tpu_torch.parallel.mesh import (  # noqa: F401
    EXPERT_AXIS, STAGE_AXIS, local_mesh, make_mesh, virtual_mesh)
from idunno_tpu_torch.parallel.pipeline import pipeline_apply  # noqa: F401
from idunno_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
