"""Device meshes, a port of ``idunno_tpu/parallel/mesh.py``.

The JAX package arranges its chips in a ``jax.sharding.Mesh`` and lets
XLA insert the collectives from sharding annotations. The port keeps the
same single-controller model: one process owns a ``(data, model)`` grid
of torch devices (`Mesh`), and the modules that run over it
(`parallel/sharding.py`, `models/transformer.py:ShardedLM`,
`engine/kv_blocks.py:KVBlockPool(mesh=)`) place each shard on its grid
cell and write the reductions out themselves.

Axis conventions (the JAX package's):
    data   — batch-dimension data parallelism (slots of a decode pool)
    model  — tensor parallelism for wide layers (the Megatron split)

A mesh's devices are distinct, as the JAX package's are. The one
exception is a *virtual* mesh, which names one device more than once and
must be asked for (``virtual=True``): every shard then runs on that one
device, so the split math runs whole on a CPU or on one card. It is the
counterpart of the JAX tests' ``--xla_force_host_platform_device_count``.

Collectives over ``torch.distributed`` processes, multi-host bring-up
(`initialize_distributed`, `global_mesh`, `process_info`) come with data
parallelism (ROADMAP.md §1, step 3b) and raise until then.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class MeshShapeError(ValueError):
    """A requested (data, model) mesh shape cannot be built.

    Typed (not bare ValueError) so callers can branch on "the mesh itself
    is impossible" — wrong device count, non-dividing ``n_model``, or a
    model axis the attention-head geometry can't split over — separately
    from ordinary bad-argument errors. Carries the numbers that explain
    the refusal:

        n_devices  visible/offered device count (0 if not device-related)
        n_model    requested model-axis extent
        constraint one-line statement of the violated rule
    """

    def __init__(self, msg: str, *, n_devices: int = 0, n_model: int = 1,
                 constraint: str = ""):
        super().__init__(msg)
        self.n_devices = n_devices
        self.n_model = n_model
        self.constraint = constraint


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of torch devices: ``devices[d][m]`` holds
    model shard ``m`` of data group ``d``. ``virtual`` marks a grid that
    names a device more than once (module docstring)."""

    devices: tuple[tuple[torch.device, ...], ...]
    virtual: bool = False

    @property
    def shape(self) -> dict[str, int]:
        """Axis extents by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {DATA_AXIS: len(self.devices),
                MODEL_AXIS: len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        """The device of data group 0's model shard 0: where a pool keeps
        its host-facing state and merges its sampling statistics."""
        return self.devices[0][0]

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in grid order."""
        out: list[torch.device] = []
        for row in self.devices:
            for dev in row:
                if dev not in out:
                    out.append(dev)
        return out


def _visible_devices() -> list[torch.device]:
    """Every card this process sees (the JAX package's ``jax.devices()``);
    none where there is no card."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev


def make_mesh(n_data: int, n_model: int = 1, devices: list | None = None,
              *, virtual: bool = False) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: every visible
    card). The first ``n_data * n_model`` devices fill the grid row by
    row. They must be distinct unless ``virtual=True``."""
    if n_data < 1 or n_model < 1:
        raise MeshShapeError(
            f"mesh {n_data}x{n_model}: both extents must be >= 1",
            n_model=n_model, constraint="n_data >= 1 and n_model >= 1")
    devices = [_canonical(d) for d in (
        devices if devices is not None else _visible_devices())]
    need = n_data * n_model
    if need > len(devices):
        raise MeshShapeError(
            f"mesh {n_data}x{n_model} needs {need} devices, "
            f"have {len(devices)}",
            n_devices=len(devices), n_model=n_model,
            constraint=f"n_data*n_model <= {len(devices)} devices")
    picked = devices[:need]
    n_distinct = len(set(picked))
    if n_distinct < need and not virtual:
        raise MeshShapeError(
            f"mesh {n_data}x{n_model} names {need} devices but only "
            f"{n_distinct} are distinct ({sorted(set(map(str, picked)))}); "
            "pass virtual=True to run every shard on a shared device",
            n_devices=n_distinct, n_model=n_model,
            constraint=f"n_data*n_model <= {n_distinct} distinct devices "
                       "(or virtual=True)")
    grid = tuple(tuple(picked[d * n_model:(d + 1) * n_model])
                 for d in range(n_data))
    return Mesh(grid, virtual=n_distinct < need)


def virtual_mesh(n_data: int, n_model: int,
                 device: torch.device | str) -> Mesh:
    """A virtual mesh: every cell of the ``n_data x n_model`` grid is
    ``device`` (module docstring)."""
    return make_mesh(n_data, n_model, devices=[device] * (n_data * n_model),
                     virtual=True)


def local_mesh(n_model: int = 1) -> Mesh:
    """Mesh over every visible card, data-parallel by default."""
    n = len(_visible_devices())
    if n_model < 1 or n == 0 or n % n_model:
        raise MeshShapeError(
            f"{n} devices not divisible by model axis {n_model}",
            n_devices=n, n_model=n_model,
            constraint=f"n_model must divide {n} devices")
    return make_mesh(n // n_model, n_model)


def check_head_divisibility(num_heads: int, n_model: int) -> None:
    """Attention-head constraint for a model-axis of ``n_model``: Q heads
    must split evenly (Megatron column-parallel QKV). Raises the typed
    MeshShapeError naming the constraint; KV heads are handled separately
    (divide-or-replicate, see `parallel/sharding.py:lm_tp_specs`)."""
    if n_model > 1 and num_heads % n_model:
        raise MeshShapeError(
            f"num_heads={num_heads} not divisible by model axis "
            f"{n_model}",
            n_model=n_model,
            constraint=f"num_heads % n_model == 0 "
                       f"(got {num_heads} % {n_model})")


def _step_3b(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: it comes with data "
                      "parallelism and multi-host init (ROADMAP.md §1, "
                      "step 3b)")


def initialize_distributed(coordinator_address: str,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None) -> None:
    """Multi-host bring-up: raises until step 3b."""
    raise _step_3b("initialize_distributed (multi-host init)")


def global_mesh(n_model: int = 1) -> Mesh:
    """A mesh over every process's devices: raises until step 3b."""
    raise _step_3b("global_mesh (a mesh across processes)")


def process_info() -> tuple[int, int]:
    """(process_index, process_count): raises until step 3b."""
    raise _step_3b("process_info (the multi-process runtime)")
