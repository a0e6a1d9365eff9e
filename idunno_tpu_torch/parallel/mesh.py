"""Device meshes, a port of ``idunno_tpu/parallel/mesh.py``.

The JAX package arranges its chips in a ``jax.sharding.Mesh`` and lets
XLA insert the collectives from sharding annotations. The port keeps the
same single-controller model: one process owns a ``(data, model)`` grid
of torch devices (`Mesh`), and the modules that run over it
(`parallel/sharding.py`, `models/transformer.py:ShardedLM`,
`engine/kv_blocks.py:KVBlockPool(mesh=)`) place each shard on its grid
cell and write the reductions out themselves.

Axis conventions (the JAX package's):
    data   — batch-dimension data parallelism (slots of a decode pool),
             or the sequence of ring and Ulysses attention
    model  — tensor parallelism for wide layers (the Megatron split)
    stage  — pipeline stages (``parallel/pipeline.py``)
    expert — the experts of a routed FFN (``parallel/expert.py``)

A mesh is a grid of two named axes: ``(data, model)`` by default, or
``(data, stage)`` for a pipeline (``axis=STAGE_AXIS``) and ``(data,
expert)`` for expert parallelism (``axis=EXPERT_AXIS``), whose 1-D
stage or expert mesh is the grid of one data row.

A mesh's devices are distinct, as the JAX package's are. The one
exception is a *virtual* mesh, which names one device more than once and
must be asked for (``virtual=True``): every shard then runs on that one
device, so the split math runs whole on a CPU or on one card. It is the
counterpart of the JAX tests' ``--xla_force_host_platform_device_count``.

Several processes (hosts, or processes sharing a host) join through
`initialize_distributed`, a ``torch.distributed`` process group. A mesh
across them (`global_mesh`) names the whole grid and the process that
owns each cell (``Mesh.owners``): processes along the rows (each owns
whole data groups, ``Mesh.local_groups``: data parallelism, and the
sequence of ring and Ulysses attention) or along the columns (each owns
a block of stages or expert shards in every row: pipeline and expert
parallelism). A process runs only its own cells. The data-axis
collectives (``parallel/data.py``) reduce over its rows in process and
then over the processes; `Mesh.along` gives the positions of an axis
with their devices and owners, and every tensor that crosses to another
process goes through ``parallel/transport.py``.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"


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
class AxisCells:
    """The positions along one axis of a mesh, in axis order: position
    ``i`` runs on ``devices[i]`` in process ``ranks[i]``. ``devices[i]``
    is None where another process owns the position (that process names
    its device); ``rank`` is this process."""

    devices: tuple
    ranks: tuple[int, ...]
    rank: int = 0

    def __len__(self) -> int:
        return len(self.ranks)

    def local(self, i: int) -> bool:
        return self.ranks[i] == self.rank

    @property
    def mine(self) -> tuple[int, ...]:
        """The positions this process owns, in axis order."""
        return tuple(i for i, r in enumerate(self.ranks) if r == self.rank)

    @property
    def spans(self) -> bool:
        """Whether the axis crosses processes."""
        return len(set(self.ranks)) > 1

    def span(self, n: int) -> tuple[int, int]:
        """The ``[start, stop)`` of a length-``n`` dim cut evenly over the
        axis that this process's positions hold (they must be
        contiguous)."""
        mine = self.mine
        if not mine or mine != tuple(range(mine[0], mine[-1] + 1)):
            raise MeshShapeError(
                f"positions {mine} of an axis of {len(self)}: a process "
                "holds a contiguous run of positions",
                constraint="contiguous positions a process")
        size = n // len(self)
        return mine[0] * size, (mine[-1] + 1) * size


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of torch devices: ``devices[d][m]`` holds
    model shard ``m`` of data group ``d``. ``virtual`` marks a grid that
    names a device more than once (module docstring). ``owners[d][m]`` is
    the rank of the process that runs cell ``(d, m)`` (None: this process
    runs every cell, a mesh of one process), ``rank`` this process's; the
    cells of other processes name their devices as those processes do,
    and this process never touches them. ``axes`` names the grid's two
    axes: rows, then columns (``(data, stage)``: stage ``s`` of data group
    ``d`` on ``devices[d][s]``)."""

    devices: tuple[tuple[torch.device, ...], ...]
    virtual: bool = False
    owners: tuple[tuple[int, ...], ...] | None = None
    rank: int = 0
    axes: tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def spans_processes(self) -> bool:
        """Whether the grid's cells belong to more than one process."""
        return (self.owners is not None
                and len({r for row in self.owners for r in row}) > 1)

    def owner(self, d: int, m: int) -> int:
        return self.rank if self.owners is None else self.owners[d][m]

    @property
    def local_groups(self) -> tuple[int, ...]:
        """The data groups (rows) that hold a cell of this process, in
        grid order."""
        return tuple(d for d in range(len(self.devices))
                     if any(self.owner(d, m) == self.rank
                            for m in range(len(self.devices[d]))))

    @property
    def shape(self) -> dict[str, int]:
        """Axis extents by name, as ``jax.sharding.Mesh.shape`` gives them."""
        return {self.axes[0]: len(self.devices),
                self.axes[1]: len(self.devices[0])}

    def along(self, axis: str, row: int = 0) -> AxisCells:
        """The positions along ``axis``: each data group's lead cell for
        the row axis, the cells of data group ``row`` for the column axis.
        The sequence of ring and Ulysses attention, the stages of a
        pipeline and the shards of an expert exchange run on them. A mesh
        across processes needs the process group it was made in."""
        if self.spans_processes:
            self._check_group(axis)
        if axis == self.axes[0]:
            cells = [(d, 0) for d in range(len(self.devices))]
        elif axis == self.axes[1]:
            cells = [(row, m) for m in range(len(self.devices[row]))]
        else:
            raise MeshShapeError(f"mesh axes {self.axes} have no {axis!r}",
                                 constraint=f"axis in {self.axes}")
        ranks = tuple(self.owner(d, m) for d, m in cells)
        devices = tuple(self.devices[d][m] if r == self.rank else None
                        for (d, m), r in zip(cells, ranks))
        return AxisCells(devices, ranks, self.rank)

    def _check_group(self, axis: str) -> None:
        """Raise unless this process is rank ``self.rank`` of an
        initialized process group holding every owner of the grid."""
        ranks = sorted({r for row in self.owners for r in row})
        rank, world = process_info()
        if world > 1 and rank == self.rank and ranks[-1] < world:
            return
        where = ("no torch.distributed process group is initialized"
                 if world == 1 else
                 f"this process is rank {rank} of a group of {world}")
        raise MeshShapeError(
            f"the {axis!r} axis of a mesh across processes {ranks} (made "
            f"as rank {self.rank}): {where}; sequence, pipeline and "
            "expert parallelism across processes run inside the process "
            "group the mesh was made in (initialize_distributed, then "
            "global_mesh)", n_devices=len(self.distinct()),
            constraint="an initialized process group holding every owner")

    @property
    def lead(self) -> torch.device:
        """The device of data group 0's model shard 0: where a pool keeps
        its host-facing state and merges its sampling statistics."""
        return self.devices[0][0]

    def distinct(self) -> list[torch.device]:
        """This process's devices of the mesh, each once, in grid order."""
        out: list[torch.device] = []
        for d, row in enumerate(self.devices):
            for m, dev in enumerate(row):
                if self.owner(d, m) == self.rank and dev not in out:
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
              *, virtual: bool = False, axis: str = MODEL_AXIS) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: every visible
    card). The first ``n_data * n_model`` devices fill the grid row by
    row. They must be distinct unless ``virtual=True``. ``axis`` names
    the columns: ``STAGE_AXIS`` makes a (data, stage) mesh of ``n_model``
    stages (JAX: ``Mesh(devices, ("stage",))`` with ``n_data`` 1, or
    ``("data", "stage")``)."""
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
    return Mesh(grid, virtual=n_distinct < need, axes=(DATA_AXIS, axis))


def virtual_mesh(n_data: int, n_model: int, device: torch.device | str,
                 *, axis: str = MODEL_AXIS) -> Mesh:
    """A virtual mesh: every cell of the ``n_data x n_model`` grid is
    ``device`` (module docstring); ``axis`` names the columns."""
    return make_mesh(n_data, n_model, devices=[device] * (n_data * n_model),
                     virtual=True, axis=axis)


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


# -- several processes ------------------------------------------------------
#
# The JAX package joins hosts with ``jax.distributed.initialize``, after
# which ``jax.devices()`` is the global device set. The port joins
# processes in a ``torch.distributed`` process group; each keeps its own
# devices (``_DIST["devices"]``: per process, as the group itself is),
# and `global_mesh` stacks every process's block of the grid into one,
# along the rows or along the columns.

_DIST: dict = {}


def _card_id(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return str(getattr(props, "uuid", "")) or f"{props.name}:{device.index}"


def initialize_distributed(coordinator_address: str,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None) -> None:
    """Join this process to the others (idempotent: a second call keeps
    the first group). ``coordinator_address`` is ``host:port`` (or
    ``tcp://host:port``) where process 0 listens; ``num_processes`` and
    ``process_id`` are this group's size and this process's rank (``python
    -m idunno_tpu_torch --dist-coordinator host:port --dist-num-processes N
    --dist-process-id I``). ``local_device_ids`` are the cards this process
    runs on (default: every visible card; the CPU where there is none).

    Backend rule: NCCL refuses two ranks on one card ("duplicate GPU"), so
    the group takes NCCL only when NCCL is built in and every rank has a
    card of its own (the ranks compare their first cards' identities
    through the coordinator's store before the group is made), and gloo
    otherwise: always on the CPU, and for ranks that share a card, where
    gloo reduces CUDA tensors through the host (correct, slow). The chosen
    backend is printed to standard error."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs num_processes and "
                         "process_id: nothing on this machine tells a "
                         "process its rank")
    addr = coordinator_address.removeprefix("tcp://")
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address {coordinator_address!r}: "
                         "want host:port")
    if torch.cuda.is_available():
        ids = (list(local_device_ids) if local_device_ids is not None
               else list(range(torch.cuda.device_count())))
        devices = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(devices[0])
    else:
        devices = [torch.device("cpu")]
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0)
    card = _card_id(devices[0]) if devices[0].type == "cuda" else ""
    store.set(f"idunno/card/{process_id}", card)
    cards = [store.get(f"idunno/card/{r}").decode()
             for r in range(num_processes)]
    own_cards = all(cards) and len(set(cards)) == len(cards)
    backend = ("nccl" if own_cards and dist.is_nccl_available()
               else "gloo")
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store),
                            rank=process_id, world_size=num_processes)
    _DIST["devices"] = devices
    print(f"initialize_distributed: process {process_id} of "
          f"{num_processes}, backend {backend} (devices "
          f"{[str(d) for d in devices]})", file=sys.stderr, flush=True)


def process_info() -> tuple[int, int]:
    """(process_index, process_count): (0, 1) outside a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_devices() -> list[torch.device]:
    """This process's devices: those it joined the group with, else every
    visible card, else the CPU."""
    return list(_DIST.get("devices") or _visible_devices()
                or [torch.device("cpu")])


def global_mesh(n_model: int = 1, *, axis: str = MODEL_AXIS,
                across: str = DATA_AXIS, devices=None) -> Mesh:
    """A (data, ``axis``) mesh over every process's devices. Each process's
    devices (``devices``, default: those it joined the group with; one
    device named more than once makes a virtual block) form a block of
    ``len(devices) / n_model`` rows by ``n_model`` columns, and the
    blocks stack in rank order along ``across``: the data axis (process
    ``r``'s rows after process ``r - 1``'s: data parallelism, the sequence
    of ring and Ulysses attention) or ``axis`` (its columns after theirs in
    every row: the stages of a pipeline, the shards of an expert axis).
    The mesh's ``owners`` name each cell's process. Call after
    `initialize_distributed`; outside a group it is the mesh of this
    process's devices alone."""
    import torch.distributed as dist

    devices = ([_canonical(d) for d in devices] if devices is not None
               else _local_devices())
    if n_model < 1 or len(devices) % n_model:
        raise MeshShapeError(
            f"{len(devices)} local devices not divisible by model axis "
            f"{n_model}", n_devices=len(devices), n_model=n_model,
            constraint=f"n_model must divide {len(devices)} devices a "
                       "process")
    if across not in (DATA_AXIS, axis):
        raise MeshShapeError(
            f"processes along {across!r}: want {DATA_AXIS!r} or {axis!r}",
            constraint=f"across in ({DATA_AXIS!r}, {axis!r})")
    virtual = len(set(devices)) < len(devices)
    rows_per = len(devices) // n_model
    rank, world = process_info()
    if world == 1:
        return make_mesh(rows_per, n_model, devices=devices,
                         virtual=virtual, axis=axis)
    names: list[list[str]] = [None] * world
    dist.all_gather_object(names, [str(d) for d in devices])
    if len({len(n) for n in names}) != 1:
        raise MeshShapeError(
            f"processes hold {[len(n) for n in names]} devices; a global "
            "mesh needs the same count in each", n_devices=len(devices),
            n_model=n_model, constraint="equal devices per process")
    blocks = [[tuple(torch.device(n) for n in proc[r * n_model:
                                                   (r + 1) * n_model])
               for r in range(rows_per)] for proc in names]
    if across == DATA_AXIS:
        grid = tuple(row for block in blocks for row in block)
        owners = tuple((r,) * n_model for r in range(world)
                       for _ in range(rows_per))
    else:
        grid = tuple(tuple(dev for block in blocks for dev in block[i])
                     for i in range(rows_per))
        owners = tuple(tuple(r for r in range(world) for _ in range(n_model))
                       for _ in range(rows_per))
    return Mesh(grid, virtual=virtual, owners=owners, rank=rank,
                axes=(DATA_AXIS, axis))
