"""The data axis: the collectives XLA inserts for the JAX package, written
out for the port.

The JAX package puts a batch on the mesh with its leading dim split over
the data axis (``idunno_tpu/parallel/sharding.py:shard_batch``), replicates
the weights (``replicate``), and lets ``jit`` insert every reduction over
the data axis: the gradient mean of a data-parallel step, the global
BatchNorm statistics, the FSDP gathers and scatters. The port runs one
process over its rows of a `parallel/mesh.py:Mesh` (``mesh.local_groups``)
and does these reductions itself: in process over its data groups (a sum
on the lead device of the groups' devices), then over the processes with
``torch.distributed`` (``all_reduce``, ``all_gather``, through
``parallel/transport.py``).

What lives here:

- `shard_batch` / `replicate` / `from_process_local`: a global batch cut
  into the local groups' rows, a module copied onto each local group's
  lead device, and the counterpart of
  ``jax.make_array_from_process_local_data`` (this process's rows cut
  over its groups);
- `all_reduce_sum` (a sum over processes that autograd differentiates:
  its backward is the same sum of the incoming gradients) and
  `reduce_gradients` (in process, then over processes);
- `GroupSync`: the groups of one process meet at a barrier where one of
  them sums what each brings (and sums it over processes). BatchNorm
  under a data-parallel step (``models/resnet.py:BatchNorm2d``) sums its
  per-channel sums, sums of squares and counts through it, so every
  group normalizes with the global batch's statistics, as ``jit`` over a
  data-sharded batch does; the groups then run in threads, in lockstep
  (`run_groups`);
- `DropoutPlan`: one dropout mask per layer for the global batch, drawn
  from a generator keyed by the step and the layer's call, of which each
  group keeps its rows (``models/mixed.py:Dropout``), so a data-parallel
  step equals the one-group step on the same batch;
- `gather_rows`: the FSDP gather across processes (``all_gather``; its
  backward sums the gradient over processes and keeps this process's
  rows: the reduce-scatter).

A group's context (its index among the local groups, the sync, the
dropout plan) is thread-local (`group_context`), so the layers read it
without new arguments.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from collections.abc import Callable

import numpy as np
import torch
from torch import nn

from idunno_tpu_torch.parallel import transport
from idunno_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, process_info

# a group that waits this long at the barrier for the others has lost one
SYNC_TIMEOUT_S = 600.0


def _world() -> int:
    return process_info()[1]


def group_devices(mesh: Mesh) -> list[torch.device]:
    """The lead device (model shard 0) of each local data group."""
    return [mesh.devices[d][0] for d in mesh.local_groups]


def _as_tensor(batch) -> torch.Tensor:
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch))
    return batch


def shard_batch(mesh: Mesh, batch) -> list[torch.Tensor]:
    """A global batch (tensor or numpy, leading dim the batch) cut into
    ``n_data`` contiguous row ranges: the local groups' ranges, each on
    its group's lead device (a view where it already lies there). Every
    range must hold a row."""
    batch = _as_tensor(batch)
    n_data = mesh.shape[DATA_AXIS]
    if batch.shape[0] < n_data:
        raise ValueError(f"batch of {batch.shape[0]} rows cannot be cut "
                         f"over {n_data} data groups")
    parts = torch.tensor_split(batch, n_data)
    return [parts[d].to(dev) for d, dev in
            zip(mesh.local_groups, group_devices(mesh))]


def from_process_local(mesh: Mesh, local) -> list[torch.Tensor]:
    """This process's rows of a global batch (the counterpart of
    ``jax.make_array_from_process_local_data``): cut over its local groups,
    each part on its group's lead device."""
    local = _as_tensor(local)
    devs = group_devices(mesh)
    if local.shape[0] < len(devs):
        raise ValueError(f"{local.shape[0]} local rows cannot be cut over "
                         f"{len(devs)} local data groups")
    return [p.to(dev) for p, dev in
            zip(torch.tensor_split(local, len(devs)), devs)]


def replicate(mesh: Mesh, module: nn.Module) -> list[nn.Module]:
    """``module`` on each local group's lead device: the first group gets
    ``module`` itself (moved there), the others deep copies."""
    devs = group_devices(mesh)
    first = module.to(devs[0])
    return [first] + [copy.deepcopy(first).to(dev) for dev in devs[1:]]


class _AllReduceSum(torch.autograd.Function):
    """Sum over processes; the backward sums the incoming gradients the
    same way (every process's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        return transport.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return transport.all_reduce(grad.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every process of the group (``x`` itself in one
    process); differentiable."""
    return _AllReduceSum.apply(x) if _world() > 1 else x


class _GatherRows(torch.autograd.Function):
    """Every process's ``local`` joined along ``dim`` in rank order; the
    backward sums the gradient over processes and keeps this process's
    part."""

    @staticmethod
    def forward(ctx, local, dim):
        ctx.dim, ctx.rank, ctx.size = dim, process_info()[0], local.shape[dim]
        return torch.cat(transport.all_gather(local), dim)

    @staticmethod
    def backward(ctx, grad):
        grad = transport.all_reduce(grad.contiguous().clone())
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None


def gather_rows(local: torch.Tensor, dim: int) -> torch.Tensor:
    """The FSDP gather over processes (``local`` itself in one process)."""
    return _GatherRows.apply(local, dim) if _world() > 1 else local


def reduce_gradients(params_by_group: list[list[nn.Parameter]], *,
                     over_processes: bool = True) -> None:
    """The gradient reduction of a data-parallel step. ``params_by_group``
    holds each local group's copies of the same parameters in the same
    order. Each parameter's gradients are summed over the groups (on the
    first group's copy's device, in group order; a missing gradient counts
    as zero), then over the processes (unless ``over_processes`` is False:
    parameters that no other process holds, a pipeline's stages), and
    every copy gets the sum. The step weights each group's loss by its
    share of the global batch, so the sum is the global batch's
    gradient."""
    world = _world() if over_processes else 1
    totals: list[tuple[tuple, torch.Tensor]] = []
    for copies in zip(*params_by_group):
        grads = [p.grad for p in copies if p.grad is not None]
        if not grads and world == 1:
            continue
        dev = copies[0].device
        total = grads[0].to(dev) if grads else torch.zeros_like(copies[0])
        for g in grads[1:]:
            total = total + g.to(dev)
        totals.append((copies, total))
    if world > 1:
        by_key: dict = {}
        for _, t in totals:
            by_key.setdefault((t.device, t.dtype), []).append(t)
        for ts in by_key.values():
            flat = transport.all_reduce(torch.cat([t.reshape(-1)
                                                   for t in ts]))
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
    for copies, total in totals:
        for p in copies:
            p.grad = total if p.device == total.device else total.to(p.device)


class GroupSync:
    """Where the local groups of a step meet: `sum` returns, to each
    group, the sum of what every local group brought, over the processes
    too where the mesh spans them. With one local group there is no
    barrier (the sum over processes is the only meeting)."""

    def __init__(self, mesh: Mesh) -> None:
        self.lead = mesh.devices[mesh.local_groups[0]][0]
        self.n = len(mesh.local_groups)
        self._over = all_reduce_sum if mesh.spans_processes else (
            lambda x: x)
        self._slots: list = [None] * self.n
        self._out = None
        self._barrier = (threading.Barrier(self.n, action=self._reduce)
                         if self.n > 1 else None)

    def _reduce(self) -> None:
        total = self._slots[0].to(self.lead)
        for t in self._slots[1:]:
            total = total + t.to(self.lead)
        self._slots = [None] * self.n
        self._out = self._over(total)

    def sum(self, index: int, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over every data group (differentiable), on
        ``x``'s device; ``index`` is the caller's local group."""
        if self._barrier is None:
            return self._over(x)
        self._slots[index] = x
        self._barrier.wait(SYNC_TIMEOUT_S)
        return self._out.to(x.device)

    def abort(self) -> None:
        """Release the groups waiting at the barrier (one has failed)."""
        if self._barrier is not None:
            self._barrier.abort()


class DropoutPlan:
    """The dropout masks of one step for one group: each dropout call
    draws the mask of the global batch (``rows_total`` rows) from a
    generator seeded by ``seed`` and the call's number, on the input's
    device, and keeps rows ``rows[0]:rows[1]``. Every group of the step
    (and the one-group step) draws the same masks."""

    def __init__(self, seed: int, rows: tuple[int, int],
                 rows_total: int) -> None:
        self.seed, self.rows, self.rows_total = seed, rows, rows_total
        self.calls = 0

    def keep(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        g = torch.Generator(device=x.device)
        g.manual_seed(self.seed + 7919 * self.calls)
        self.calls += 1
        u = torch.rand((self.rows_total, *x.shape[1:]), generator=g,
                       device=x.device)
        return u[self.rows[0]:self.rows[1]] >= rate


def step_seed(step: int) -> int:
    """The dropout seed of a step (the JAX step folds the step into
    ``PRNGKey(1)``)."""
    return 1_000_003 * (step + 1)


_CTX = threading.local()


@contextlib.contextmanager
def group_context(index: int = 0, sync: GroupSync | None = None,
                  dropout: DropoutPlan | None = None):
    """Make ``(index, sync, dropout)`` the calling thread's group context
    for the block."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (index, sync, dropout)
    try:
        yield
    finally:
        _CTX.state = prev


def group_sum() -> Callable[[torch.Tensor], torch.Tensor] | None:
    """The calling group's sum over all data groups, or None outside a
    step that reduces over groups (one group, one process)."""
    state = getattr(_CTX, "state", None)
    if state is None or state[1] is None:
        return None
    index, sync, _ = state
    return lambda x: sync.sum(index, x)


def dropout_plan() -> DropoutPlan | None:
    """The calling group's dropout plan, or None (the layer then draws
    from torch's generator, as ``nn.Dropout`` does)."""
    state = getattr(_CTX, "state", None)
    return None if state is None else state[2]


def run_groups(calls: list[Callable], sync: GroupSync | None = None
               ) -> list:
    """Run one call per local group and return their results in order:
    one after another, or, when the groups meet at ``sync``'s barrier
    (lockstep), each in its own thread. A group that fails releases the
    others; the first failure is raised."""
    if sync is None or sync.n == 1:
        return [call() for call in calls]
    results: list = [None] * len(calls)
    errors: list[BaseException] = []

    def work(i: int) -> None:
        try:
            results[i] = calls[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            sync.abort()

    threads = [threading.Thread(target=work, args=(i,),
                                name=f"data-group-{i}")
               for i in range(len(calls))]
    # on the CPU the groups' threads share the host's cores: each takes
    # its share of torch's intra-op threads instead of all of them
    cpu_threads = torch.get_num_threads() if sync.lead.type == "cpu" else 0
    if cpu_threads:
        torch.set_num_threads(max(1, cpu_threads // len(calls)))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        if cpu_threads:
            torch.set_num_threads(cpu_threads)
    if errors:
        first = [e for e in errors
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or errors)[0]
    return results
