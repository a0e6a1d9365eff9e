"""Training step for the CNN families, what every training step shares
(the train state and the optimizers), and its placement on a mesh.

A port of ``idunno_tpu/engine/train.py``. PyTorch trains in place: a
step runs the forward, ``backward`` fills each parameter's ``.grad``, and
the optimizer updates the parameters and its moments in place, where the
JAX step returns a new state. So the train state holds the live model and
its optimizer, not copies of their tensors, and a step returns only its
metrics.

Optimizers are factories, ``params -> torch.optim.Optimizer``, with the
hyperparameters of the optax transformations the JAX callers use written
out (``adamw``, ``adam``, ``sgd``); ``flat_tx`` is the counterpart of
``optax.flatten``.

BatchNorm: flax's ``momentum=0.9`` is torch's ``momentum=0.1``, and the
port's ResNets use ``models/resnet.py:BatchNorm2d``, which folds the
*biased* batch variance into the running variance, as flax does (torch's
own ``nn.BatchNorm2d`` folds the unbiased one). So the running statistics
follow flax's rule; ``tests/test_torch_train.py`` holds both to the JAX
step's directly.

On a mesh (``parallel/mesh.py``) the JAX package places the state with
sharding annotations and ``jit`` inserts the collectives; the port writes
them out (``parallel/data.py``). `shard_train_state` gives each local
data group a replica of the model and of its optimizer (pure data
parallelism; ``tensor_parallel=True`` also cuts AlexNet's large FC
kernels over the group's model shards, ``parallel/sharding.py:
tp_param_spec``); `fsdp_shard_train_state` cuts every parameter and its
optimizer moments over the data axis (`fsdp_param_spec`, ZeRO-3): each
group keeps its shard, whole parameters are gathered for the forward,
and autograd's backward of the gather sums each shard's gradient over
the groups (the reduce-scatter). `jit_train_step` runs the step of
`make_train_step` over the mesh: the batch is cut over the data groups,
each group's mean loss is weighted by its share of the global batch, the
gradients are summed over the groups, and each group's optimizer takes
the same update. BatchNorm normalizes with the global batch's statistics
(the groups then run in lockstep, one thread each), and dropout draws the
global batch's masks from a generator keyed by the step, so the step
over any mesh shape equals the one-group step on the same batch.
"""
from __future__ import annotations

import functools
import inspect
import re
from collections.abc import Callable, Iterable
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from idunno_tpu_torch.engine.inference import resolve_device
from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.parallel import data as data_lib
from idunno_tpu_torch.parallel import transport
from idunno_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                            process_info)
from idunno_tpu_torch.parallel.sharding import split_columns, tp_param_spec

TxFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


@dataclass
class TrainState:
    """``step``, the model and its optimizer. BatchNorm statistics live in
    the model's buffers, so nothing else is carried (the JAX state's
    ``batch_stats`` and ``opt_state`` are inside ``model`` and
    ``optimizer``)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def adamw(lr: float, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> TxFactory:
    """``optax.adamw(lr)``: its defaults, with weight decay 1e-4 applied to
    every parameter (``torch.optim.AdamW`` defaults to 1e-2)."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay,
                             foreach=False)


def adam(lr: float, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> TxFactory:
    """``optax.adam(lr)``: no weight decay."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2),
                             eps=eps, weight_decay=0.0, foreach=False)


def sgd(lr: float, momentum: float = 0.0) -> TxFactory:
    """``optax.sgd(lr, momentum)``: heavy-ball momentum with no dampening
    and no Nesterov term (the first step's trace is the gradient in both)."""
    return functools.partial(torch.optim.SGD, lr=lr, momentum=momentum,
                             dampening=0.0, nesterov=False, foreach=False)


def flat_tx(inner: TxFactory) -> TxFactory:
    """The counterpart of ``optax.flatten`` (``engine/train.py:flat_tx``
    in the JAX package): one update over all parameters instead of one per
    tensor. The factories above update tensor by tensor (``foreach=False``,
    a loop of small launches, as optax's per-leaf update is); this one
    takes ``fused=True``: the whole update (moments, bias correction,
    decay, step) is one multi-tensor kernel that walks many parameters per
    launch, where ``foreach=True`` would still make about a dozen passes
    over every parameter, one per elementwise op. Same per-element math,
    in place."""
    return functools.partial(inner, foreach=False, fused=True)


def place(model: nn.Module, generator: torch.Generator,
          device: str | torch.device | None) -> nn.Module:
    """Move ``model`` to ``device`` (``None``: the card) and seed it there
    with flax's initialisers (``models/init.py``; a model with its own
    ``init_weights`` uses that) from ``generator``, which lies on the same
    device."""
    model = model.to(resolve_device(device))
    init = getattr(model, "init_weights", None)
    if init is not None:
        init(generator)
    else:
        init_like_flax(model, generator)
    return model


def create_train_state(model: nn.Module, generator: torch.Generator,
                       tx_factory: TxFactory,
                       device: str | torch.device | None = None
                       ) -> TrainState:
    """A seeded model on ``device`` (``None``: the card, which must be
    present), in training mode, with its optimizer over every parameter."""
    model = place(model, generator, device).train()
    return TrainState(step=0, model=model,
                      optimizer=tx_factory(model.parameters()))


def check_state(state: TrainState, model: nn.Module,
                optimizer: torch.optim.Optimizer) -> None:
    """Raise unless ``state`` holds the model and optimizer a step was
    made for."""
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the train state holds another model or "
                         "optimizer than this step was made for")


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer):
    """``step(state, images, labels) -> metrics``: cross-entropy of the
    model in training mode (BatchNorm on batch statistics, its running
    statistics updated), backward, one in-place optimizer update.
    ``images`` are what the model takes (NCHW f32); labels int64 [B].
    Metrics are 0-d tensors on the device: ``loss`` and ``accuracy``."""

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> dict:
        check_state(state, model, optimizer)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(images)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step


# -- the mesh ---------------------------------------------------------------


@dataclass
class GroupState:
    """One local data group's part of a train state: its device (the
    group's lead), the module it computes with, the parameters its
    optimizer updates by name (the module's own for replicas; for FSDP the
    group's shards and the replicated leaves, while the module's own
    parameters hold no storage) and that optimizer."""

    device: torch.device
    model: nn.Module
    params: dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer


@dataclass
class MeshTrainState(TrainState):
    """A train state placed on a mesh: ``model`` and ``optimizer`` are the
    first local group's, ``groups`` every local group's, and ``fsdp`` maps
    each parameter to the dim cut over the data axis (None where it
    replicates) for an FSDP state, or is None."""

    mesh: Mesh | None = None
    groups: list[GroupState] = field(default_factory=list)
    fsdp: dict[str, int | None] | None = None


def _new_optimizer(like: torch.optim.Optimizer,
                   params: list[nn.Parameter]) -> torch.optim.Optimizer:
    """An optimizer of ``like``'s class and hyperparameters over
    ``params``."""
    accepted = inspect.signature(type(like).__init__).parameters
    kw = {k: v for k, v in like.defaults.items() if k in accepted}
    return type(like)(params, **kw)


def _carry_state(optimizer: torch.optim.Optimizer, old: nn.Parameter,
                 new: nn.Parameter, dim: int | None, s: int, n: int,
                 target: torch.optim.Optimizer) -> None:
    """``old``'s optimizer state (its moments) for ``new``: the tensors of
    the parameter's shape cut like the parameter (shard ``s`` of ``n`` on
    ``dim``, whole when ``dim`` is None), the rest (the step count)
    copied."""
    st = optimizer.state.get(old)
    if not st:
        return
    out = {}
    for k, v in st.items():
        if isinstance(v, torch.Tensor) and v.shape == old.shape:
            if dim is not None:
                size = v.shape[dim] // n
                v = v.narrow(dim, s * size, size)
            out[k] = v.detach().to(new.device, copy=True)
        else:
            out[k] = v.clone() if isinstance(v, torch.Tensor) else v
    target.state[new] = out


_PART = re.compile(r"^(.*)\.parts\.(\d+)\.weight$")


def shard_train_state(state: TrainState, mesh: Mesh,
                      tensor_parallel: bool = False) -> MeshTrainState:
    """Place ``state`` on ``mesh``: each local data group gets a replica
    of the model on its device (the first group the model itself) and an
    optimizer of the same kind with the same moments. With
    ``tensor_parallel`` the large FC kernels (`tp_param_spec`) are cut over
    the group's model shards (``ColumnSplit``), their moments with them."""
    n_model = mesh.shape[MODEL_AXIS]
    base, opt = state.model, state.optimizer
    old = dict(base.named_parameters())
    groups = []
    for model, d in zip(data_lib.replicate(mesh, base), mesh.local_groups):
        row = list(mesh.devices[d])
        if tensor_parallel and n_model > 1:
            specs = {name: tp_param_spec(name, p.shape)
                     for name, p in model.named_parameters()}
            split_columns(model, specs, row)
        params = dict(model.named_parameters())
        optimizer = _new_optimizer(opt, list(params.values()))
        for name, p in params.items():
            m = _PART.match(name)
            if m is not None:
                _carry_state(opt, old[f"{m.group(1)}.weight"], p, 0,
                             int(m.group(2)), n_model, optimizer)
            else:
                _carry_state(opt, old[name], p, None, 0, 1, optimizer)
        groups.append(GroupState(row[0], model, params, optimizer))
    return MeshTrainState(step=state.step, model=groups[0].model,
                          optimizer=groups[0].optimizer, mesh=mesh,
                          groups=groups)


def fsdp_param_spec(shape, n_shards: int) -> int | None:
    """The dim of a leaf of ``shape`` that FSDP cuts over ``n_shards``:
    the largest dim that ``n_shards`` divides (the first such on a tie);
    None (replicate) for a scalar, a leaf of fewer than ``n_shards``
    elements, or one no dim of which divides. The JAX rule, on the
    port's parameter shapes."""
    shape = tuple(shape)
    numel = 1
    for s in shape:
        numel *= s
    if not shape or numel < n_shards:
        return None
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n_shards == 0 and s > best_size:
            best, best_size = i, s
    return best


def fsdp_shard_train_state(state: TrainState,
                           mesh: Mesh) -> MeshTrainState:
    """Place ``state`` on ``mesh`` fully sharded (ZeRO-3): every parameter
    that `fsdp_param_spec` cuts, and its optimizer moments, split over the
    data axis, each local group holding its shard on its device; the
    leaves it does not cut replicate. Each group's module is a copy of the
    model whose parameters hold no storage: the step gathers the whole
    parameters for its forward. The model axis, if any, replicates."""
    n = mesh.shape[DATA_AXIS]
    base, opt = state.model, state.optimizer
    old = dict(base.named_parameters())
    dims = {name: fsdp_param_spec(p.shape, n) for name, p in old.items()}
    groups = []
    for d in mesh.local_groups:
        dev = mesh.devices[d][0]
        params = {}
        for name, p in old.items():
            dim = dims[name]
            w = p.detach()
            if dim is not None:
                size = w.shape[dim] // n
                w = w.narrow(dim, d * size, size)
            params[name] = nn.Parameter(w.to(dev, copy=True))
        optimizer = _new_optimizer(opt, list(params.values()))
        for name, p in params.items():
            _carry_state(opt, old[name], p, dims[name], d, n, optimizer)
        groups.append(GroupState(dev, None, params, optimizer))
    # the modules last: releasing the model's parameters empties ``old``
    for p in old.values():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    for g, model in zip(groups, data_lib.replicate(mesh, base)):
        g.model = model
    return MeshTrainState(step=state.step, model=groups[0].model,
                          optimizer=groups[0].optimizer, mesh=mesh,
                          groups=groups, fsdp=dims)


def gathered_params(state: MeshTrainState) -> dict[str, torch.Tensor]:
    """Every parameter of the model whole, under its unsplit name, on the
    first group's device (a copy, without gradients): the FSDP shards and
    the column-split parts joined."""
    g0 = state.groups[0]
    with torch.no_grad():
        if state.fsdp is not None:
            return {name: _gather_leaf(state, name, g0.device).detach()
                    for name in state.fsdp}
        out = {}
        for name, p in g0.params.items():
            m = _PART.match(name)
            if m is None:
                out[name] = p.detach().to(g0.device, copy=True)
            elif m.group(2) == "0":
                parts = [t for k, t in g0.params.items()
                         if _PART.match(k) and
                         _PART.match(k).group(1) == m.group(1)]
                out[f"{m.group(1)}.weight"] = torch.cat(
                    [t.detach().to(g0.device) for t in parts], 0)
        return out


def _gather_leaf(state: MeshTrainState, name: str,
                 device: torch.device) -> torch.Tensor:
    """An FSDP leaf whole on ``device``: the local groups' shards joined
    in order, then the processes' joined (differentiable: the backward
    is the reduce-scatter); a replicated leaf is the first group's."""
    dim = state.fsdp[name]
    if dim is None:
        return state.groups[0].params[name]
    local = torch.cat([g.params[name].to(device) for g in state.groups], dim)
    return data_lib.gather_rows(local, dim)


def _split_sizes(total: int, n: int) -> list[int]:
    """Rows of each of ``n`` parts of ``total`` (``torch.tensor_split``)."""
    q, r = divmod(total, n)
    return [q + 1] * r + [q] * (n - r)


def _group_inputs(state: MeshTrainState, batch) -> list[torch.Tensor]:
    """The step's input for each local group: a tensor is the global batch
    (cut by ``shard_batch``), a list the local groups' parts."""
    if not isinstance(batch, (list, tuple)):
        return data_lib.shard_batch(state.mesh, batch)
    if len(batch) != len(state.groups):
        raise ValueError(f"{len(batch)} parts for {len(state.groups)} "
                         "local data groups")
    return [p.to(g.device) for p, g in zip(batch, state.groups)]


def _mesh_rows(state: MeshTrainState, batch,
               parts: list[torch.Tensor]) -> list[int]:
    """The rows of every data group of the mesh: from the global batch's
    length, or the local parts' rows gathered from every process."""
    import torch.distributed as dist

    if not isinstance(batch, (list, tuple)):
        return _split_sizes(batch.shape[0], state.mesh.shape[DATA_AXIS])
    rows = [p.shape[0] for p in parts]
    world = process_info()[1] if state.mesh.spans_processes else 1
    if world == 1:
        return rows
    every: list = [None] * world
    dist.all_gather_object(every, rows)
    return [r for proc in every for r in proc]


def _check_mesh_state(state, model: nn.Module,
                      optimizer: torch.optim.Optimizer, mesh: Mesh) -> None:
    if not isinstance(state, MeshTrainState) or state.mesh != mesh:
        raise ValueError("a mesh step needs a state placed on its mesh "
                         "(shard_train_state or fsdp_shard_train_state)")
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the train state holds another model or "
                         "optimizer than this step was made for")


def run_mesh_step(state: MeshTrainState, inputs: list, loss_fn,
                  accum_steps: int = 1) -> torch.Tensor:
    """One step over ``state``'s mesh. ``inputs`` are the step's batched
    tensors (each a global batch or the local groups' parts).
    ``loss_fn(model, params, *group_inputs) -> (loss, metrics)`` is a
    group's mean loss and metric vector over its rows (``params``: the
    whole parameters FSDP gathered, or None). Each group's loss and
    metrics are weighted by its share of the global batch (per
    accumulation chunk), summed, and one backward runs over the sum; the
    gradients are summed over the groups and processes
    (`parallel/data.py:reduce_gradients`; FSDP's sharded leaves are summed
    by the gather's backward), divided by ``accum_steps``, and every
    group's optimizer steps. Returns the global metric vector on the
    first group's device."""
    mesh, groups = state.mesh, state.groups
    per = [_group_inputs(state, x) for x in inputs]
    parts = [list(args) for args in zip(*per)]
    rows = _mesh_rows(state, inputs[0], per[0])
    if any(r < accum_steps for r in rows):
        raise ValueError(f"data groups' rows {rows}: each needs at least "
                         f"accum_steps={accum_steps}")
    # a mesh of this process alone reduces nothing over processes, also
    # inside a process group
    world = process_info()[1] if mesh.spans_processes else 1
    has_bn = any(isinstance(m, nn.BatchNorm2d)
                 for m in groups[0].model.modules())
    sync = (data_lib.GroupSync(mesh)
            if has_bn and (len(groups) > 1 or world > 1) else None)
    seed = data_lib.step_seed(state.step)
    for g in groups:
        g.model.train()
        g.optimizer.zero_grad(set_to_none=True)
    lead = groups[0].device
    sums = None
    for c in range(accum_steps):
        if state.fsdp is not None:
            full = {name: _gather_leaf(state, name, lead)
                    for name in state.fsdp}
        chunk = [[t.tensor_split(accum_steps)[c] for t in args]
                 for args in parts]
        chunk_rows = [_split_sizes(r, accum_steps)[c] for r in rows]
        chunk_total = sum(chunk_rows)

        def call(i: int):
            g, args = groups[i], chunk[i]
            params = None
            if state.fsdp is not None:
                params = {name: (t.to(g.device) if state.fsdp[name]
                                 is not None else g.params[name])
                          for name, t in full.items()}
            start = sum(chunk_rows[:mesh.local_groups[i]])
            plan = data_lib.DropoutPlan(
                seed + c, (start, start + args[0].shape[0]), chunk_total)
            with data_lib.group_context(i, sync, plan):
                loss, vec = loss_fn(g.model, params, *args)
            w = args[0].shape[0] / chunk_total
            return loss * w, vec * w

        outs = data_lib.run_groups([functools.partial(call, i)
                                    for i in range(len(groups))], sync)
        loss = sum(term.to(lead) for term, _ in outs)
        loss.backward()
        vec = sum(v.detach().to(lead) for _, v in outs)
        sums = vec if sums is None else sums + vec
    if accum_steps > 1:
        for g in groups:
            grads = [p.grad for p in g.params.values() if p.grad is not None]
            torch._foreach_div_(grads, accum_steps)
        sums = sums / accum_steps
    if state.fsdp is None:
        data_lib.reduce_gradients([list(g.params.values()) for g in groups],
                                  over_processes=world > 1)
    else:
        data_lib.reduce_gradients(
            [[g.params[n] for n, d in state.fsdp.items() if d is None]
             for g in groups], over_processes=world > 1)
    for g in groups:
        g.optimizer.step()
    state.step += 1
    if world > 1:
        transport.all_reduce(sums)
    return sums


def _forward(model: nn.Module, params, x: torch.Tensor) -> torch.Tensor:
    if params is None:
        return model(x)
    return torch.func.functional_call(model, params, (x,), strict=False)


def jit_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                   mesh: Mesh):
    """`make_train_step` over ``mesh`` (the JAX ``jit_train_step``):
    ``step(state, images, labels) -> metrics`` for a state placed by
    `shard_train_state` or `fsdp_shard_train_state` (``model`` and
    ``optimizer`` are the placed state's).
    ``images``/``labels`` are the global batch (cut over the data groups)
    or the local groups' parts. The loss is the global batch's mean
    cross-entropy, BatchNorm normalizes over the global batch, and the
    dropout masks are the global batch's (module docstring); metrics as
    `make_train_step`'s, 0-d tensors on the first group's device."""

    def loss_fn(m, params, images, labels):
        logits = _forward(m, params, images)
        loss = F.cross_entropy(logits, labels)
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return loss, torch.stack([loss.detach(), acc])

    def train_step(state: MeshTrainState, images, labels) -> dict:
        _check_mesh_state(state, model, optimizer, mesh)
        loss, acc = run_mesh_step(state, [images, labels], loss_fn).unbind()
        return {"loss": loss, "accuracy": acc}

    return train_step


def resident_bytes(state: MeshTrainState, group: int = 0) -> int:
    """Bytes a local group keeps of the parameters its optimizer updates
    and of their optimizer state (moments), gradients aside."""
    g = state.groups[group]
    total = sum(p.numel() * p.element_size() for p in g.params.values())
    for st in g.optimizer.state.values():
        total += sum(v.numel() * v.element_size() for v in st.values()
                     if isinstance(v, torch.Tensor) and v.dim() > 0)
    return total
