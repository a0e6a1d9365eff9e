"""Pipeline-parallel TransformerLM training, a port of
``idunno_tpu/engine/pipeline_lm.py``.

A dense `TransformerLM` cut into ``p`` pipeline stages with distinct
per-stage weights, trained through the same next-token loss as the dense
path (``engine/train_lm.py``):

  - `partition_lm_params` / `merge_lm_params` — the lossless split of the
    dense model's state dict into ``{"outer": embed/ln_f/head, "stages":
    block tensors stacked [p, L, ...]}`` (L = depth // p) and back, so
    checkpoints pass between the dense and pipelined layouts;
  - `PipelinedLM` — the dense model's own modules regrouped: the
    embedding, the final norm and the head (``outer``, on the lead
    device, where the residual stream stays) and ``stages[s]``, stage
    ``s``'s L blocks on its stage's device;
  - `make_pipelined_lm_apply` — embed, the block stack through the GPipe
    schedule (``parallel/pipeline.py:run_stages``) on the stages'
    devices (activations hop stage to stage), ln_f and head;
  - `create_pipelined_lm_train_state`, `shard_pipelined_state` and
    `make_pipelined_lm_train_step` / `jit_pipelined_lm_train_step` — the
    train state (the dense init, partitioned), its placement (each
    stage's blocks and their optimizer moments on the stage's device,
    one replica per data group) and the step: loss and gradients through
    the schedule, with ``data_axis`` each data group on its rows of the
    batch, without it each on the whole batch (the JAX package's
    replicated tokens), the gradients summed over the groups
    (``parallel/data.py:reduce_gradients``), one optimizer update.

Numerics are the dense model's (GPipe accumulates full-batch gradients,
no staleness). Each block attends through the model's ``attn_fn``, so
``make_attn_fn("auto")`` runs K2 forward and K4/K5 backward on the card.

Dense blocks only: the routed FFN keeps its balance loss inside the stage
function, which the JAX schedule does not thread out; the port refuses it
with the JAX package's words.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from idunno_tpu_torch.engine.train import (GroupState, MeshTrainState,
                                           TrainState, _carry_state,
                                           _check_mesh_state, _new_optimizer,
                                           place, run_mesh_step)
from idunno_tpu_torch.engine.train_lm import next_token_loss
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.parallel import transport
from idunno_tpu_torch.parallel.data import reduce_gradients
from idunno_tpu_torch.parallel.mesh import (STAGE_AXIS, AxisCells, Mesh,
                                            MeshShapeError)
from idunno_tpu_torch.parallel.pipeline import run_stages, stack_stage_params

_BLOCK = "blocks."


def _check_pipelineable(model, num_stages: int) -> int:
    if model.ffn_factory is not None:
        raise ValueError("pipelined path supports dense blocks only "
                         "(MoE sows aux losses the schedule cannot thread "
                         "out); use EP/FSDP for MoE models")
    if model.depth % num_stages:
        raise ValueError(f"depth {model.depth} not divisible by "
                         f"{num_stages} pipeline stages")
    return model.depth // num_stages


def partition_lm_params(params: dict, depth: int, num_stages: int) -> dict:
    """Dense TransformerLM state dict → {"outer": embed/ln_f/head,
    "stages": block tensors stacked [p, L, ...]} (keys within a block,
    e.g. ``attn.q.weight``)."""
    if depth % num_stages:
        raise ValueError(f"depth {depth} % stages {num_stages} != 0")
    l = depth // num_stages
    blocks = [{k[len(f"{_BLOCK}{i}."):]: v for k, v in params.items()
               if k.startswith(f"{_BLOCK}{i}.")} for i in range(depth)]
    stacked = stack_stage_params(blocks)              # leaves [depth, ...]
    stages = {k: a.reshape(num_stages, l, *a.shape[1:])
              for k, a in stacked.items()}
    outer = {k: v for k, v in params.items() if not k.startswith(_BLOCK)}
    return {"outer": outer, "stages": stages}


def merge_lm_params(pp_params: dict, depth: int) -> dict:
    """Inverse of `partition_lm_params`: back to the dense state dict
    (e.g. to checkpoint through ``engine/checkpoint.py`` or serve
    unsplit)."""
    flat = {k: a.reshape(depth, *a.shape[2:])
            for k, a in pp_params["stages"].items()}
    out = dict(pp_params["outer"])
    for i in range(depth):
        out.update({f"{_BLOCK}{i}.{k}": a[i] for k, a in flat.items()})
    return out


class PipelinedLM(nn.Module):
    """A dense `TransformerLM`'s own modules regrouped into stages:
    ``embed``, ``stages[s]`` (blocks ``s·L .. s·L + L - 1``), ``ln_f``,
    ``head``. `place` puts the outer modules on the first of the stages'
    ``devices`` and stage ``s`` on its ``s``-th."""

    def __init__(self, model: TransformerLM, num_stages: int) -> None:
        super().__init__()
        l = _check_pipelineable(model, num_stages)
        self.depth, self.ffn_factory = model.depth, None
        self.compute_dtype = model.compute_dtype
        self.embed = model.embed
        self.stages = nn.ModuleList(
            nn.ModuleList(model.blocks[s * l:(s + 1) * l])
            for s in range(num_stages))
        self.ln_f, self.head = model.ln_f, model.head
        self.dim = model.dim
        self.devices: list | None = None
        self.cells: AxisCells | None = None

    def place(self, cells) -> "PipelinedLM":
        """Each stage on its device (``cells``: one device per stage, or a
        row of a stage axis, ``parallel/mesh.py:AxisCells``), the outer
        modules on the first. Across processes this process keeps only
        its own stages, the embedding with stage 0 and the final norm and
        head with the last stage; the other processes' modules are
        dropped (each process holds only its stages' weights)."""
        if not isinstance(cells, AxisCells):
            cells = AxisCells(tuple(cells), (0,) * len(cells))
        devices = list(cells.devices)
        if len(devices) != len(self.stages):
            raise ValueError(f"{len(devices)} devices for "
                             f"{len(self.stages)} stages")
        outer = {"embed": devices[0], "ln_f": devices[0],
                 "head": devices[0]}
        if cells.spans:
            outer.update(ln_f=devices[-1], head=devices[-1])
        for name, dev in outer.items():
            mod = getattr(self, name)
            if mod is not None:
                setattr(self, name, None if dev is None else mod.to(dev))
        for s, dev in enumerate(devices):
            if dev is None:
                self.stages[s] = nn.ModuleList()
            else:
                self.stages[s].to(dev)
        self.cells, self.devices = cells, devices
        return self

    def dense_state_dict(self) -> dict:
        """The dense model's state dict (its names) of these modules."""
        l = self.depth // len(self.stages)
        out = {f"embed.{k}": v for k, v in self.embed.state_dict().items()}
        for s, stage in enumerate(self.stages):
            for j, blk in enumerate(stage):
                out.update({f"{_BLOCK}{s * l + j}.{k}": v
                            for k, v in blk.state_dict().items()})
        out.update({f"ln_f.{k}": v for k, v in self.ln_f.state_dict().items()})
        out.update({f"head.{k}": v for k, v in self.head.state_dict().items()})
        return out

    def load_pp_params(self, pp_params: dict) -> None:
        """Copy a `partition_lm_params` tree into these modules."""
        dense = merge_lm_params(pp_params, self.depth)
        own = self.dense_state_dict()
        if set(dense) != set(own):
            raise ValueError(f"pipelined params differ in names: "
                             f"{sorted(set(dense) ^ set(own))[:4]}")
        with torch.no_grad():
            for k, v in dense.items():
                own[k].copy_(v)


def _stage_fn(stage: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for blk in stage:
        x = blk(x)
    return x


def make_pipelined_lm_apply(model, mesh: Mesh, num_microbatches: int, *,
                            axis: str = STAGE_AXIS):
    """``apply(pipelined, tokens[B, T]) -> logits[B, T, vocab]`` (f32) for
    a `PipelinedLM` of ``model``'s shape (a `TransformerLM` or the
    `PipelinedLM` itself) placed on a row of ``mesh``'s stages: the block
    stack through the GPipe schedule on that row's devices;
    B % num_microbatches == 0. Across processes the logits are the last
    stage's process's (None elsewhere), and ``apply(..., flow, key)``
    differentiates through ``flow`` (``parallel/transport.py:Backflow``,
    the row's hops keyed by ``key``). Microbatch ``m`` holds rows ``j·M + m``
    (the JAX package's interleave, which keeps a data group's rows
    contiguous). One replica applies to the rows it is given: the data
    axis is the step's (`make_pipelined_lm_train_step`), which gives each
    data group's replica its rows."""
    num_stages = mesh.shape[axis]
    _check_pipelineable(model, num_stages)

    def apply_fn(pp: PipelinedLM, tokens: torch.Tensor, flow=None,
                 key: tuple = ()) -> torch.Tensor | None:
        b = tokens.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} not divisible by "
                             f"{num_microbatches} microbatches")
        if pp.devices is None or len(pp.stages) != num_stages:
            raise ValueError("apply a PipelinedLM placed on its row of the "
                             f"{num_stages}-stage mesh (shard_pipelined_"
                             "state)")
        mb, cells = b // num_microbatches, pp.cells
        if cells.local(0):
            x = pp.embed(tokens.to(pp.devices[0])).to(pp.compute_dtype)
            micro = x.reshape(mb, num_microbatches,
                              *x.shape[1:]).transpose(0, 1)
        else:                 # stage 0 is another process's
            micro = torch.empty((num_microbatches, mb, tokens.shape[1],
                                 pp.dim), dtype=pp.compute_dtype,
                                device="meta")
        y = run_stages(_stage_fn, list(pp.stages), micro, cells, flow=flow,
                       key=key)
        if y is None:
            return None
        x = y.transpose(0, 1).reshape(b, *y.shape[2:])
        return pp.head(pp.ln_f(x)).to(torch.float32)

    return apply_fn


def create_pipelined_lm_train_state(model: TransformerLM,
                                    generator: torch.Generator, tx_factory,
                                    num_stages: int,
                                    device: str | torch.device | None = None
                                    ) -> TrainState:
    """Init the FULL dense model (the same init as the unpipelined path:
    ``engine/train.py:place`` on ``device``, ``None`` the card) and
    partition it, so dense and pipelined runs are comparable; the state's
    model is the `PipelinedLM`, in training mode, with its optimizer."""
    _check_pipelineable(model, num_stages)
    pp = PipelinedLM(place(model, generator, device), num_stages).train()
    dev = next(model.parameters()).device
    pp.place([dev] * num_stages)
    return TrainState(step=0, model=pp, optimizer=tx_factory(pp.parameters()))


def shard_pipelined_state(state: TrainState, mesh: Mesh, *,
                          axis: str = STAGE_AXIS) -> MeshTrainState:
    """Place the state: in each data group of ``mesh`` a replica of the
    `PipelinedLM` (the first group the state's own), each stage's blocks
    and their optimizer moments on the stage's device of the group's row —
    each device holds only its own stage's weights, the point of PP — and
    the outer modules on the row's first device. Over a stage axis across
    processes each process keeps its own stages of every row
    (`PipelinedLM.place`)."""
    base, opt = state.model, state.optimizer
    old = dict(base.named_parameters())
    groups = []
    for i, d in enumerate(mesh.local_groups):
        cells = mesh.along(axis, d)
        model = (base if i == 0 else copy.deepcopy(base)).place(cells)
        params = dict(model.named_parameters())
        optimizer = _new_optimizer(opt, list(params.values()))
        for name, p in params.items():
            _carry_state(opt, old[name], p, None, 0, 1, optimizer)
        lead = next(dev for dev in cells.devices if dev is not None)
        groups.append(GroupState(lead, model, params, optimizer))
    return MeshTrainState(step=state.step, model=groups[0].model,
                          optimizer=groups[0].optimizer, mesh=mesh,
                          groups=groups)


def make_pipelined_lm_train_step(model: PipelinedLM,
                                 optimizer: torch.optim.Optimizer,
                                 mesh: Mesh, num_microbatches: int, *,
                                 axis: str = STAGE_AXIS,
                                 data_axis: str | None = None):
    """``step(state, tokens[B, T]) -> metrics`` for a state placed by
    `shard_pipelined_state` (``model`` and ``optimizer`` are its own):
    next-token loss and gradients through the pipeline schedule, the
    gradients summed over the state's data groups, one update of every
    group. With ``data_axis`` (the mesh's data axis) the batch is cut over
    the data groups (``tokens``: the global batch, or a list of the local
    groups' parts) and each group runs the schedule on its rows of every
    microbatch (PP x DP); without it every group runs the whole batch (the
    JAX package's tokens replicated over the data rows), weighted
    1/n_data, so the update is the same. Metrics: ``loss``, ``ce`` and
    ``accuracy``, 0-d tensors on the first group's device."""
    if data_axis is not None and data_axis != mesh.axes[0]:
        raise MeshShapeError(
            f"data_axis {data_axis!r} is not the data axis of a mesh with "
            f"axes {mesh.axes}", constraint=f"data_axis == {mesh.axes[0]!r}")
    apply_fn = make_pipelined_lm_apply(model, mesh, num_microbatches,
                                       axis=axis)
    if mesh.spans_processes:
        return _cross_process_step(model, optimizer, mesh, apply_fn,
                                   data_axis)

    def loss_fn(m, params, tokens):
        ce, acc = next_token_loss(apply_fn(m, tokens), tokens)
        return ce, torch.stack([ce.detach(), acc])

    def train_step(state: MeshTrainState, tokens) -> dict:
        _check_mesh_state(state, model, optimizer, mesh)
        if data_axis is None:
            if isinstance(tokens, (list, tuple)):
                raise ValueError("the data groups' parts of a batch need "
                                 "data_axis")
            tokens = [tokens] * len(state.groups)
        loss, acc = run_mesh_step(state, [tokens], loss_fn).unbind()
        return {"loss": loss, "ce": loss, "accuracy": acc}

    return train_step


def _cross_process_step(model, optimizer, mesh: Mesh, apply_fn, data_axis):
    """The pipelined step over a stage axis across processes: every
    process is given the global batch and runs its stages of each row (in
    row order, the same in every process), the rows weighted as in one
    process; the loss is the last stage's process's, which starts the
    backward (``transport.Backflow``: from the last stage's process to the
    first's). A process's stages are its own, so their gradients are
    summed over its rows only; every process steps its own optimizers.
    The metrics go to every process."""

    def train_step(state: MeshTrainState, tokens) -> dict:
        _check_mesh_state(state, model, optimizer, mesh)
        if isinstance(tokens, (list, tuple)):
            raise ValueError("a pipelined step across processes takes the "
                             "global batch")
        n_data = mesh.shape[mesh.axes[0]]
        parts = (tokens.tensor_split(n_data) if data_axis is not None
                 else [tokens] * n_data)
        flow = transport.Backflow()
        loss = vec = None
        for g in state.groups:
            g.model.train()
            g.optimizer.zero_grad(set_to_none=True)
        for g, d in zip(state.groups, mesh.local_groups):
            rows = parts[d]
            w = (rows.shape[0] / tokens.shape[0] if data_axis is not None
                 else 1.0 / n_data)
            logits = apply_fn(g.model, rows, flow, (d,))
            if logits is None:
                continue
            ce, acc = next_token_loss(logits, rows.to(logits.device))
            term, v = ce * w, torch.stack([ce.detach(), acc]) * w
            loss = term if loss is None else loss + term.to(loss.device)
            vec = v if vec is None else vec + v.to(vec.device)
        flow.backward(loss)
        reduce_gradients([list(g.params.values()) for g in state.groups],
                         over_processes=False)
        for g in state.groups:
            g.optimizer.step()
        state.step += 1
        if vec is None:
            vec = torch.zeros(2, device=state.groups[0].device)
        loss, acc = transport.all_reduce(vec.to(state.groups[0].device)
                                         ).unbind()
        return {"loss": loss, "ce": loss, "accuracy": acc}

    return train_step


# The JAX package's jit wrapper places the tokens; the port's step cuts
# the batch itself, so the two names are one step.
jit_pipelined_lm_train_step = make_pipelined_lm_train_step
