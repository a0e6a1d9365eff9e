"""Language-model training step, a port of ``idunno_tpu/engine/train_lm.py``.

Next-token cross-entropy over a ``TransformerLM``, backward (through the
flash kernels K2, K4 and K5 when the model attends with ``flash`` on a
card), and one optimizer update, in place (``engine/train.py``). The
routed FFN's balance loss (``models/moe.py:moe_aux_loss``) is added with a
coefficient; it is 0 for the dense model. `jit_lm_train_step` runs the
same step over a mesh (``engine/train.py:run_mesh_step``): the tokens are
cut on the batch over the data groups, each group's attention runs the
flash kernels on its own device, and the gradients are summed over the
groups; or, with ``sequence_parallel=True``, cut on the sequence by the
model's ring or Ulysses attention (``parallel/ring_attention.py``,
``parallel/ulysses.py``), the rest of the step on the global view on the
mesh's lead device; over a mesh whose sequence axis crosses processes,
each process runs the whole model over its own slice of the sequence and
the gradients are summed over the processes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from idunno_tpu_torch.engine.train import (MeshTrainState, TrainState,
                                           _check_mesh_state, check_state,
                                           create_train_state, run_mesh_step)
from idunno_tpu_torch.models.moe import ExpertShard, SwitchFFN, moe_aux_loss
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, MeshShapeError

# The LM's state is made as the CNN's: ``model`` on ``device`` (``None``:
# the card), seeded with flax's initialisers (``models/init.py``) from
# ``generator``, in training mode, with its optimizer.
create_lm_train_state = create_train_state


def next_token_loss(logits: torch.Tensor,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE over [B, T] tokens (targets = tokens rolled left one,
    final position masked, so the model input keeps length T). Returns
    (ce, accuracy); accuracy carries no gradient."""
    targets = torch.roll(tokens, -1, dims=1)
    t = tokens.shape[1]
    mask = (torch.arange(t, device=tokens.device) < t - 1).to(
        torch.float32)[None, :]
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, targets[..., None])[..., 0]
    denom = mask.sum() * tokens.shape[0]
    ce = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    return ce, acc


def make_lm_train_step(model: TransformerLM,
                       optimizer: torch.optim.Optimizer,
                       aux_coef: float = 0.01, accum_steps: int = 1):
    """``step(state, tokens[int64 B, T]) -> metrics``: next-token CE plus
    ``aux_coef`` × the MoE balance loss (0 for the dense model), backward,
    one in-place update of ``model`` by ``optimizer`` (those of ``state``);
    ``state.step`` advances by one. Metrics are 0-d f32 tensors on the
    device: ``loss``, ``ce``, ``aux`` and ``accuracy``.

    ``accum_steps > 1`` is gradient accumulation: the batch is cut into
    equal chunks, run one after another, their gradients summed and
    divided by ``accum_steps``, then ONE update: for the dense model the
    same gradients as the full batch (equal chunk means) up to f32
    rounding, at 1 / ``accum_steps`` of the activation memory. For a
    routed model the balance loss is computed per chunk and averaged, as
    the JAX step does: not the full batch's routing statistics.

    A routed model whose experts are sharded over an axis across processes
    (``SwitchFFN(mesh=)`` over a `parallel/mesh.py:global_mesh`) takes
    `_cross_process_expert_step`: ``tokens`` is then the global batch."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps}: must be >= 1")
    cells = _expert_cells(model)
    if cells is not None:
        return _cross_process_expert_step(model, optimizer, aux_coef, cells,
                                          accum_steps)

    def loss_fn(tokens):
        ce, acc = next_token_loss(model(tokens), tokens)
        aux = moe_aux_loss(model)
        return ce + aux_coef * aux, torch.stack([ce.detach(), aux.detach(),
                                                 acc])

    def train_step(state: TrainState, tokens: torch.Tensor) -> dict:
        check_state(state, model, optimizer)
        b = tokens.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by "
                             f"accum_steps={accum_steps}")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        sums = torch.zeros(4, device=tokens.device)
        for chunk in tokens.reshape(accum_steps, b // accum_steps, -1):
            loss, parts = loss_fn(chunk)
            loss.backward()
            sums += torch.cat([loss.detach()[None], parts])
        if accum_steps > 1:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, accum_steps)
            sums /= accum_steps
        optimizer.step()
        state.step += 1
        loss, ce, aux, acc = sums.unbind()
        return {"loss": loss, "ce": ce, "aux": aux, "accuracy": acc}

    return train_step


def _expert_cells(model):
    """The expert axis of ``model``'s routed blocks where it crosses
    processes, else None."""
    for m in model.modules():
        if isinstance(m, SwitchFFN) and m.mesh is not None and m.cells.spans:
            return m.cells
    return None


def _cross_process_expert_step(model, optimizer, aux_coef, cells,
                               accum_steps):
    """The step of a routed model whose expert axis crosses processes:
    every process is given the global batch ``[B, T]`` and runs the model
    on its rows (the blocks of its expert shards: its share of the batch
    in rank order), its backward starting from its share of the global
    loss (its rows' mean next-token CE plus ``aux_coef`` × the balance
    loss, which reads the global batch, over the number of processes);
    the exchanges' backward carries the other processes' gradients to its
    expert shards, and the replicated parameters' gradients are summed
    over the processes (``parallel/data.py:reduce_gradients``). Every
    process updates its own shards and the same replicated weights;
    metrics are the global ones."""
    from idunno_tpu_torch.parallel import transport
    from idunno_tpu_torch.parallel.data import reduce_gradients

    if accum_steps != 1:
        raise ValueError("an expert-parallel step across processes takes "
                         "accum_steps=1")
    n_proc = len(set(cells.ranks))
    share = cells.mine[0] // len(cells.mine)
    own = {id(p) for m in model.modules() if isinstance(m, ExpertShard)
           for p in m.parameters()}
    replicated = [p for p in model.parameters() if id(p) not in own]

    def train_step(state: TrainState, tokens: torch.Tensor) -> dict:
        check_state(state, model, optimizer)
        if tokens.shape[0] % n_proc:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"the {n_proc} processes of the expert axis")
        rows = tokens.tensor_split(n_proc)[share]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        ce, acc = next_token_loss(model(rows), rows)
        aux = moe_aux_loss(model)
        loss = ce + aux_coef * aux
        (loss / n_proc).backward()
        reduce_gradients([replicated])
        optimizer.step()
        state.step += 1
        parts = torch.stack([loss.detach(), ce.detach(), aux.detach(), acc])
        loss, ce, aux, acc = (transport.all_reduce(parts) / n_proc).unbind()
        return {"loss": loss, "ce": ce, "aux": aux, "accuracy": acc}

    return train_step


def jit_lm_train_step(model: TransformerLM, optimizer: torch.optim.Optimizer,
                      mesh: Mesh, aux_coef: float = 0.01, *,
                      sequence_parallel: bool = False, axis: str = DATA_AXIS,
                      accum_steps: int = 1):
    """`make_lm_train_step` over ``mesh`` (the JAX ``jit_lm_train_step``)
    for a state placed by ``shard_train_state`` or
    ``fsdp_shard_train_state``: ``step(state, tokens) -> metrics``, the
    tokens ``[B, T]`` (the global batch, or the local groups' parts) cut
    on the batch over the data axis. The loss is the global batch's mean
    next-token cross-entropy plus ``aux_coef`` × the balance loss (for a
    routed model each group's balance loss weighted by its share, as
    ``accum_steps`` averages chunks: not the global batch's routing
    statistics).

    ``sequence_parallel=True`` cuts the tokens on the sequence instead:
    ``axis`` must be the ``seq_axis`` of the model's ring or Ulysses
    ``attn_fn`` over ``mesh``. The state is the
    unplaced one (``create_lm_train_state``): the parameters and the
    residual stream stay on the mesh's lead device (the global view, as
    the JAX package's jit traces it), and only the attention runs per
    group, so the step equals the one-device step on the same weights
    (the loss masks the final position of the whole sequence). Over a
    mesh whose sequence axis crosses processes each process runs the
    whole model over its own slice (`_cross_process_sequence_step`)."""
    if sequence_parallel:
        return _sequence_parallel_step(model, optimizer, mesh, aux_coef,
                                       axis, accum_steps)
    if axis != DATA_AXIS:
        raise ValueError(f"axis {axis!r}: the batch is cut over "
                         f"{DATA_AXIS!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps}: must be >= 1")

    def loss_fn(m, params, tokens):
        if params is None:
            logits = m(tokens)
        else:
            logits = torch.func.functional_call(m, params, (tokens,),
                                                strict=False)
        ce, acc = next_token_loss(logits, tokens)
        aux = moe_aux_loss(m)
        loss = ce + aux_coef * aux
        return loss, torch.stack([loss.detach(), ce.detach(), aux.detach(),
                                  acc])

    def train_step(state: MeshTrainState, tokens) -> dict:
        _check_mesh_state(state, model, optimizer, mesh)
        loss, ce, aux, acc = run_mesh_step(state, [tokens], loss_fn,
                                           accum_steps).unbind()
        return {"loss": loss, "ce": ce, "aux": aux, "accuracy": acc}

    return train_step


class SequenceAxisError(MeshShapeError):
    """A sequence-parallel step whose ``axis`` is not the sequence axis of
    the model's ring or Ulysses attention over the step's mesh."""


def _sequence_axis(model: TransformerLM, mesh: Mesh) -> str | None:
    """The ``seq_axis`` over which ``model``'s blocks attend by ring or
    Ulysses attention on ``mesh``, as ``make_attn_fn`` tags the function
    (None when they attend otherwise)."""
    axes = {getattr(blk.attn.attn_fn, "seq_axis", None)
            if getattr(blk.attn.attn_fn, "seq_mesh", None) == mesh else None
            for blk in model.blocks}
    return axes.pop() if len(axes) == 1 else None


def _sequence_parallel_step(model, optimizer, mesh, aux_coef, axis,
                            accum_steps):
    seq = _sequence_axis(model, mesh)
    if seq != axis:
        raise SequenceAxisError(
            f"sequence_parallel step over axis {axis!r}, but the model "
            f"attends over {seq!r} (want ring or Ulysses attention, "
            "make_attn_fn('ring'|'ulysses', mesh=mesh, axis=axis), on "
            "this step's mesh)", constraint="axis == the attention's "
            "seq_axis")
    cells = mesh.along(axis)
    p = len(cells)
    if cells.spans:
        return _cross_process_sequence_step(model, optimizer, cells, axis,
                                            accum_steps)
    step = make_lm_train_step(model, optimizer, aux_coef, accum_steps)

    def train_step(state: TrainState, tokens: torch.Tensor) -> dict:
        if tokens.shape[1] % p:
            raise ValueError(f"sequence {tokens.shape[1]} not divisible by "
                             f"the {axis!r} axis size {p}")
        return step(state, tokens.to(mesh.lead))

    return train_step


def _cross_process_sequence_step(model, optimizer, cells, axis,
                                 accum_steps):
    """The sequence-parallel step over an axis across processes: each
    process is given the global tokens ``[B, T]`` and runs embedding,
    blocks, final norm, head and loss over its own rows of the sequence
    (its groups', ``AxisCells.span``; RoPE at their global positions), the
    targets reaching one token into the next slice. Each process's
    backward starts from its share of the global mean (its slice's
    summed loss over the global count; the ring's or Ulysses' backward
    exchanges between the processes as it goes), the gradients are summed
    over the processes (``parallel/data.py:reduce_gradients``) and every
    process takes the same update. Metrics are the global ones."""
    from idunno_tpu_torch.parallel import transport
    from idunno_tpu_torch.parallel.data import reduce_gradients

    if accum_steps != 1 or model.ffn_factory is not None:
        raise ValueError("a sequence-parallel step across processes takes "
                         "dense blocks and accum_steps=1")
    lead = cells.devices[cells.mine[0]]

    def train_step(state: TrainState, tokens: torch.Tensor) -> dict:
        check_state(state, model, optimizer)
        b, t = tokens.shape
        if t % len(cells):
            raise ValueError(f"sequence {t} not divisible by the {axis!r} "
                             f"axis size {len(cells)}")
        start, stop = cells.span(t)
        tokens = tokens.to(lead)
        x = tokens[:, start:stop]
        targets = torch.roll(tokens, -1, dims=1)[:, start:stop]
        mask = (torch.arange(start, stop, device=lead) < t - 1).to(
            torch.float32)[None, :]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(x)
        log_probs = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(log_probs, -1, targets[..., None])[..., 0]
        denom = float(b * (t - 1))
        ce = (nll * mask).sum() / denom
        ce.backward()
        reduce_gradients([list(model.parameters())])
        optimizer.step()
        state.step += 1
        with torch.no_grad():
            acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
        ce, acc = transport.all_reduce(torch.stack([ce.detach(), acc]))
        return {"loss": ce, "ce": ce, "aux": torch.zeros_like(ce),
                "accuracy": acc}

    return train_step
