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
mesh's lead device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from idunno_tpu_torch.engine.train import (MeshTrainState, TrainState,
                                           _check_mesh_state, check_state,
                                           create_train_state, run_mesh_step)
from idunno_tpu_torch.models.moe import moe_aux_loss
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
    the JAX step does: not the full batch's routing statistics."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps}: must be >= 1")

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
    (the loss masks the final position of the whole sequence)."""
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
    p = len(mesh.along(axis))
    step = make_lm_train_step(model, optimizer, aux_coef, accum_steps)

    def train_step(state: TrainState, tokens: torch.Tensor) -> dict:
        if tokens.shape[1] % p:
            raise ValueError(f"sequence {tokens.shape[1]} not divisible by "
                             f"the {axis!r} axis size {p}")
        return step(state, tokens.to(mesh.lead))

    return train_step
