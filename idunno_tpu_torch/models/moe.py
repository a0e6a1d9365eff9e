"""Mixture-of-experts model family (switch-routed FFN), a port of
``idunno_tpu/models/moe.py``.

A learned router picks the top-k experts per token (k=1 the Switch layer,
k=2 the GShard configuration), and the expert FFNs either all live on the
one device (``mesh=None``, the dense path, which the JAX package also
keeps as the exact ground truth for its expert-parallel path) or are
sharded over the ``expert`` axis of a mesh with all-to-all dispatch
(``mesh=``: `parallel/expert.py:expert_parallel_apply`).

``MoETransformerLM`` is `models/transformer.py:TransformerLM` with the
switch FFN plugged in through ``ffn_factory``: by default on every block;
``moe_every=2`` gives the Switch-Transformer every-other-block layout.

Numerics follow the JAX module op for op: the router is an f32 Dense over
the f32 input, then a softmax; top-k takes the lowest index among equal
probabilities, as ``jax.lax.top_k`` does (a stable descending sort:
``torch.topk`` promises no order among ties); the dispatch and combine
contractions run in f32; the expert FFN casts its tokens and kernels to
the compute dtype, and its f32 biases promote the hidden layer to f32 as
JAX's type promotion does.

Expert parallelism (``mesh=``, a 1-D expert mesh: ``make_mesh(1, p,
axis=EXPERT_AXIS)`` or ``virtual_mesh(1, p, device, axis=EXPERT_AXIS)``):
shard ``s`` of the axis holds experts ``[s·E/p, (s+1)·E/p)`` in an
`ExpertShard` on its own device (``ffn.shards.{s}.w1`` ...; moving the
model leaves them there). The router, the top-k, the balance loss over
all tokens and the f32 dispatch and combine are the dense path's; each
shard dispatches its own block of routing units at the capacity of
``n_units / p`` units, so which units drop depends on p, as in the JAX
package. ``models/convert.py:expert_parallel_state_dict`` and
``dense_state_dict`` carry weights between the two layouts.

Over an expert axis across processes (``parallel/mesh.py:global_mesh(1,
axis=EXPERT_AXIS, across=EXPERT_AXIS)``) a process holds the shards of
its own positions (``shards`` by position) and runs the layer on its own
rows of the batch, its shards' blocks of routing units; the balance loss
reads the global batch's fractions (sums over the processes), and the
dense part is replicated in every process (the train step sums its
gradients over them, ``engine/train_lm.py``).

Training: top-1 routing collapses without pressure toward balance, so each
layer keeps the Switch-Transformer auxiliary load-balancing loss
(E · Σ_e frac_routed_e · mean_prob_e) of its last forward in ``aux``;
``moe_aux_loss(model)`` sums them for adding to the task loss (the JAX
module sows it into flax's ``"losses"`` collection).

Nothing here reads a value back to the host or takes a shape from the
data, so an all-greedy routed decode dispatch is recorded as one CUDA
graph like a dense one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from idunno_tpu_torch.models.init import TRUNC_STD
from idunno_tpu_torch.models.transformer import AttnFn, Dense, TransformerLM
from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.parallel.data import all_reduce_sum
from idunno_tpu_torch.parallel.expert import (COMBINE_SPAN, DISPATCH_SPAN,
                                              EXCHANGE_SPAN, EXPERT_AXIS,
                                              expert_parallel_apply,
                                              switch_dispatch)
from idunno_tpu_torch.utils.tracing import annotate


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, the lower index first among equal values."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def expert_ffn(params: dict, toks: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Every expert's FFN on its [C, dim] buffer, batched over the leading
    expert axis of ``params`` (``w1`` [E, dim, hidden], ``b1`` [E,
    hidden], ``w2`` [E, hidden, dim], ``b2`` [E, dim]) and of ``toks``
    [E, C, dim]: the JAX ``vmap(expert_fn)`` at compute dtype ``dtype``.
    Returns f32 [E, C, dim]."""
    w1, b1, w2, b2 = (params[k] for k in ("w1", "b1", "w2", "b2"))
    h = torch.matmul(toks.to(dtype), w1.to(dtype)) + b1[:, None, :]
    g = F.gelu(h, approximate="tanh")
    # JAX promotes the bf16 kernel to the hidden layer's f32
    out = torch.matmul(g, w2.to(dtype).to(g.dtype)) + b2[:, None, :]
    return out.to(torch.float32)


def _lecun_experts(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` on an [E, in, out] kernel (fan_in is in × E
    there: the expert axis counts as receptive field)."""
    std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class ExpertShard(nn.Module):
    """One expert shard's stacked FFN weights (``w1`` [E/p, dim, hidden],
    ``b1``, ``w2``, ``b2``: the JAX layout, cut on the expert axis), kept on
    its shard's device ``placed``: moving or casting the model
    (``.to``, ``.cuda``) changes their dtype, never their device."""

    int8_dtypes = {"b1": torch.float32, "b2": torch.float32}

    def __init__(self, n_local: int, dim: int, hidden: int,
                 device: torch.device) -> None:
        super().__init__()
        self.placed = torch.device(device)
        kw = dict(device=self.placed)
        self.w1 = nn.Parameter(torch.empty(n_local, dim, hidden, **kw))
        self.b1 = nn.Parameter(torch.zeros(n_local, hidden, **kw))
        self.w2 = nn.Parameter(torch.empty(n_local, hidden, dim, **kw))
        self.b2 = nn.Parameter(torch.zeros(n_local, dim, **kw))

    def _apply(self, fn, recurse=True):
        # the dtype ``fn`` gives, read off an empty tensor: a shard is cast
        # where it lives and never passes through the target device
        def cast_in_place(t):
            dtype = fn(torch.empty(0, dtype=t.dtype, device=t.device)).dtype
            return t.to(self.placed, dtype)
        return super()._apply(cast_in_place, recurse)

    def params(self) -> dict:
        return {"w1": self.w1, "b1": self.b1, "w2": self.w2, "b2": self.b2}


class ExpertShards(nn.ModuleDict):
    """The expert shards a process holds, by their position on the expert
    axis (``shards[s]``, state dict keys ``shards.{s}.w1`` ...): every
    position in one process, its own positions across processes."""

    def __getitem__(self, position) -> ExpertShard:
        return super().__getitem__(str(position))


class SwitchFFN(nn.Module):
    """Top-k routed expert FFN. Input/output [B, T, dim].

    ``k=1`` is the Switch-Transformer layer (gate = raw top prob); ``k>1``
    is GShard-style top-k routing: each token is sent to its k best experts
    with gates renormalised over the chosen k. Each (token, choice) pair is
    its own routing unit, so capacity accounts for all k streams.

    The compute dtype is the input's (the block hands over its activations
    in the model's compute dtype); the expert weights keep the JAX
    layout: ``w1`` [E, dim, hidden], ``b1`` [E, hidden], ``w2`` [E,
    hidden, dim], ``b2`` [E, dim]; with ``mesh=`` they are cut over its
    ``axis`` into ``shards`` (`ExpertShard`, one on each device along the
    axis) and the layer runs `expert_parallel_apply`."""

    # int8 serving (ops/quantize.py) reads these back in f32: the JAX
    # package's dequantize returns f32, and these are the tensors its
    # module consumes without a cast to the compute dtype
    int8_dtypes = {"b1": torch.float32, "b2": torch.float32}

    def __init__(self, dim: int, hidden: int, n_experts: int, k: int = 1,
                 capacity_factor: float = 2.0, mesh=None,
                 axis: str = EXPERT_AXIS) -> None:
        super().__init__()
        if not 1 <= k <= n_experts:
            raise ValueError(f"k={k}: want 1..{n_experts}")
        self.dim, self.hidden, self.n_experts = dim, hidden, n_experts
        self.k, self.capacity_factor = k, capacity_factor
        self.mesh, self.axis = mesh, axis
        self.router = Dense(dim, n_experts)
        self.router.int8_dtypes = {"weight": torch.float32}
        e = n_experts
        if mesh is None:
            self.w1 = nn.Parameter(torch.empty(e, dim, hidden))
            self.b1 = nn.Parameter(torch.zeros(e, hidden))
            self.w2 = nn.Parameter(torch.empty(e, hidden, dim))
            self.b2 = nn.Parameter(torch.zeros(e, dim))
        else:
            cells = mesh.along(axis)
            p = len(cells)
            if e % p:
                raise ValueError(f"{e} experts not divisible by {axis!r} "
                                 f"axis size {p}")
            self.shards = ExpertShards({
                str(s): ExpertShard(e // p, dim, hidden, cells.devices[s])
                for s in cells.mine})
            self.cells = cells
        # the balance loss of the last forward (see moe_aux_loss)
        self.aux: torch.Tensor | None = None

    def __getstate__(self):
        # a copy (``copy.deepcopy`` of a served model) leaves the last
        # forward's loss behind: a tensor inside an autograd graph cannot
        # be deep-copied
        return {**self.__dict__, "aux": None}

    @torch.no_grad()
    def reset_like_flax(self, generator: torch.Generator) -> None:
        """flax's ``lecun_normal`` on the [E, in, out] kernels, zero
        biases; the router is a Dense and is seeded as one. An expert-
        parallel layer draws its whole kernels as the dense layer does and
        cuts them over its shards, so both take the same weights from the
        same generator."""
        if self.mesh is None:
            for w in (self.w1, self.w2):
                _lecun_experts(w, generator)
            nn.init.zeros_(self.b1)
            nn.init.zeros_(self.b2)
            return
        first = next(iter(self.shards.values()))
        for name in ("w1", "w2"):
            w = torch.empty((self.n_experts,) + getattr(first, name).shape[1:],
                            dtype=getattr(first, name).dtype,
                            device=generator.device)
            _lecun_experts(w, generator)
            parts = w.tensor_split(len(self.cells))
            for s in self.cells.mine:
                getattr(self.shards[s], name).copy_(parts[s])
        for shard in self.shards.values():
            nn.init.zeros_(shard.b1)
            nn.init.zeros_(shard.b2)

    def capacity(self, tokens_per_shard: int) -> int:
        # floor at k: one token's k choices can all land on one expert, and
        # for tiny token counts (single-token decode steps) the proportional
        # capacity would otherwise guarantee dropped streams
        return max(self.k, int(self.capacity_factor * tokens_per_shard
                               / self.n_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        n, e = b * t, self.n_experts
        probs = torch.softmax(
            self.router(x.to(torch.float32)).reshape(n, e), dim=-1)
        topk_w, topk_idx = top_k(probs, self.k)                  # [n, k]
        if self.k == 1:
            gate_idx, gate_w = topk_idx[:, 0], topk_w[:, 0]      # switch
        else:
            # GShard top-k: renormalise the chosen gates; flatten so every
            # (token, choice) is one routing unit in dispatch order
            # [t0c0, t0c1, ..., t1c0, ...] (stays aligned with the repeat
            # below and with contiguous token sharding)
            topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
            gate_idx, gate_w = topk_idx.reshape(-1), topk_w.reshape(-1)

        # Switch-Transformer load-balance loss: E · Σ_e f_e · P_e with f_e
        # the top-1 routing fraction, minimized (=1) at uniform routing
        experts = torch.arange(e, device=x.device)
        routed = (topk_idx[:, :1] == experts).to(torch.float32)
        if self.mesh is not None and self.cells.spans:
            # the global batch's fractions: this process holds its rows
            frac, mean_p = all_reduce_sum(torch.stack(
                [routed.sum(dim=0).detach(), probs.sum(dim=0)])) / (
                    n * len(self.cells) / len(self.cells.mine))
        else:
            frac, mean_p = routed.mean(dim=0), probs.mean(dim=0)
        self.aux = e * torch.sum(frac * mean_p)

        flat = x.reshape(n, d)
        if self.k > 1:
            flat = flat[:, None].expand(n, self.k, d).reshape(n * self.k, d)
        n_units = n * self.k
        if self.mesh is not None:
            # this process's units are its shards' blocks
            out = expert_parallel_apply(
                lambda params, toks: expert_ffn(params, toks, x.dtype),
                [shard.params() for shard in self.shards.values()], flat,
                gate_idx, gate_w, self.mesh, axis=self.axis,
                capacity=self.capacity(n_units // len(self.cells.mine)))
        else:
            with annotate(DISPATCH_SPAN):
                dispatch, combine = switch_dispatch(
                    gate_idx, gate_w, e, self.capacity(n_units))
                buf = torch.einsum("nec,nd->ecd", dispatch,
                                   flat.to(torch.float32))
            done = expert_ffn({"w1": self.w1, "b1": self.b1, "w2": self.w2,
                               "b2": self.b2}, buf, x.dtype)
            with annotate(COMBINE_SPAN):
                out = torch.einsum("ecd,nec->nd", done, combine)
        if self.k > 1:
            out = out.reshape(n, self.k, d).sum(dim=1)           # combine k
        return out.reshape(b, t, d).to(x.dtype)


def switch_ffn_factory(n_experts: int, capacity_factor: float = 2.0,
                       mesh=None, axis: str = EXPERT_AXIS,
                       hidden_ratio: int = 4, k: int = 1):
    """An ``ffn_factory`` for `TransformerLM`: ``make(dim)`` builds a
    SwitchFFN in place of a block's dense MLP (experts sharded over
    ``axis`` of ``mesh`` when one is given)."""

    def make(dim: int) -> nn.Module:
        return SwitchFFN(dim=dim, hidden=dim * hidden_ratio,
                         n_experts=n_experts, k=k,
                         capacity_factor=capacity_factor, mesh=mesh,
                         axis=axis)
    # declarative twin of this factory so `engine/generate.py:save_lm` can
    # persist MoE architectures (the JAX package's keys): everything here
    # is data; the mesh is placement, deliberately absent, so a stored
    # model loads dense
    make.lm_store_ffn = {"kind": "switch", "n_experts": n_experts,
                         "capacity_factor": capacity_factor,
                         "hidden_ratio": hidden_ratio, "k": k}
    return make


def MoETransformerLM(vocab: int = 1024, dim: int = 128, depth: int = 2,
                     num_heads: int = 4, n_experts: int = 4,
                     capacity_factor: float = 2.0, causal: bool = True,
                     attn_fn: AttnFn = full_attention, mesh=None,
                     axis: str = EXPERT_AXIS, moe_every: int = 1,
                     hidden_ratio: int = 4, k: int = 1, remat: bool = False,
                     dtype: torch.dtype = torch.float32,
                     compute_dtype: torch.dtype | None = None
                     ) -> TransformerLM:
    """Causal LM with switch-MoE FFNs: `TransformerLM` with the expert
    layer plugged in every ``moe_every``-th block (1 = all blocks, 2 = the
    Switch-Transformer interleave); ``k`` routes each token to its top-k
    experts (GShard top-2 when k=2); ``mesh`` shards every routed block's
    experts over its ``axis``. ``dtype`` is the parameters' dtype,
    ``compute_dtype`` the activations' (flax's ``param_dtype`` and
    ``dtype``)."""
    return TransformerLM(
        vocab=vocab, dim=dim, depth=depth, num_heads=num_heads,
        causal=causal, attn_fn=attn_fn,
        ffn_factory=switch_ffn_factory(n_experts, capacity_factor, mesh,
                                       axis, hidden_ratio=hidden_ratio, k=k),
        ffn_every=moe_every, remat=remat, dtype=dtype,
        compute_dtype=compute_dtype)


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of every routed block's balance loss from ``model``'s last
    forward (0 for a model without one), on the model's device."""
    auxes = [m.aux for m in model.modules()
             if isinstance(m, SwitchFFN) and m.aux is not None]
    if not auxes:
        return torch.zeros((), device=next(model.parameters()).device)
    return torch.stack(auxes).sum()


__all__ = ["COMBINE_SPAN", "DISPATCH_SPAN", "EXCHANGE_SPAN", "ExpertShard",
           "ExpertShards",
           "MoETransformerLM", "SwitchFFN", "expert_ffn", "moe_aux_loss",
           "switch_ffn_factory", "top_k"]
