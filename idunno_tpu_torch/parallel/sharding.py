"""Sharding policies, a port of ``idunno_tpu/parallel/sharding.py``.

The JAX package writes a ``PartitionSpec`` per parameter leaf and lets
GSPMD place the shards and insert the collectives. The port writes the
split out: a spec names, per parameter of the port's module (its name in
an unquantized ``state_dict``), the dimension of the torch tensor that is
split over the mesh's model axis, or ``None`` when the parameter is
replicated. `param_shard` cuts shard ``s`` of ``n`` out of a tensor (or
an int8 weight), and `shard_lm_params`/`shard_cnn_variables` place every
shard on its device.

LM tensor parallelism (Megatron, Shoeybi et al. 2019; Pope et al. MLSys
2023 for the inference variant): Q/K/V and ``mlp_up`` are COLUMN shards
(output heads / hidden features split), ``out`` and ``mlp_down`` are ROW
shards (contraction dim split, so each ends in one sum over the model
axis: two reductions per block, written out in
`models/transformer.py:ShardedLM`). The unembed (``head``) is
column-sharded over the vocab where the vocab divides, so the sampling
tail resolves its picks from per-shard statistics
(`ops/sampling.py:VocabShards`) and the ``[slots, vocab]`` logits are
never gathered whole; a vocab that does not divide replicates the head.
The embedding, the norms and the row shards' biases stay replicated.

GQA rule: Q heads MUST divide n_model (`mesh.check_head_divisibility`);
KV heads divide-or-replicate — when ``num_kv_heads % n_model != 0`` the
k/v weights and the KV cache stay replicated while Q still shards.

Layouts: the port's ``Dense`` weight is ``[out, in]`` (flax ``[in,
out]``), the q/k/v weights ``[H·hd, dim]`` (flax ``[dim, H, hd]``) and
the attention output ``[dim, H·hd]`` (flax ``[H, hd, dim]``), so a flax
spec on ``H`` is a spec on the port's dim 0 of q/k/v and dim 1 of
``out`` (`models/convert.py` carries the weights between the two).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.nn.utils import parametrize

from idunno_tpu_torch.ops.quantize import QTensor
from idunno_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

# block parameter → the torch dim its Megatron split cuts (column shards
# cut the output dim 0, row shards the contraction dim 1); the row
# shards' biases are added once, after the sum, so they replicate
_BLOCK_RULES = {
    ("attn.q", "weight"): 0, ("attn.q", "bias"): 0,
    ("attn.k", "weight"): 0, ("attn.k", "bias"): 0,
    ("attn.v", "weight"): 0, ("attn.v", "bias"): 0,
    ("attn.out", "weight"): 1,
    ("mlp_up", "weight"): 0, ("mlp_up", "bias"): 0,
    ("mlp_down", "weight"): 1,
}
_BLOCK = re.compile(r"^blocks\.(\d+)\.(.+)\.(weight|bias)$")


@dataclass
class QParam:
    """An int8 weight (`ops/quantize.py`) as a parameter of the split:
    ``qt`` holds the int8 ``q`` in the port's layout and its scale in the
    flax grouping, ``dtype`` the dtype it reads back in."""

    qt: QTensor
    dtype: torch.dtype

    @property
    def shape(self) -> torch.Size:
        return self.qt.q.shape

    def dequantize(self) -> torch.Tensor:
        return self.qt.dequantize(self.dtype)


def module_params(model: nn.Module) -> dict[str, torch.Tensor | QParam]:
    """Every weight and bias of ``model`` by its unquantized ``state_dict``
    name; an int8 weight comes as a `QParam` (its int8 values and scale,
    not a dequantized copy)."""
    out: dict[str, torch.Tensor | QParam] = {}
    for mname, mod in model.named_modules():
        for pname in ("weight", "bias"):
            key = f"{mname}.{pname}" if mname else pname
            if parametrize.is_parametrized(mod, pname):
                plist = mod.parametrizations[pname]
                deq = plist[0]
                out[key] = QParam(QTensor(plist.original0, plist.original1,
                                          deq.view), deq.dtype)
            elif isinstance(mod._parameters.get(pname), torch.Tensor):
                out[key] = mod._parameters[pname]
    return out


def _sanitize(dim: int | None, shape, n_model: int) -> int | None:
    """Clamp a wished-for split to what the tensor can carry: a dim it
    lacks, or one that ``n_model`` does not divide, replicates."""
    if dim is None or n_model <= 1 or dim >= len(shape) \
            or shape[dim] % n_model:
        return None
    return dim


def lm_tp_specs(model: nn.Module, *, n_model: int,
                kv_shard: bool = True) -> dict[str, int | None]:
    """The split of every parameter of a `TransformerLM`: its name → the
    torch dim cut over the model axis, or None (replicated). Int8 weights
    take their weight's rule. ``kv_shard=False`` replicates k/v (GQA
    divide-or-replicate)."""
    specs: dict[str, int | None] = {}
    for name, leaf in module_params(model).items():
        dim = None
        if n_model > 1:
            m = _BLOCK.match(name)
            if m is not None:
                mod, kind = m.group(2), m.group(3)
                if mod in ("attn.k", "attn.v") and not kv_shard:
                    dim = None
                else:
                    dim = _BLOCK_RULES.get((mod, kind))
            elif name in ("head.weight", "head.bias"):
                dim = 0                         # the vocab
        specs[name] = _sanitize(dim, leaf.shape, n_model)
    return specs


def lm_cache_specs(cache: dict, *, n_model: int,
                   kv_shard: bool = True) -> dict[str, tuple]:
    """The split of a depth-stacked decode cache: each leaf's name →
    ``(data dim, model dim)``. The slot axis (dim 1 of ``[L, S, ...]``)
    rides the data axis; the KV head dim (dim 3 of ``cached_k``/
    ``cached_v`` ``[L, S, T, KVH, D]`` and of ``k_scale``/``v_scale``
    ``[L, S, T, KVH]``) is cut over the model axis when the KV heads
    divide, else None."""
    out = {}
    for name, leaf in cache.items():
        model_dim = None
        if n_model > 1 and kv_shard and name in (
                "cached_k", "cached_v", "k_scale", "v_scale"):
            model_dim = _sanitize(3, leaf.shape, n_model)
        out[name] = (1 if leaf.dim() >= 2 else None, model_dim)
    return out


def _view_axis(shape, view, dim: int) -> int:
    """The axis of ``view`` (a refinement of ``shape``) that holds the
    outermost factor of ``shape[dim]``."""
    lead, acc = 1, 1
    for d in range(dim):
        lead *= shape[d]
    for j, v in enumerate(view):
        if acc == lead:
            return j
        acc *= v
    raise ValueError(f"view {view} does not refine shape {tuple(shape)}")


def param_shard(leaf: torch.Tensor | QParam, dim: int | None, s: int,
                n: int) -> torch.Tensor | QParam:
    """Shard ``s`` of ``n`` of a parameter split on ``dim`` (the whole
    parameter when ``dim`` is None). An int8 weight keeps its int8 values:
    ``q`` is cut like the weight, its scale only where the scale varies
    along the cut axis, so the shard dequantizes to the same values as
    the same cut of the dequantized weight."""
    if dim is None:
        return leaf
    size = leaf.shape[dim] // n
    if not isinstance(leaf, QParam):
        return leaf.narrow(dim, s * size, size)
    qt = leaf.qt
    j = _view_axis(qt.q.shape, qt.view, dim)
    view = list(qt.view)
    step = view[j] // n
    view[j] = step
    scale = qt.scale
    if scale.shape[j] != 1:
        scale = scale.narrow(j, s * step, step)
    q = qt.q.narrow(dim, s * size, size)
    return QParam(QTensor(q, scale, tuple(view)), leaf.dtype)


def place_shard(leaf, device):
    """A shard on ``device``, as its own contiguous storage."""
    if isinstance(leaf, QParam):
        return QParam(QTensor(leaf.qt.q.to(device).contiguous(),
                              leaf.qt.scale.to(device).contiguous(),
                              leaf.qt.view), leaf.dtype)
    return leaf.detach().to(device).contiguous()


def shard_lm_params(mesh: Mesh, model: nn.Module, group: int = 0
                    ) -> list[dict[str, torch.Tensor | QParam]]:
    """Every parameter of ``model`` cut by `lm_tp_specs` and placed: one
    dict per model shard ``m``, on the device of data group ``group``'s
    shard ``m`` (a replicated parameter whole on each; one already on
    that device is not copied). Raises `MeshShapeError` when the Q heads
    can't split over the mesh's model axis."""
    from idunno_tpu_torch.parallel.mesh import check_head_divisibility

    n_model = mesh.shape[MODEL_AXIS]
    check_head_divisibility(model.num_heads, n_model)
    kvh = getattr(model, "num_kv_heads", None) or model.num_heads
    params = module_params(model)
    specs = lm_tp_specs(model, n_model=n_model, kv_shard=kvh % n_model == 0)
    return [{name: place_shard(param_shard(leaf, specs[name], m, n_model),
                               mesh.devices[group][m])
             for name, leaf in params.items()}
            for m in range(n_model)]


def tp_collective_bytes(model: Any, slots: int, n_model: int) -> int:
    """Estimated reduction payload per decode step: two row-parallel
    reductions per block (attention out + mlp_down), each over a
    ``[slots, 1, dim]`` activation in the compute dtype. 0 when TP is off
    — the gauge reads as "bytes moved over the model axis per dispatched
    token step"."""
    if n_model <= 1:
        return 0
    itemsize = torch.empty((), dtype=model.compute_dtype).element_size()
    return 2 * model.depth * slots * model.dim * itemsize


def sampling_collective_bytes(model: Any, slots: int, n_model: int) -> int:
    """Estimated merge payload of the vocab-sharded sampling tail per
    decode step: with the unembed column-sharded, each pick merges
    per-row SCALAR shard statistics (running max, mass sum, argmax value
    and index — 4 f32-sized words per row) instead of gathering the
    ``[slots, vocab]`` logits. 0 when TP is off or the vocab doesn't
    divide the model axis (the head replicates and the tail runs on one
    shard)."""
    if n_model <= 1 or model.vocab % n_model:
        return 0
    return 4 * slots * 4


# -- CNN tensor parallelism -------------------------------------------------

def cnn_tp_specs(state_dict: dict[str, torch.Tensor], *, n_model: int,
                 min_features: int = 128) -> dict[str, int | None]:
    """The split of CNN inference weights: the output-features dim (dim 0
    of a torch conv ``[cout, cin, kh, kw]`` or Linear ``[out, in]``; the
    last dim of the flax layouts) of wide kernels is cut over the model
    axis; biases, norms, statistics and narrow layers (the 64-channel
    stem, so a folded preprocess stays whole) replicate."""
    out = {}
    for name, leaf in state_dict.items():
        dim = None
        if (n_model > 1 and leaf.dim() >= 2
                and leaf.shape[0] >= min_features
                and leaf.shape[0] % n_model == 0):
            dim = 0
        out[name] = dim
    return out


def shard_cnn_variables(mesh: Mesh, state_dict: dict[str, torch.Tensor]
                        ) -> list[dict[str, torch.Tensor]]:
    """CNN weights cut by `cnn_tp_specs` and placed: one dict per model
    shard, on the device of data group 0's shard ``m`` (every tensor
    whole on each shard when the mesh has no model-axis extent)."""
    n_model = mesh.shape[MODEL_AXIS]
    specs = cnn_tp_specs(state_dict, n_model=n_model)
    return [{name: place_shard(param_shard(leaf, specs[name], m, n_model),
                          mesh.devices[0][m])
             for name, leaf in state_dict.items()}
            for m in range(n_model)]
