"""Flax → torchvision-keyed state_dict: the weight carry from the JAX package.

``state_dict_from_flax(name, variables)`` takes the JAX package's variables
for a model (a nested dict of numpy arrays, ``{'params': ...,
'batch_stats': ...}``) and returns the port's ``state_dict``. It is the
inverse of ``idunno_tpu/models/convert.py:convert_resnet/convert_alexnet``
(torchvision → Flax), so the two packages can serve the same weights:

- Flax conv kernels are HWIO; torch convs are OIHW → transpose (3, 2, 0, 1).
- Flax Dense is (in, out); torch Linear is (out, in) → transpose.
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (batch_stats) → ``weight``/``bias``/``running_mean``/``running_var``.
- AlexNet's first FC reads a flattened feature map: the NHWC JAX model
  flattens HWC, torch flattens CHW, so fc0's input rows go from HWC order
  back to CHW order.
- Transformer blocks (the LM's and ViT's): DenseGeneral q/k/v kernels
  [dim, H, hd] and the output kernel [H, hd, dim] flatten to the port's
  Linear over H·hd (`_block_state_dict`); a routed block's ``ffn``
  (``block{i}/ffn/router``, ``ffn/{w1,b1,w2,b2}``) comes across too. An
  expert-parallel flax tree has the dense layout (the mesh is code, not
  params): `expert_parallel_state_dict` cuts its expert kernels over the
  shards of the port's expert-parallel module, and `dense_state_dict`
  joins them back.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

# (stage sizes, convs per block) of the ResNet names in the registry
_RESNETS = {"resnet": ((2, 2, 2, 2), 2), "resnet18": ((2, 2, 2, 2), 2),
            "resnet34": ((3, 4, 6, 3), 2), "resnet50": ((3, 4, 6, 3), 3)}
_VITS = ("vit", "vit_tiny")


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(k: Any) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense(k: Any) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _hwc_to_chw_cols(w: np.ndarray, c: int, h: int, wdim: int) -> np.ndarray:
    """Permute a torch Linear weight's input dim from HWC to CHW flattening."""
    out_f, in_f = w.shape
    if in_f != c * h * wdim:
        raise ValueError(f"fc0 takes {in_f} inputs, expected {c}*{h}*{wdim}")
    return w.reshape(out_f, h, wdim, c).transpose(0, 3, 1, 2).reshape(out_f, in_f)


def _bn(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def resnet_state_dict(variables: dict, stage_sizes=(2, 2, 2, 2),
                      convs_per_block: int = 2) -> dict[str, torch.Tensor]:
    """JAX ResNet variables → torchvision ResNet state_dict.
    ``convs_per_block`` is 2 for BasicBlock (18/34), 3 for Bottleneck."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {"conv1.weight": _conv(p["stem_conv"]["kernel"])}
    _bn(sd, "bn1", p["stem_norm"], s["stem_norm"])
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            tp = f"layer{stage + 1}.{block}"
            fp, fs = p[f"stage{stage}_block{block}"], s[f"stage{stage}_block{block}"]
            for c in range(convs_per_block):
                sd[f"{tp}.conv{c + 1}.weight"] = _conv(fp[f"Conv_{c}"]["kernel"])
                _bn(sd, f"{tp}.bn{c + 1}", fp[f"BatchNorm_{c}"],
                    fs[f"BatchNorm_{c}"])
            if "downsample_conv" in fp:
                sd[f"{tp}.downsample.0.weight"] = _conv(
                    fp["downsample_conv"]["kernel"])
                _bn(sd, f"{tp}.downsample.1", fp["downsample_norm"],
                    fs["downsample_norm"])
    sd["fc.weight"] = _dense(p["fc"]["kernel"])
    sd["fc.bias"] = _t(p["fc"]["bias"])
    return sd


def alexnet_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """JAX AlexNet variables → torchvision AlexNet state_dict."""
    p = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    for i, tp in enumerate(["features.0", "features.3", "features.6",
                            "features.8", "features.10"]):
        sd[f"{tp}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        sd[f"{tp}.bias"] = _t(p[f"conv{i}"]["bias"])
    for i, tp in enumerate(["classifier.1", "classifier.4", "classifier.6"]):
        w = np.transpose(np.asarray(p[f"fc{i}"]["kernel"]), (1, 0))
        if i == 0:
            w = _hwc_to_chw_cols(w, c=256, h=6, wdim=6)
        sd[f"{tp}.weight"] = _t(w)
        sd[f"{tp}.bias"] = _t(p[f"fc{i}"]["bias"])
    return sd


def vit_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """JAX ViT variables → the port's ``ViT`` state_dict."""
    p = variables.get("params", variables)
    sd: dict[str, torch.Tensor] = {
        "embed.weight": _conv(p["embed"]["kernel"]),
        "embed.bias": _t(p["embed"]["bias"]),
        "cls": _t(p["cls"]),
        "pos_embed": _t(p["pos_embed"]),
        "ln_f.weight": _t(p["ln_f"]["scale"]),
        "ln_f.bias": _t(p["ln_f"]["bias"]),
        "head.weight": _dense(p["head"]["kernel"]),
        "head.bias": _t(p["head"]["bias"]),
    }
    for i in range(_depth(p)):
        sd.update(_block_state_dict(p[f"block{i}"], f"blocks.{i}"))
    return sd


def state_dict_from_flax(name: str, variables: dict) -> dict[str, torch.Tensor]:
    """The port's state_dict for registry model ``name`` from the JAX
    package's variables of the same model."""
    if name == "alexnet":
        return alexnet_state_dict(variables)
    if name in _RESNETS:
        stages, convs = _RESNETS[name]
        return resnet_state_dict(variables, stages, convs)
    if name in _VITS:
        return vit_state_dict(variables)
    raise ValueError(f"no weight carry for model {name!r}; have alexnet, "
                     f"{', '.join(sorted(_RESNETS) + sorted(_VITS))}")


def _depth(p: dict) -> int:
    """The number of per-block entries ``block0``, ``block1``, ... of
    ``p``; raises when there is none."""
    depth = 0
    while f"block{depth}" in p:
        depth += 1
    if depth == 0:
        raise ValueError("the weight carry takes per-block params "
                         "(block0, block1, ...)")
    return depth


def _block_state_dict(bp: dict, tp: str) -> dict[str, torch.Tensor]:
    """One transformer ``Block``'s flax params → the port's keys under
    ``tp``."""
    sd: dict[str, torch.Tensor] = {}
    for ln in ("ln1", "ln2"):
        sd[f"{tp}.{ln}.weight"] = _t(bp[ln]["scale"])
        sd[f"{tp}.{ln}.bias"] = _t(bp[ln]["bias"])
    for name in ("q", "k", "v"):
        kern = np.asarray(bp["attn"][name]["kernel"])      # [dim, H, hd]
        sd[f"{tp}.attn.{name}.weight"] = _t(kern.reshape(kern.shape[0], -1).T)
        sd[f"{tp}.attn.{name}.bias"] = _t(
            np.asarray(bp["attn"][name]["bias"]).reshape(-1))
    kern = np.asarray(bp["attn"]["out"]["kernel"])         # [H, hd, dim]
    sd[f"{tp}.attn.out.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
    sd[f"{tp}.attn.out.bias"] = _t(bp["attn"]["out"]["bias"])
    if "ffn" in bp:                     # a routed FFN (models/moe.py)
        ffn = bp["ffn"]
        sd[f"{tp}.ffn.router.weight"] = _dense(ffn["router"]["kernel"])
        sd[f"{tp}.ffn.router.bias"] = _t(ffn["router"]["bias"])
        for name in ("w1", "b1", "w2", "b2"):     # the JAX layout as it is
            sd[f"{tp}.ffn.{name}"] = _t(ffn[name])
        return sd
    for name in ("mlp_up", "mlp_down"):
        sd[f"{tp}.{name}.weight"] = _dense(bp[name]["kernel"])
        sd[f"{tp}.{name}.bias"] = _t(bp[name]["bias"])
    return sd


def lm_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The port's ``TransformerLM`` state_dict from the JAX package's
    per-block flax params (``embed``, ``block0..block{L-1}``, ``ln_f``,
    ``head``). DenseGeneral q/k/v kernels are [dim, H, hd] and the output
    kernel [H, hd, dim]; they flatten to the port's Linear over H·hd.
    Dense kernels are (in, out) and transpose; LayerNorm ``scale`` is the
    torch ``weight``. A routed block's ``ffn`` carries its router (a
    Dense) and its expert kernels ``w1``/``b1``/``w2``/``b2``, which keep
    the JAX layout. Tensors come out f32; ``load_state_dict`` casts them
    to the model's dtype."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {
        "embed.weight": _t(p["embed"]["embedding"]),
        "ln_f.weight": _t(p["ln_f"]["scale"]),
        "ln_f.bias": _t(p["ln_f"]["bias"]),
        "head.weight": _dense(p["head"]["kernel"]),
        "head.bias": _t(p["head"]["bias"]),
    }
    for i in range(_depth(p)):
        sd.update(_block_state_dict(p[f"block{i}"], f"blocks.{i}"))
    return sd


def pipelined_lm_params_from_flax(params: dict, depth: int,
                                  num_stages: int) -> dict:
    """The port's pipelined LM params (``engine/pipeline_lm.py:
    partition_lm_params`` over its state dict) from the JAX package's
    dense flax params. A JAX pipelined tree comes across through the JAX
    package's ``merge_lm_params`` first (the caller, which imports it);
    `PipelinedLM.load_pp_params` takes the result."""
    from idunno_tpu_torch.engine.pipeline_lm import partition_lm_params

    return partition_lm_params(lm_state_dict_from_flax(params), depth,
                               num_stages)


# a routed layer's expert kernels: dense ``[prefix.]w1``, expert-parallel
# ``[prefix.]shards.{s}.w1`` (the prefix is ``blocks.{i}.ffn.`` in an LM)
_DENSE_EXPERT = re.compile(r"^(.*\.)?(w1|b1|w2|b2)$")
_SHARD_EXPERT = re.compile(r"^(.*\.)?shards\.(\d+)\.(w1|b1|w2|b2)$")


def expert_parallel_state_dict(state: dict,
                               n_shards: int) -> dict[str, torch.Tensor]:
    """A routed LM's dense state dict (``lm_state_dict_from_flax``'s, or a
    dense module's) in the layout of the same model with its experts cut
    over ``n_shards`` expert shards (``MoETransformerLM(mesh=)``, or of a
    ``SwitchFFN``'s own state dict): each ``ffn.{w1,b1,w2,b2}`` [E, ...]
    becomes ``ffn.shards.{s}.{name}``, the
    contiguous block of experts ``[s·E/p, (s+1)·E/p)``. Every other entry
    passes through. ``load_state_dict`` then copies each shard to the
    device its module keeps it on."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        m = _DENSE_EXPERT.match(key)
        if m is None:
            out[key] = value
            continue
        if value.shape[0] % n_shards:
            raise ValueError(f"{key}: {value.shape[0]} experts not "
                             f"divisible by {n_shards} shards")
        for s, part in enumerate(value.tensor_split(n_shards)):
            out[f"{m.group(1) or ''}shards.{s}.{m.group(2)}"] = part
    return out


def dense_state_dict(state: dict) -> dict[str, torch.Tensor]:
    """The inverse of `expert_parallel_state_dict`: each routed block's
    expert shards joined in shard order into ``ffn.{w1,b1,w2,b2}`` [E,
    ...] on shard 0's device. A dense state dict passes through."""
    out: dict[str, torch.Tensor] = {}
    shards: dict[str, dict[int, torch.Tensor]] = {}
    for key, value in state.items():
        m = _SHARD_EXPERT.match(key)
        if m is None:
            out[key] = value
            continue
        shards.setdefault(f"{m.group(1) or ''}{m.group(3)}", {})[
            int(m.group(2))] = value
    for key, parts in shards.items():
        if sorted(parts) != list(range(len(parts))):
            raise ValueError(f"{key}: expert shards {sorted(parts)} are not "
                             f"0..{len(parts) - 1}")
        first = parts[0]
        out[key] = torch.cat([parts[s].to(first.device)
                              for s in range(len(parts))])
    return out
