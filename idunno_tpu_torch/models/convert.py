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
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

# (stage sizes, convs per block) of the ResNet names in the registry
_RESNETS = {"resnet": ((2, 2, 2, 2), 2), "resnet18": ((2, 2, 2, 2), 2),
            "resnet34": ((3, 4, 6, 3), 2), "resnet50": ((3, 4, 6, 3), 3)}


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


def state_dict_from_flax(name: str, variables: dict) -> dict[str, torch.Tensor]:
    """The port's state_dict for registry model ``name`` from the JAX
    package's variables of the same model."""
    if name == "alexnet":
        return alexnet_state_dict(variables)
    if name in _RESNETS:
        stages, convs = _RESNETS[name]
        return resnet_state_dict(variables, stages, convs)
    raise ValueError(f"no weight carry for model {name!r}; "
                     f"have alexnet, {', '.join(sorted(_RESNETS))}")
