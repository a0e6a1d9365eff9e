"""Weight-only int8 for serving, mirroring ``idunno_tpu/ops/quantize.py``.

Serving re-reads every weight per batch (CNN) or per decode step (LM);
symmetric int8 with an f32 scale per channel halves the resident bytes of
bf16 weights and quarters those of f32 ones. Weight-only: no activation
calibration, and the error of each weight is at most half a quantization
step of its channel.

A quantized weight is held as int8 ``q`` plus f32 ``scale`` and
dequantized on use, inside the module's forward: ``quantize_tree``
registers a ``torch.nn.utils.parametrize`` parametrization on the weight,
so every read of ``module.weight`` computes ``(q.float() * scale)`` cast
to the weight's dtype, and no dense copy persists between calls (the
counterpart of the JAX package's dequantize inside the jitted forward).
The parametrization's tensors are buffers, not parameters: an optimizer
never sees them.

The channel grouping is the JAX package's: one scale per index of the
*flax* layout's last axis, the absmax taken over every other axis. The
port's layouts differ from flax's, so each weight is viewed in the flax
grouping first (`flax_view`):

- ``nn.Linear``/``Dense`` ``[out, in]`` (flax ``[in, out]``): one scale per
  output row; convs ``[cout, cin, kh, kw]`` (flax HWIO): one per ``cout``;
- the q/k/v projections ``[H·hd, dim]`` (flax DenseGeneral ``[dim, H,
  hd]``): one scale per ``hd`` index, shared across the heads, and their
  biases ``[H·hd]`` (flax ``[H, hd]``, so quantized there too) likewise;
  a module names such views in its ``flax_views`` attribute;
- ``nn.Embedding`` ``[vocab, dim]`` (flax's layout): one scale per column;
- any other parameter of two or more dimensions keeps flax's layout (ViT's
  ``cls`` and ``pos_embed``): one scale per index of its last axis.

A weight is read back in its own dtype, the dtype every consumer in the
dense models casts it to anyway; a module names the weights it consumes
without such a cast in ``int8_dtypes`` (``{name: torch.float32}``: the
routed FFN's router and biases), which read back in f32 as the JAX
package's dequantize returns them.

``absmax / 127.0`` is computed in the weight's own dtype, as JAX does
(its Python float is weakly typed), then cast to f32; both round half to
even, so ``q`` and ``scale`` are bit-equal to the JAX package's for the
same weights.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn.utils import parametrize


@dataclass
class QTensor:
    """Symmetric int8 weight in the port's layout (``q``) and its f32
    per-channel scale, which broadcasts against ``q.view(view)``."""

    q: torch.Tensor
    scale: torch.Tensor
    view: tuple[int, ...]

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequantize(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """``q * scale`` in f32, cast to ``dtype`` when given. One kernel
        that computes in f32 and rounds on the store, bit-equal to
        ``(q.float() * scale).to(dtype)`` but with no f32 temporaries: the
        only allocation is the ``dtype`` result (a captured decode
        dispatch's graph pool holds the largest one)."""
        out = torch.empty(self.view, dtype=dtype or torch.float32,
                          device=self.q.device)
        torch.mul(self.q.view(self.view), self.scale, out=out)
        return out.view(self.q.shape)


def quantize_leaf(w: torch.Tensor, view: tuple[int, ...] | None = None,
                  axis: int = -1) -> QTensor:
    """Symmetric int8 with one scale per index of ``axis`` of
    ``w.reshape(view)`` (default: ``w``'s own shape and last axis):
    scale = max|w| / 127 over every other axis, in ``w``'s dtype, then f32;
    zero channels get scale 1 (no 0/0)."""
    view = tuple(w.shape) if view is None else tuple(view)
    x = w.detach().reshape(view)
    axis %= x.dim()
    others = tuple(i for i in range(x.dim()) if i != axis)
    absmax = x.abs().amax(dim=others, keepdim=True) if others else x.abs()
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return QTensor(q=q.to(torch.int8).reshape(w.shape).contiguous(),
                   scale=scale, view=view)


def flax_view(module: nn.Module, name: str,
              w: torch.Tensor) -> tuple[tuple[int, ...], int]:
    """``(view, axis)``: ``w.reshape(view)`` grouped per index of ``axis``
    is the JAX package's grouping of the same weight (module docstring)."""
    views = getattr(module, "flax_views", {})
    if name in views:
        return views[name]
    if isinstance(module, nn.Embedding):
        return tuple(w.shape), w.dim() - 1
    if name == "weight":                # torch's output-first layouts
        return tuple(w.shape), 0
    return tuple(w.shape), w.dim() - 1


def default_should_quantize(path: str, leaf: torch.Tensor) -> bool:
    """Quantize float leaves of two or more dimensions in the flax view
    (Dense, DenseGeneral, Conv and Embed kernels, the q/k/v biases, ViT's
    ``cls``/``pos_embed``); biases and norm scales stay as they are."""
    del path
    return leaf.dim() >= 2 and leaf.is_floating_point()


class _Dequantize(nn.Module):
    """The parametrization of one quantized weight: stored as (int8 ``q``,
    f32 ``scale``), read as ``q * scale`` in the weight's dtype."""

    def __init__(self, view: tuple[int, ...], axis: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.view, self.axis, self.dtype = view, axis, dtype

    def forward(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return QTensor(q, scale, self.view).dequantize(self.dtype)

    def right_inverse(self, w: torch.Tensor):
        qt = quantize_leaf(w, self.view, self.axis)
        return qt.q, qt.scale


def quantize_tree(model: nn.Module,
                  should_quantize: Callable[[str, torch.Tensor], bool]
                  = default_should_quantize) -> nn.Module:
    """Quantize, in place, every parameter of ``model`` (each module's
    own, so per layer) that ``should_quantize(path, leaf in its flax
    view)`` selects; returns ``model``. Cast and move the model before:
    ``model.to(dtype)`` afterwards would round the f32 scales too."""
    for mod_name, mod in list(model.named_modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            view, axis = flax_view(mod, name, p)
            path = f"{mod_name}.{name}" if mod_name else name
            if not should_quantize(path, p.detach().reshape(view)):
                continue
            del mod._parameters[name]
            mod.register_buffer(name, p.detach())
            dtype = getattr(mod, "int8_dtypes", {}).get(name, p.dtype)
            # unsafe: the read-back dtype may differ from the stored one
            parametrize.register_parametrization(
                mod, name, _Dequantize(view, axis, dtype),
                unsafe=dtype != p.dtype)
    return model


def qtensors(model: nn.Module) -> dict[str, QTensor]:
    """Path → ``QTensor`` of every quantized weight of ``model``."""
    out = {}
    for mod_name, mod in model.named_modules():
        if not parametrize.is_parametrized(mod):
            continue
        for name, plist in mod.parametrizations.items():
            if isinstance(plist[0], _Dequantize):
                path = f"{mod_name}.{name}" if mod_name else name
                out[path] = QTensor(plist.original0, plist.original1,
                                    plist[0].view)
    return out


def _plain_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` without the parametrizations' tensors."""
    return {k: v for k, v in model.state_dict().items()
            if not (k.startswith("parametrizations.")
                    or ".parametrizations." in k)}


def dequantize_tree(model: nn.Module,
                    dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The inverse: a state_dict of the unquantized model, each quantized
    weight as ``q * scale`` in f32 (or ``dtype``), every other tensor as
    it is."""
    sd = _plain_state(model)
    for path, qt in qtensors(model).items():
        sd[path] = qt.dequantize(dtype)
    return sd


def quantized_bytes(model: nn.Module) -> tuple[int, int]:
    """(bytes as stored, bytes if the quantized weights were dense f32),
    over the parameters and the running statistics; torch's
    ``num_batches_tracked`` counters, which the flax tree does not hold,
    are left out."""
    stored = dense = 0
    for qt in qtensors(model).values():
        stored += qt.q.numel() + 4 * qt.scale.numel()
        dense += 4 * qt.q.numel()
    for key, t in _plain_state(model).items():
        if key.endswith("num_batches_tracked"):
            continue
        stored += t.numel() * t.element_size()
        dense += t.numel() * t.element_size()
    return stored, dense
