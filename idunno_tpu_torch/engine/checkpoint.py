"""Model checkpointing into the replicated file store, in the port's format.

The counterpart of ``idunno_tpu/engine/checkpoint.py``. The JAX package
serializes its variable trees through ``flax.serialization`` under
``ckpt/<model>``; the port keeps state dicts, and stores them as its own
blobs under names of its own (``ckpt.pt/<model>``), so the two packages
never read each other's checkpoints by accident.

A blob is ``MAGIC``, a 4-byte big-endian header length, a JSON header
(``{"format": FORMAT, ...}`` plus whatever the writer adds, e.g. an LM's
architecture) and ``torch.save`` of a state dict of CPU tensors. It is read
back with ``torch.load(..., weights_only=True)`` and loaded with
``load_state_dict(strict=True)``. A blob that is not in this format (a
flax blob, a wrong header) raises a ``ValueError`` that names the format.

Every ``save`` bumps the store version (put = version++), ``restore`` reads
the latest or any historical version, and replication and re-replication
on failure come from the store layer.
"""
from __future__ import annotations

import io
import json
import struct

import torch
from torch import nn

from idunno_tpu_torch.store.sdfs import FileStoreService

MAGIC = b"ITPT"
FORMAT = "idunno_tpu_torch.state_dict/1"
_HLEN = struct.Struct(">I")


def encode_state(state: dict[str, torch.Tensor], header: dict | None = None
                 ) -> bytes:
    """A state dict (and an optional header of JSON values) → one blob."""
    head = json.dumps({**(header or {}), "format": FORMAT}).encode()
    buf = io.BytesIO()
    torch.save({k: v.detach().to("cpu").contiguous()
                for k, v in state.items()}, buf)
    return MAGIC + _HLEN.pack(len(head)) + head + buf.getvalue()


def decode_state(blob: bytes) -> tuple[dict, dict[str, torch.Tensor]]:
    """One blob → (header, state dict of CPU tensors). Raises ValueError
    when the blob is not in ``FORMAT``."""
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError(f"not a {FORMAT} blob (a checkpoint of another "
                         "format, e.g. the JAX package's flax bytes?)")
    start = len(MAGIC) + _HLEN.size
    if len(blob) < start:
        raise ValueError(f"{FORMAT} blob truncated inside its header")
    (hlen,) = _HLEN.unpack(blob[len(MAGIC):start])
    try:
        header = json.loads(blob[start:start + hlen])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{FORMAT} blob with a corrupt header: {e}") from e
    if not isinstance(header, dict) or header.get("format") != FORMAT:
        got = header.get("format") if isinstance(header, dict) else header
        raise ValueError(f"blob header names format {got!r}, want {FORMAT}")
    state = torch.load(io.BytesIO(blob[start + hlen:]), map_location="cpu",
                       weights_only=True)
    return header, state


def checkpoint_name(model: str) -> str:
    return f"ckpt.pt/{model}"


def _state_of(variables: nn.Module | dict) -> dict[str, torch.Tensor]:
    return (variables.state_dict() if isinstance(variables, nn.Module)
            else variables)


def save_variables(store: FileStoreService, model: str,
                   variables: nn.Module | dict[str, torch.Tensor]) -> int:
    """Store a module's state dict (or a state dict); returns the new
    version."""
    return store.put_bytes(checkpoint_name(model),
                           encode_state(_state_of(variables)))


def restore_variables(store: FileStoreService, model: str,
                      template: nn.Module) -> tuple[nn.Module, int]:
    """Load the latest checkpoint into ``template`` (strictly: every key,
    every shape); returns (template, version)."""
    blob, version = store.get_bytes(checkpoint_name(model))
    template.load_state_dict(decode_state(blob)[1], strict=True)
    return template, version


def checkpoint_holders(store: FileStoreService, model: str) -> list[str]:
    """Hosts currently holding the checkpoint (availability check)."""
    return store.ls(checkpoint_name(model))


def restore_version(store: FileStoreService, model: str, template: nn.Module,
                    version: int) -> nn.Module:
    """Load one historical checkpoint version (rollback target)."""
    blob, _ = store.get_bytes(checkpoint_name(model), version=version)
    template.load_state_dict(decode_state(blob)[1], strict=True)
    return template


# -- full training-state checkpoint/resume ---------------------------------
#
# Resuming TRAINING needs more than weights: the optimizer's moments and
# the step counter too, or adam restarts cold and the loss curve jumps. A
# train-state blob is one ``encode_state`` of the model's state dict (keys
# ``model/<name>``) and the optimizer's per-parameter state (keys
# ``opt/<index>/<name>``), with ``step`` and the optimizer's parameter
# groups in the header, under ``ckpt.pt/train/<job>``; trainers resume
# bit-exactly on any node holding a replica.

_TRAIN = "train"
# the store moves a blob as ONE transport frame (`comm/net.py:_MAX_FRAME`);
# the frame also carries the message's JSON header
_FRAME_HEADROOM = 1 << 16


def train_state_name(job: str) -> str:
    return checkpoint_name(f"train/{job}")


def _frame_cap() -> int:
    from idunno_tpu_torch.comm import net
    return net._MAX_FRAME


def save_train_state(store: FileStoreService, job: str, state) -> int:
    """Store a full train state (``engine/train.py:TrainState``: step,
    model, optimizer); returns the new version. A blob the store's
    transport cannot carry in one frame raises a ValueError naming its
    size and the cap, before anything is sent."""
    flat = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for idx, entry in opt["state"].items():
        for k, v in entry.items():
            if not isinstance(v, torch.Tensor):
                raise ValueError(f"optimizer state {idx}/{k} is not a "
                                 f"tensor ({type(v).__name__})")
            flat[f"opt/{idx}/{k}"] = v
    groups = [{"n_params": len(g["params"])} for g in opt["param_groups"]]
    blob = encode_state(flat, {_TRAIN: {"job": job, "step": int(state.step),
                                        "param_groups": groups}})
    cap = _frame_cap() - _FRAME_HEADROOM
    if len(blob) > cap:
        raise ValueError(
            f"train state of job {job!r} is {len(blob):,} B, over the "
            f"{cap:,} B a store object may have (comm/net.py:_MAX_FRAME = "
            f"{_frame_cap():,} B, less {_FRAME_HEADROOM:,} B of message "
            "header): the store moves a blob in one frame")
    return store.put_bytes(train_state_name(job), blob)


def restore_train_state(store: FileStoreService, job: str, template):
    """Load the latest train state into ``template`` (a freshly made
    ``TrainState`` with the same model and optimizer), in place and
    strictly: every parameter key and shape, every moment's shape
    against its parameter and the parameter-group count must match, or
    ``OptStateLayoutMismatch`` is raised before anything is loaded.
    Returns (template, version)."""
    from idunno_tpu_torch.engine.train_job import OptStateLayoutMismatch

    blob, version = store.get_bytes(train_state_name(job))
    header, flat = decode_state(blob)
    meta = header.get(_TRAIN)
    if not isinstance(meta, dict):
        raise OptStateLayoutMismatch(
            f"{train_state_name(job)!r} holds no train state (its header "
            "has no 'train' entry)")
    model_sd = {k[len("model/"):]: v for k, v in flat.items()
                if k.startswith("model/")}
    want = template.model.state_dict()
    if set(model_sd) != set(want):
        raise OptStateLayoutMismatch(
            f"train state keys differ from the model's: missing "
            f"{sorted(set(want) - set(model_sd))[:5]}, unexpected "
            f"{sorted(set(model_sd) - set(want))[:5]}")
    for k, v in want.items():
        if tuple(model_sd[k].shape) != tuple(v.shape):
            raise OptStateLayoutMismatch(
                f"train state {k!r} has shape {tuple(model_sd[k].shape)}, "
                f"the model {tuple(v.shape)}")
    tmpl = template.optimizer.state_dict()
    groups = meta.get("param_groups", [])
    if len(groups) != len(tmpl["param_groups"]) or any(
            g.get("n_params") != len(t["params"])
            for g, t in zip(groups, tmpl["param_groups"])):
        raise OptStateLayoutMismatch(
            f"train state has {len(groups)} parameter groups "
            f"{[g.get('n_params') for g in groups]}, the optimizer "
            f"{len(tmpl['param_groups'])} "
            f"{[len(t['params']) for t in tmpl['param_groups']]}")
    params = [p for g in template.optimizer.param_groups for p in g["params"]]
    opt_state: dict[int, dict[str, torch.Tensor]] = {}
    for k, v in flat.items():
        if not k.startswith("opt/"):
            continue
        idx, name = k[len("opt/"):].split("/", 1)
        i = int(idx)
        if not 0 <= i < len(params):
            raise OptStateLayoutMismatch(
                f"optimizer state for parameter {i} of {len(params)}")
        if v.dim() and tuple(v.shape) != tuple(params[i].shape):
            raise OptStateLayoutMismatch(
                f"optimizer moment {i}/{name} has shape {tuple(v.shape)}, "
                f"its parameter {tuple(params[i].shape)}")
        opt_state.setdefault(i, {})[name] = v
    template.model.load_state_dict(model_sd, strict=True)
    template.optimizer.load_state_dict(
        {"state": opt_state, "param_groups": tmpl["param_groups"]})
    template.step = int(meta["step"])
    return template, version
