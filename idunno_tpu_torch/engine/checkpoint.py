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
