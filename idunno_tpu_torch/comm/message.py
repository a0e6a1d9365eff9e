"""Typed control-plane messages.

The reference's wire format is ad hoc: JSON dicts over UDP for membership
(`mp4_machinelearning.py:183-184, 212-213`) and ``"<SEPARATOR>"``-joined
string frames over TCP for everything else (`:54`, e.g. `:800-801`) — with
the documented ``receive_metadata`` corruption bug where raw strings are
assigned over dict-typed fields (`:989-1011`, SURVEY.md §7 "bugs not to
replicate"). Here every message is one typed envelope with a JSON-object
payload, the same shape on every service.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from idunno_tpu_torch.utils.types import MessageType


@dataclass
class Message:
    type: MessageType
    sender: str
    payload: dict[str, Any] = field(default_factory=dict)
    # Raw bytes rider for file content — framed separately so payloads stay
    # printable JSON (the reference streams file bytes on the same socket
    # after a string header, `mp4_machinelearning.py:103-111`).
    blob: bytes = b""

    def to_bytes(self) -> bytes:
        head = json.dumps({"type": self.type.value, "sender": self.sender,
                           "payload": self.payload}).encode()
        return (len(head).to_bytes(4, "big") + head
                + len(self.blob).to_bytes(8, "big") + self.blob)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Message":
        hlen = int.from_bytes(data[:4], "big")
        head = json.loads(data[4:4 + hlen].decode())
        boff = 4 + hlen
        blen = int.from_bytes(data[boff:boff + 8], "big")
        blob = data[boff + 8:boff + 8 + blen]
        return cls(type=MessageType(head["type"]), sender=head["sender"],
                   payload=head["payload"], blob=blob)
