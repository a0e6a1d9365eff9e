"""Protocol enums — the typed replacement for the reference's string constants
(`utils.py:7-28`: `Status`, `Type`, `Field`)."""
from __future__ import annotations

import enum


class MemberStatus(str, enum.Enum):
    """Reference `Status` (`utils.py:7-10`; NEW and RUNNING are both 'RUNNING'
    there — we keep them distinct but both count as alive)."""

    NEW = "NEW"
    RUNNING = "RUNNING"
    LEAVE = "LEAVE"

    @property
    def alive(self) -> bool:
        return self is not MemberStatus.LEAVE


class MessageType(str, enum.Enum):
    """Reference `Type` (`utils.py:11-23`) plus control-plane additions."""

    PING = "PING"
    PONG = "PONG"
    JOIN = "JOIN"
    LEAVE = "LEAVE"

    PUT = "PUT"
    GET = "GET"
    DELETE = "DELETE"
    LS = "LS"
    STORE = "STORE"
    GET_VERSIONS = "GET_VERSIONS"
    STAT = "STAT"

    INFERENCE = "INFERENCE"
    JOB = "JOB"
    RESULT = "RESULT"
    METADATA = "METADATA"
    GREP = "GREP"
    ACK = "ACK"
    ERROR = "ERROR"
