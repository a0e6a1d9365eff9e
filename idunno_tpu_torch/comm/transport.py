"""Transport abstraction for the DCN control plane.

The reference binds five raw sockets per node (ports `mp4_machinelearning.py
:29-42`) and hand-codes connect/send/recv at every call site. Here a node
talks to a named (host, service) endpoint through one interface with two
delivery modes, and the wire substrate is pluggable:

- ``InProcTransport`` (comm/inproc.py) — loopback delivery inside one
  process, for the fake-cluster test fixture (SURVEY.md §4).
- ``NetTransport`` (comm/net.py) — JSON-over-TCP with length framing plus
  UDP datagrams, for real multi-host deployments over DCN.

Services (the reference's ports): membership, store, inference, result,
metadata, grep.
"""
from __future__ import annotations

import abc
from collections.abc import Callable

from idunno_tpu_torch.comm.message import Message

# handler: (service, msg) -> reply Message or None
Handler = Callable[[str, Message], Message | None]


class TransportError(Exception):
    """Peer unreachable / connection failed — the caller decides whether to
    fail over (the reference's primary→standby retry, `:956-963`).

    ``reason`` types the failure so the retry layer (comm/retry.py) can
    distinguish retryable transport faults from fatal protocol rejections:

    - ``timeout``      — no answer in time (peer may have processed it)
    - ``refused``      — connection refused (peer down / port closed)
    - ``closed``       — peer closed mid-exchange
    - ``unreachable``  — no route / address failure
    - ``stale_epoch``  — fenced by a higher coordinator epoch (never
      retryable; see membership/epoch.py)
    """

    RETRYABLE = frozenset({"timeout", "refused", "closed", "unreachable"})

    def __init__(self, message: str = "",
                 reason: str = "unreachable") -> None:
        super().__init__(message)
        self.reason = reason

    @property
    def retryable(self) -> bool:
        return self.reason in self.RETRYABLE


class Transport(abc.ABC):
    """One node's endpoint: serve handlers, call peers."""

    # optional differential-health feed (membership/health.py): when a
    # HealthLedger is attached here, every reliable call's latency and
    # error observation lands in it. None = no observation (default; the
    # chaos harness only attaches it under the fail-slow flag so seeded
    # schedules without it burn no extra state).
    health = None

    @abc.abstractmethod
    def serve(self, service: str, handler: Handler) -> None:
        """Register the handler for a named service on this node."""

    @abc.abstractmethod
    def call(self, host: str, service: str, msg: Message,
             timeout: float | None = None) -> Message | None:
        """Reliable request/response (the TCP paths). Raises TransportError
        if the peer is unreachable."""

    @abc.abstractmethod
    def datagram(self, host: str, service: str, msg: Message) -> None:
        """Unreliable fire-and-forget (the UDP membership path). Silently
        drops if the peer is unreachable."""

    @abc.abstractmethod
    def close(self) -> None:
        ...
