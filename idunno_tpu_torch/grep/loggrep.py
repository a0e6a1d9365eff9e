"""Distributed log grep (SURVEY.md C14).

The reference's shell command 6 invokes the MP1 grep subsystem —
``mp1_client.Client(cmd).query()`` fanning out to per-VM
``mp1_server.server_program()`` log servers — but those modules are missing
from the repo (`mp4_machinelearning.py:15-16, 1163-1167, 1285`); only the
interface shape is known. This module provides that capability natively:
each node serves regex queries over its local log files; a client fans out
to every alive host and merges per-host matches + counts.
"""
from __future__ import annotations

import os
import re

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.transport import Transport, TransportError
from idunno_tpu_torch.config import ClusterConfig
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.utils.types import MessageType

SERVICE = "grep"
MAX_LINES = 10_000       # per-host reply cap; counts stay exact

_REGEX_META = set(".^$*+?{}[]\\|()")


def is_literal_pattern(pattern: str) -> bool:
    """True when the pattern has no regex metacharacters — eligible for the
    native mmap/OpenMP scanner (`idunno_tpu.native.grep_literal`). Patterns
    containing line terminators are NOT literal-eligible: the native scanner
    searches within single lines, while re.search sees the trailing
    newline."""
    return not (_REGEX_META & set(pattern)) and "\n" not in pattern \
        and "\r" not in pattern


class LogGrepService:
    def __init__(self, host: str, config: ClusterConfig,
                 transport: Transport, membership: MembershipService,
                 log_dir: str = ".") -> None:
        self.host = host
        self.config = config
        self.transport = transport
        self.membership = membership
        self.log_dir = log_dir
        transport.serve(SERVICE, self._handle)

    # -- server side ------------------------------------------------------

    def _handle(self, service: str, msg: Message) -> Message | None:
        if msg.type is not MessageType.GREP:
            return Message(MessageType.ERROR, self.host,
                           {"error": "bad grep verb"})
        raw = msg.payload["pattern"]
        try:
            pattern = re.compile(raw)
        except re.error as e:
            return Message(MessageType.ERROR, self.host,
                           {"error": f"bad pattern: {e}"})
        count, lines = self.grep_local(pattern, raw)
        return Message(MessageType.ACK, self.host,
                       {"count": count, "lines": lines[:MAX_LINES],
                        "truncated": count > MAX_LINES})

    def grep_local(self, pattern: re.Pattern,
                   raw: str | None = None) -> tuple[int, list[str]]:
        """Scan this host's log files. Literal patterns take the native
        mmap/OpenMP scanner; regexes scan line-by-line in Python."""
        count, lines = 0, []
        try:
            log_files = sorted(f for f in os.listdir(self.log_dir)
                               if f.endswith(".log"))
        except FileNotFoundError:
            return 0, []
        use_native = raw is not None and is_literal_pattern(raw)
        for fn in log_files:
            path = os.path.join(self.log_dir, fn)
            if use_native:
                from idunno_tpu_torch import native
                room = max(MAX_LINES - len(lines), 0)
                # hold the fd across scan + line extraction (the native
                # scanner mmaps /proc/self/fd/N → same inode even if the
                # log rotates underneath us mid-query)
                try:
                    f = open(path, "rb")
                except OSError:
                    continue
                with f:
                    fd_path = f"/proc/self/fd/{f.fileno()}"
                    scan_path = fd_path if os.path.exists(fd_path) else path
                    res = native.grep_literal(scan_path, raw,
                                              max_offsets=room)
                    if res is not None:
                        n, offsets = res
                        count += n
                        try:
                            for off in offsets:
                                f.seek(off)
                                text = f.readline().decode(
                                    errors="replace").rstrip()
                                lines.append(f"{fn}:{text}")
                        except OSError:
                            pass
                        continue           # next file (native path done)
            try:
                with open(path, errors="replace") as f:
                    for line in f:
                        if pattern.search(line):
                            count += 1
                            if len(lines) < MAX_LINES:
                                lines.append(f"{fn}:{line.rstrip()}")
            except OSError:
                continue
        return count, lines

    # -- client side ------------------------------------------------------

    def query(self, pattern: str) -> dict[str, dict]:
        """Fan out to every alive host (self included) CONCURRENTLY — the
        wall-clock cost is the slowest host, not the sum (a crashed host not
        yet marked LEAVE would otherwise stall the shell for its full
        timeout). Returns host → {count, lines, truncated} (unreachable
        hosts → error)."""
        from concurrent.futures import ThreadPoolExecutor

        msg = Message(MessageType.GREP, self.host, {"pattern": pattern})

        def ask(h: str) -> tuple[str, dict]:
            if h == self.host:
                reply = self._handle(SERVICE, msg)
            else:
                try:
                    reply = self.transport.call(h, SERVICE, msg, timeout=15.0)
                except TransportError as e:
                    return h, {"error": str(e)}
            if reply is None or reply.type is MessageType.ERROR:
                return h, {"error": (reply.payload.get("error", "no reply")
                                     if reply else "no reply")}
            return h, dict(reply.payload)

        hosts = self.membership.members.alive_hosts()
        with ThreadPoolExecutor(max_workers=max(len(hosts), 1)) as pool:
            return dict(pool.map(ask, hosts))

    @staticmethod
    def total_count(results: dict[str, dict]) -> int:
        return sum(r.get("count", 0) for r in results.values())
