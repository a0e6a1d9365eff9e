"""Real socket transport: JSON/length-framed TCP + UDP datagrams over DCN.

Replaces the reference's five per-port listeners with hand-rolled
``"<SEPARATOR>"`` string frames and 4096-byte buffers
(`mp4_machinelearning.py:29-42, 54-55`): one TCP listener + one UDP socket
per node, length-prefixed binary frames (no delimiter collisions, no partial
-read truncation), service routing in the frame header, blob-safe file
streaming.

Addressing is injected (``addr_of: host -> (ip, tcp_port, udp_port)``) so
nothing is hardcoded (the reference hardcodes the master IP at four call
sites, `:922-939`).
"""
from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from collections.abc import Callable

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.transport import Handler, Transport, TransportError

AddrOf = Callable[[str], tuple[str, int, int]]   # (ip, tcp_port, udp_port)

log = logging.getLogger("idunno.net")

_MAX_FRAME = 1 << 31


def _send_frame(sock: socket.socket, service: str, msg: Message) -> None:
    svc = service.encode()
    body = msg.to_bytes()
    sock.sendall(struct.pack(">HI", len(svc), len(body)) + svc + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> tuple[str, Message]:
    head = _recv_exact(sock, 6)
    svc_len, body_len = struct.unpack(">HI", head)
    if body_len > _MAX_FRAME:
        raise ConnectionError("oversized frame")
    svc = _recv_exact(sock, svc_len).decode()
    body = _recv_exact(sock, body_len)
    return svc, Message.from_bytes(body)


def oneshot_call(ip: str, tcp_port: int, service: str, msg: Message,
                 timeout: float = 10.0) -> Message | None:
    """Pure-client RPC: one framed request/response on a fresh connection,
    no listener bound — how external tools (tests, ops scripts, the remote
    CLI) talk to a node without becoming one. A peer that closes without
    sending a reply frame raises a typed ``closed`` TransportError (every
    service in this codebase replies over TCP, so a bare close means the
    handler died mid-request — retryable, not a silent None)."""
    with socket.create_connection((ip, tcp_port), timeout=timeout) as sock:
        _send_frame(sock, service, msg)
        sock.shutdown(socket.SHUT_WR)
        try:
            _, out = _recv_frame(sock)
            return out
        except ConnectionError as e:
            raise TransportError(f"{ip}:{tcp_port} closed before reply: {e}",
                                 reason="closed") from e


class NetTransport(Transport):
    def __init__(self, host: str, addr_of: AddrOf, bind_ip: str = "0.0.0.0",
                 accept_timeout: float = 0.2) -> None:
        self.host = host
        self._addr_of = addr_of
        self._handlers: dict[str, Handler] = {}
        self._stop = threading.Event()
        # latency source for the optional health feed (injectable)
        self.clock = time.monotonic

        my_ip, tcp_port, udp_port = addr_of(host)
        self._tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._tcp.bind((bind_ip, tcp_port))
        self._tcp.listen(64)
        self._tcp.settimeout(accept_timeout)

        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp.bind((bind_ip, udp_port))
        self._udp.settimeout(accept_timeout)

        self._threads = [
            threading.Thread(target=self._tcp_loop, daemon=True,
                             name=f"{host}-tcp"),
            threading.Thread(target=self._udp_loop, daemon=True,
                             name=f"{host}-udp"),
        ]
        for t in self._threads:
            t.start()

    # -- server side ------------------------------------------------------

    def serve(self, service: str, handler: Handler) -> None:
        self._handlers[service] = handler

    def _tcp_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._tcp.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        svc = "?"
        try:
            with conn:
                conn.settimeout(30.0)
                svc, msg = _recv_frame(conn)
                handler = self._handlers.get(svc)
                out = handler(svc, msg) if handler else None
                if out is not None:
                    _send_frame(conn, svc, out)
        except (ConnectionError, socket.timeout, OSError):
            pass
        except Exception:  # noqa: BLE001 - malformed frame body or a
            # handler bug: drop THIS connection (the client sees a close
            # and errors/retries) but log it instead of spraying a raw
            # thread traceback — the listener itself keeps serving
            log.exception("connection handler error (service %s)", svc)

    def _udp_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._udp.recvfrom(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                svc_len, body_len = struct.unpack(">HI", data[:6])
                svc = data[6:6 + svc_len].decode()
                msg = Message.from_bytes(data[6 + svc_len:6 + svc_len + body_len])
            except Exception:
                continue
            handler = self._handlers.get(svc)
            if handler:
                try:
                    handler(svc, msg)     # datagrams never reply
                except Exception:  # noqa: BLE001 - a handler bug must not
                    # kill the UDP loop: this thread carries every
                    # heartbeat/gossip datagram for the node, and its
                    # silent death would make peers falsely suspect us
                    log.exception("datagram handler error (service %s)",
                                  svc)

    # -- client side ------------------------------------------------------

    def call(self, host: str, service: str, msg: Message,
             timeout: float | None = None) -> Message | None:
        # typed failure reasons instead of one blanket bucket: the retry
        # layer (comm/retry.py) backs off on timeout/refused/closed but a
        # caller can still tell "peer busy" from "peer gone". Order
        # matters: socket.timeout ⊂ OSError, ConnectionRefusedError ⊂
        # ConnectionError ⊂ OSError.
        ip, tcp_port, _ = self._addr_of(host)
        # differential health feed (membership/health.py): real wall
        # latency per call when a ledger is attached. The clock is an
        # injectable attribute so tests can pin it; NetTransport never
        # runs under the seeded chaos harness.
        h = self.health
        t0 = self.clock() if h is not None else 0.0
        try:
            out = oneshot_call(ip, tcp_port, service, msg,
                               timeout=timeout or 10.0)
        except socket.timeout as e:
            if h is not None:
                h.observe(host, self.clock() - t0, error=True)
            raise TransportError(f"{host} timed out: {e}",
                                 reason="timeout") from e
        except ConnectionRefusedError as e:
            if h is not None:
                h.observe(host, self.clock() - t0, error=True)
            raise TransportError(f"{host} refused: {e}",
                                 reason="refused") from e
        except ConnectionError as e:
            if h is not None:
                h.observe(host, self.clock() - t0, error=True)
            raise TransportError(f"{host} closed connection: {e}",
                                 reason="closed") from e
        except OSError as e:
            if h is not None:
                h.observe(host, self.clock() - t0, error=True)
            raise TransportError(f"{host} unreachable: {e}") from e
        if h is not None:
            h.observe(host, self.clock() - t0)
        return out

    def datagram(self, host: str, service: str, msg: Message) -> None:
        try:
            ip, _, udp_port = self._addr_of(host)
            svc = service.encode()
            body = msg.to_bytes()
            self._udp.sendto(struct.pack(">HI", len(svc), len(body)) + svc
                             + body, (ip, udp_port))
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        for s in (self._tcp, self._udp):
            try:
                s.close()
            except OSError:
                pass
