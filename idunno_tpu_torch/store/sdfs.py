"""Replicated, versioned file store — the SDFS equivalent (SURVEY.md C4).

Capability surface preserved from the reference: ``put`` (version++ on every
write), ``get`` (latest version), ``get_versions`` (last k merged with
version delimiters), ``delete``, ``ls`` (which hosts store a file),
``store`` (what this host stores), master-centric metadata, hash-ring
replica placement, and re-replication when a holder dies
(`mp4_machinelearning.py:305-481, 852-874, 886-945, 1070-1102`).

Re-architected:
- One typed request/reply per verb over the transport — no two-connection
  GET dance (`:399-455`) and no delimiter-framed strings.
- Placement = first ``replication_factor`` *alive* hosts in ring order from
  the stable hash slot (`utils.py:48-55` semantics, minus the dead-host
  blind spot), plus the acting master's own copy (`:355-357`).
- Recovery is ring-native: on a holder's death EVERY node scans its own
  replicas and the surviving ring members push each affected key's versions
  to the ring successors that joined the post-death set — no master
  metadata drives the copy pass (the reference's `monitor_program`
  re-replication, `:852-874`, walks master state instead). A new acting
  master does NOT rebuild metadata from cluster-wide inventories on
  failover; it resolves each key lazily on first touch by probing that
  key's ring hosts (`_resolve`). Deletes leave versioned tombstones so a
  partitioned holder cannot resurrect a deleted file at resolve time;
  version numbers stay monotone across delete/re-put and across master
  failover (the put path resolves before reserving).
- Metadata locks are actually held (the reference's ``sdfs_lock`` never is —
  SURVEY.md §5), and network I/O happens *outside* them so one slow replica
  cannot serialize the master.
- DELETE removes each holder's copies exactly once (the reference crashes
  on a double-remove, `:466-472`).
"""
from __future__ import annotations

import json
import os
import re
import threading
import uuid
import zlib

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.retry import call_hedged, call_with_retry
from idunno_tpu_torch.comm.transport import Transport, TransportError
from idunno_tpu_torch.config import ClusterConfig
from idunno_tpu_torch.membership.epoch import (check_payload, observe_payload,
                                         reply_is_stale)
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.utils.ring import ring_order
from idunno_tpu_torch.utils.spans import stamp_trace, trace_from_payload
from idunno_tpu_torch.utils.types import MemberStatus, MessageType

SERVICE = "store"

# get_versions delimiter, shaped like the reference's `#...version N...#`
# markers (`mp4_machinelearning.py:407-441`) but emitted as bytes.
VERSION_DELIM = b"#----------version %d----------#\n"

_MANIFEST = "_MANIFEST.json"
_TOMBSTONES = "_TOMBSTONES.json"


def _safe(name: str) -> str:
    """Filesystem-safe local key; the crc suffix keeps distinct raw names
    (e.g. ``a/b`` vs ``a_b``) from colliding after sanitisation."""
    clean = re.sub(r"[^A-Za-z0-9._-]", "_", name)
    if clean == name and not name.startswith("_"):
        return name
    return f"{clean}.{zlib.crc32(name.encode()):08x}"


class StoreError(Exception):
    pass


class _LocalReplicas:
    """This host's on-disk replica set: versioned blobs, a manifest mapping
    sanitized filenames back to raw SDFS names (so failover rebuilds see the
    real names), and delete tombstones. Thread-safe; owns its own lock."""

    def __init__(self, data_dir: str) -> None:
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._lock = threading.RLock()
        self._raw_of: dict[str, str] = {}          # safe -> raw
        self._versions: dict[str, set[int]] = {}   # raw -> versions held
        self._tombstones: dict[str, int] = {}      # raw -> deleted-thru version
        self._load()

    def _load(self) -> None:
        mpath = os.path.join(self.data_dir, _MANIFEST)
        if os.path.exists(mpath):
            with open(mpath) as f:
                self._raw_of = json.load(f)
        tpath = os.path.join(self.data_dir, _TOMBSTONES)
        if os.path.exists(tpath):
            with open(tpath) as f:
                self._tombstones = {k: int(v) for k, v in json.load(f).items()}
        for fn in os.listdir(self.data_dir):
            m = re.match(r"(.+)\.v(\d+)$", fn)
            if m:
                raw = self._raw_of.get(m.group(1), m.group(1))
                self._versions.setdefault(raw, set()).add(int(m.group(2)))

    def _persist_meta(self) -> None:
        with open(os.path.join(self.data_dir, _MANIFEST), "w") as f:
            json.dump(self._raw_of, f)
        with open(os.path.join(self.data_dir, _TOMBSTONES), "w") as f:
            json.dump(self._tombstones, f)

    def _path(self, name: str, version: int) -> str:
        return os.path.join(self.data_dir, f"{_safe(name)}.v{version}")

    def write(self, name: str, version: int, blob: bytes) -> None:
        with self._lock:
            with open(self._path(name, version), "wb") as f:
                f.write(blob)
            self._raw_of[_safe(name)] = name
            self._versions.setdefault(name, set()).add(version)
            self._persist_meta()

    def read(self, name: str, version: int) -> bytes | None:
        try:
            with open(self._path(name, version), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, name: str, thru_version: int) -> None:
        """Remove local copies and remember the tombstone."""
        with self._lock:
            for v in self._versions.pop(name, set()):
                try:
                    os.remove(self._path(name, v))
                except FileNotFoundError:
                    pass
            self._tombstones[name] = max(
                self._tombstones.get(name, 0), thru_version)
            self._persist_meta()

    def files(self) -> dict[str, list[int]]:
        with self._lock:
            return {n: sorted(vs) for n, vs in self._versions.items()}

    def tombstones(self) -> dict[str, int]:
        with self._lock:
            return dict(self._tombstones)


class FileStoreService:
    """One per node; master role follows ``membership.acting_master``."""

    def __init__(self, host: str, config: ClusterConfig,
                 transport: Transport, membership: MembershipService,
                 data_dir: str) -> None:
        self.host = host
        self.config = config
        self.transport = transport
        self.membership = membership
        self.local = _LocalReplicas(data_dir)
        # master metadata (authoritative only on the acting master);
        # _meta_lock guards these dicts ONLY — never held across network I/O.
        self._meta_lock = threading.RLock()
        self._versions: dict[str, int] = {}
        self._locations: dict[str, set[str]] = {}
        # client put idempotency keys → (version, holders): a retried put
        # whose ACK was lost returns its ORIGINAL version instead of
        # writing (and versioning) the blob twice. Recorded only on
        # success — a failed put must stay retryable.
        self._put_idem: dict[str, tuple[int, list[str]]] = {}
        # serializes death-event repairs (rebuild + re-replication) so two
        # quick successive deaths don't interleave their copy passes; the
        # repairs themselves run OFF the membership monitor loop
        self._repair_serial = threading.Lock()
        self._repair_threads: list[threading.Thread] = []
        # full inventory sweeps performed (diagnostic surface only —
        # failover no longer triggers one; ring repair + lazy per-key
        # resolution replaced it, and tests pin this at 0 across a
        # master takeover)
        self.rebuilds = 0
        # SpanStore wired by serve/node.py; None = tracing off
        self.spans = None
        transport.serve(SERVICE, self._handle)
        membership.on_change(self._on_member_change)

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #

    def _replica_hosts(self, name: str) -> list[str]:
        """First ``replication_factor`` alive hosts in ring order from the
        hash slot, always including the acting master."""
        alive = set(self.membership.members.alive_hosts()) or {self.host}
        ordered = ring_order(name, self.config.hosts)
        chosen = [h for h in ordered
                  if h in alive][:self.config.replication_factor]
        master = self.membership.acting_master()
        if master in alive and master not in chosen:
            chosen.append(master)
        return chosen

    # ------------------------------------------------------------------ #
    # client API (runs on any node; routes to the acting master)
    # ------------------------------------------------------------------ #

    def _master_call(self, msg: Message) -> Message:
        """Primary→standby failover, like `send_inference_command`
        (`:956-963`) — but each hop retries transient TransportErrors with
        bounded backoff (comm/retry.py; safe because the mutating verb,
        put, carries a client idempotency key), and a target that answers
        "not master" or "stale epoch" is skipped, not fatal: during a
        failover window the route advances to whoever actually holds the
        current epoch."""
        cfg = self.config
        master = self.membership.acting_master()
        targets = [master]
        for t in (cfg.coordinator, cfg.standby_coordinator):
            if t not in targets:
                targets.append(t)
        last: Exception | str | None = None
        for t in targets:
            if t == self.host:
                out = self._handle_as_master(msg)
            else:
                try:
                    out = call_with_retry(
                        lambda t=t: self.transport.call(t, SERVICE, msg,
                                                        timeout=30.0),
                        attempts=cfg.rpc_retry_attempts,
                        base_s=cfg.rpc_retry_base_s,
                        cap_s=cfg.rpc_retry_cap_s,
                        deadline_s=cfg.rpc_retry_deadline_s)
                except TransportError as e:
                    last = e
                    continue
            if out is not None:
                observe_payload(self.membership.epoch, out.payload)
                if out.type is MessageType.ERROR:
                    if out.payload.get("not_master") \
                            or out.payload.get("stale_epoch"):
                        last = out.payload.get("error", "not master")
                        continue
                    raise StoreError(out.payload.get("error", "store error"))
                return out
        raise StoreError(f"no reachable master: {last}")

    def put(self, local_path: str, sdfs_name: str) -> int:
        """Upload; returns the new version number."""
        with open(local_path, "rb") as f:
            blob = f.read()
        return self.put_bytes(sdfs_name, blob)

    def put_bytes(self, sdfs_name: str, blob: bytes) -> int:
        # one idempotency key for the whole attempt tree: every retry of
        # this logical put (transport-level AND the failover hop to the
        # standby) dedupes to one version bump server-side
        idem = f"{self.host}:{uuid.uuid4().hex}"
        payload = {"name": sdfs_name, "idem": idem}
        sp = None
        if self.spans is not None:
            sp = self.spans.start("sdfs.put", attrs={"name": sdfs_name,
                                                     "bytes": len(blob)})
            stamp_trace(payload, sp.ctx)
        try:
            out = self._master_call(Message(MessageType.PUT, self.host,
                                            payload, blob=blob))
        except Exception:
            if sp is not None:
                self.spans.finish(sp, error=True)
            raise
        if sp is not None:
            self.spans.finish(sp, version=int(out.payload["version"]))
        return int(out.payload["version"])

    def get(self, sdfs_name: str, local_path: str) -> int:
        blob, version = self.get_bytes(sdfs_name)
        with open(local_path, "wb") as f:
            f.write(blob)
        return version

    def get_bytes(self, sdfs_name: str,
                  version: int | None = None) -> tuple[bytes, int]:
        """Fetch the latest (or one specific historical) version."""
        payload: dict = {"name": sdfs_name}
        if version is not None:
            payload["version"] = version
        sp = None
        if self.spans is not None:
            sp = self.spans.start("sdfs.get", attrs={"name": sdfs_name})
            stamp_trace(payload, sp.ctx)
        try:
            out = self._master_call(Message(MessageType.GET, self.host,
                                            payload))
        except Exception:
            if sp is not None:
                self.spans.finish(sp, error=True)
            raise
        if sp is not None:
            self.spans.finish(sp, version=int(out.payload["version"]),
                              bytes=len(out.blob or b""))
        return out.blob, int(out.payload["version"])

    def get_versions(self, sdfs_name: str, num_versions: int,
                     local_path: str) -> list[int]:
        """Last k versions merged into ``local_path`` with version
        delimiters (`:406-441`); returns the version numbers included."""
        out = self._master_call(Message(
            MessageType.GET_VERSIONS, self.host,
            {"name": sdfs_name, "k": num_versions}))
        with open(local_path, "wb") as f:
            f.write(out.blob)
        return list(out.payload["versions"])

    def delete(self, sdfs_name: str) -> None:
        self._master_call(Message(MessageType.DELETE, self.host,
                                  {"name": sdfs_name}))

    def ls(self, sdfs_name: str) -> list[str]:
        out = self._master_call(Message(MessageType.LS, self.host,
                                        {"name": sdfs_name}))
        return list(out.payload["hosts"])

    def stat(self, sdfs_name: str) -> tuple[int, list[str]]:
        """(latest version, holder hosts) — metadata only, no blob transfer.
        Lets readers with a local replica decide whether it is CURRENT
        before serving it (a stale local copy must not masquerade as the
        latest). Raises StoreError when the file does not exist.

        With ``config.hedge_reads`` on, the pure STAT read tail-hedges
        (HEDGE_SAFE; comm/retry.py:call_hedged) across the first two
        master-chain targets: a read the primary has not answered within
        ``hedge_delay_s`` fires at the backup and the first reply wins —
        masters max-merge versions so either answer is valid. Any hedge
        trouble (errors, not_master, a single-target chain) degrades to
        the plain retrying chain below, never fails the read."""
        msg = Message(MessageType.STAT, self.host, {"name": sdfs_name})
        cfg = self.config
        if cfg.hedge_reads:
            seen: set[str] = set()
            chain = [t for t in (self.membership.acting_master(),
                                 cfg.coordinator, cfg.standby_coordinator)
                     if t != self.host and not (t in seen or seen.add(t))]

            def leg(t: str) -> Message:
                out = self.transport.call(t, SERVICE, msg, timeout=30.0)
                if out is None:
                    raise TransportError(f"{t}: no stat reply",
                                         reason="timeout")
                observe_payload(self.membership.epoch, out.payload)
                if out.type is MessageType.ERROR:
                    # not_master / stale epoch / missing file: let the
                    # failover chain below classify it properly
                    raise TransportError(
                        f"{t}: {out.payload.get('error', 'stat error')}",
                        reason="timeout")
                return out

            if len(chain) >= 2:
                try:
                    out = call_hedged(
                        [lambda: leg(chain[0]), lambda: leg(chain[1])],
                        delay_s=cfg.hedge_delay_s)
                    return (int(out.payload["version"]),
                            list(out.payload["hosts"]))
                except TransportError:
                    pass
        out = self._master_call(msg)
        return int(out.payload["version"]), list(out.payload["hosts"])

    def local_files(self) -> dict[str, list[int]]:
        """`store` verb: everything this host holds (`:1096-1098`)."""
        return self.local.files()

    # ------------------------------------------------------------------ #
    # service handlers
    # ------------------------------------------------------------------ #

    def _handle(self, service: str, msg: Message) -> Message | None:
        # fence BOTH planes before dispatch: an internal push/delete from
        # a deposed master and a stale-stamped client verb are rejected
        # here, so a healed partition cannot overwrite replicas or
        # metadata with the old master's writes
        stale = check_payload(self.membership.epoch, msg.payload, self.host)
        if stale is not None:
            return stale
        if msg.payload.get("internal", False):
            return self._handle_internal(msg)
        return self._handle_as_master(msg)

    def _err(self, text: str) -> Message:
        return Message(MessageType.ERROR, self.host, {"error": text})

    def _handle_internal(self, msg: Message) -> Message | None:
        # internal verbs are master-originated and epoch-stamped; the
        # fence already ran in _handle before dispatch reached here
        if msg.type is MessageType.STORE:      # inventory query (rebuild)
            return Message(MessageType.ACK, self.host,
                           {"files": self.local.files(),
                            "tombstones": self.local.tombstones()})
        if msg.type is MessageType.STAT and "names" in msg.payload:
            # batched inventory probe: one round-trip answers
            # every name a resolving master needs from this host
            files, tombs = self.local.files(), self.local.tombstones()
            return Message(MessageType.ACK, self.host,
                           {"stats": {n: {"versions": files.get(n, []),
                                          "tombstone": tombs.get(n, 0)}
                                      for n in msg.payload["names"]}})
        name = msg.payload["name"]
        if msg.type is MessageType.STAT:       # per-key inventory probe
            return Message(MessageType.ACK, self.host,
                           {"versions": self.local.files().get(name, []),
                            "tombstone":
                                self.local.tombstones().get(name, 0)})
        if msg.type is MessageType.PUT:        # replica push
            if int(msg.payload["version"]) <= \
                    self.local.tombstones().get(name, 0):
                # a ring-repair push racing a delete must not resurrect a
                # tombstoned version on this host; ACK so the pusher
                # doesn't retry — the write is correctly a no-op
                return Message(MessageType.ACK, self.host,
                               {"tombstoned": True})
            self.local.write(name, int(msg.payload["version"]), msg.blob)
            return Message(MessageType.ACK, self.host)
        if msg.type is MessageType.GET:        # replica fetch
            blob = self.local.read(name, int(msg.payload["version"]))
            if blob is None:
                return self._err("version not held")
            return Message(MessageType.ACK, self.host, blob=blob)
        if msg.type is MessageType.DELETE:     # tombstoned removal
            self.local.delete(name, int(msg.payload["version"]))
            return Message(MessageType.ACK, self.host)
        return self._err(f"bad internal verb {msg.type}")

    def _handle_as_master(self, msg: Message) -> Message:
        if not self.membership.is_acting_master:
            out = self._err(f"{self.host} is not the acting master")
            out.payload["not_master"] = True     # route on, don't fail
            return out
        name = msg.payload.get("name", "")
        if msg.type is MessageType.PUT:
            return self._master_put(name, msg.blob,
                                    idem=msg.payload.get("idem"),
                                    trace=trace_from_payload(msg.payload))
        if msg.type is MessageType.GET:
            want = msg.payload.get("version")
            return self._master_get(name,
                                    None if want is None else int(want),
                                    trace=trace_from_payload(msg.payload))
        if msg.type is MessageType.GET_VERSIONS:
            return self._master_get_versions(name, int(msg.payload["k"]))
        if msg.type is MessageType.DELETE:
            return self._master_delete(name)
        if msg.type is MessageType.LS:
            self._snapshot_or_resolve(name)      # lazy-resolve on a miss
            with self._meta_lock:
                hosts = sorted(self._locations.get(name, set()))
            return Message(MessageType.ACK, self.host, {"hosts": hosts})
        if msg.type is MessageType.STAT:
            snap = self._snapshot_or_resolve(name)
            if snap is None:
                return self._err("file not found")
            version, holders = snap
            return Message(MessageType.ACK, self.host,
                           {"version": version, "hosts": sorted(holders)})
        return self._err(f"bad verb {msg.type}")

    # -- master verb implementations --------------------------------------

    def _master_put(self, name: str, blob: bytes,
                    idem: str | None = None,
                    trace: tuple | None = None) -> Message:
        with self._meta_lock:
            if idem is not None and idem in self._put_idem:
                # client retry of an already-completed put (lost ACK):
                # same version, no second replica push
                version, hosts = self._put_idem[idem]
                if self.spans is not None and trace is not None:
                    self.spans.record(
                        "sdfs.replicate", trace=trace[0], parent=trace[1],
                        t_start=self.spans.clock(),
                        attrs={"name": name, "version": version,
                               "duplicate": True})
                return Message(MessageType.ACK, self.host,
                               {"version": version, "hosts": hosts,
                                "duplicate": True})
            known = name in self._versions
        if not known:
            # fresh-master monotonicity: learn the key's surviving latest
            # version (and newest tombstone) from its ring hosts BEFORE
            # reserving, or a put routed to a just-adopted master would
            # re-issue version numbers the old master already assigned
            self._resolve(name)                  # network probes, no lock
        with self._meta_lock:
            # monotone across delete/re-put so tombstones stay meaningful
            version = max(self._versions.get(name, 0),
                          self.local.tombstones().get(name, 0)) + 1
            self._versions[name] = version       # reserve
        replicas = self._replica_hosts(name)
        rsp = None
        if self.spans is not None and trace is not None:
            rsp = self.spans.start(
                "sdfs.replicate", trace=trace[0], parent=trace[1],
                attrs={"name": name, "version": version,
                       "replicas": len(replicas)})
        base = {"name": name, "version": version, "internal": True,
                "epoch": list(self.membership.epoch.view())}
        stored: set[str] = set()
        for h in replicas:                        # network I/O — no lock held
            if h == self.host:
                self.local.write(name, version, blob)
                stored.add(h)
                continue
            psp = None
            pl = dict(base)
            if rsp is not None:
                # one child span per replica push: the fan-out is visible
                # host-by-host, a dead replica shows as an error span —
                # and the child's ctx rides the payload beside the epoch
                # stamp so the replica can continue the trace
                psp = self.spans.start("sdfs.push", trace=rsp.trace_id,
                                       parent=rsp.span_id,
                                       attrs={"name": name, "to": h})
                stamp_trace(pl, (rsp.trace_id, psp.span_id))
            push = Message(MessageType.PUT, self.host, pl, blob=blob)
            try:
                out = self.transport.call(h, SERVICE, push, timeout=30.0)
            except TransportError:
                if psp is not None:
                    self.spans.finish(psp, error="TransportError")
                continue
            if psp is not None:
                self.spans.finish(psp)
            if reply_is_stale(self.membership.epoch, out):
                # a replica fenced us mid-push: we are deposed — abort
                # rather than keep spraying a dead epoch's write
                if rsp is not None:
                    self.spans.finish(rsp, error="stale_epoch")
                return self._err("deposed mid-put (stale epoch)")
            if out is not None:
                stored.add(h)
        if rsp is not None:
            self.spans.finish(rsp, stored=len(stored))
        if not stored:
            return self._err("no replica stored")
        with self._meta_lock:
            self._locations.setdefault(name, set()).update(stored)
            if idem is not None:
                if len(self._put_idem) >= 4096:   # bound the dedupe map
                    for k in list(self._put_idem)[:1024]:
                        del self._put_idem[k]
                self._put_idem[idem] = (version, sorted(stored))
        return Message(MessageType.ACK, self.host,
                       {"version": version, "hosts": sorted(stored)})

    def _fetch_version(self, name: str, version: int,
                       holders: set[str]) -> bytes | None:
        blob = self.local.read(name, version)
        if blob is not None:
            return blob
        req = Message(MessageType.GET, self.host,
                      {"name": name, "version": version, "internal": True,
                       "epoch": list(self.membership.epoch.view())})
        for h in sorted(holders):
            if h == self.host:
                continue
            try:
                out = self.transport.call(h, SERVICE, req, timeout=30.0)
                if out is not None and out.type is MessageType.ACK:
                    return out.blob
            except TransportError:
                continue
        return None

    def _snapshot(self, name: str) -> tuple[int, set[str]] | None:
        with self._meta_lock:
            if name not in self._versions:
                return None
            return self._versions[name], set(self._locations.get(name, set()))

    def _snapshot_or_resolve(self, name: str) -> tuple[int, set[str]] | None:
        """Master-side metadata lookup with lazy per-key resolution on a
        miss — the failover-time replacement for the full inventory
        rebuild (a fresh master's first touch of each key probes only that
        key's ring hosts)."""
        snap = self._snapshot(name)
        if snap is not None:
            return snap
        self._resolve(name)                      # network probes, no lock
        return self._snapshot(name)

    def _resolve(self, name: str) -> None:
        """Lazy per-key metadata resolution: probe THIS key's ring hosts
        (plus the coordinator chain, which holds the legacy master bonus
        replica) for their local versions and newest tombstone, then
        max-merge into master metadata. A key whose newest surviving
        version is at or below the newest tombstone stays dead — delete
        semantics survive failover without any cluster-wide sweep — and
        the tombstone is adopted locally so a later re-put reserves past
        it. Delegates to the batched `_resolve_many`."""
        self._resolve_many([name])

    def _resolve_many(self, names: list[str]) -> None:
        """Batched resolution: ONE internal STAT
        round-trip per distinct target host covering every name whose
        ring window lands there, instead of a per-name probe fan-out.
        Each name merges exactly as the per-key `_resolve` contract
        states — max surviving version, newest tombstone, holders only
        for hosts that actually hold the name."""
        names = list(dict.fromkeys(names))
        if not names:
            return
        alive = set(self.membership.members.alive_hosts())
        per_name: dict[str, list[str]] = {}
        host_names: dict[str, list[str]] = {}
        for name in names:
            targets = [h for h in ring_order(name, self.config.hosts)
                       if h in alive][:self.config.replication_factor + 2]
            for h in (self.config.coordinator,
                      self.config.standby_coordinator, self.host):
                if (h in alive or h == self.host) and h not in targets:
                    targets.append(h)
            per_name[name] = targets
            for h in targets:
                host_names.setdefault(h, []).append(name)
        stats: dict[str, dict] = {}
        for h, ns in host_names.items():
            if h == self.host:
                files, tombs = self.local.files(), self.local.tombstones()
                stats[h] = {n: {"versions": files.get(n, []),
                                "tombstone": tombs.get(n, 0)} for n in ns}
                continue
            req = Message(MessageType.STAT, self.host,
                          {"names": list(ns), "internal": True,
                           "epoch": list(self.membership.epoch.view())})
            try:
                out = self.transport.call(h, SERVICE, req, timeout=10.0)
            except TransportError:
                continue
            if out is None or out.type is not MessageType.ACK:
                continue
            stats[h] = out.payload.get("stats", {})
        for name in names:
            latest, tomb = 0, self.local.tombstones().get(name, 0)
            holders: set[str] = set()
            for h in per_name[name]:
                st = stats.get(h, {}).get(name)
                if st is None:
                    continue
                tomb = max(tomb, int(st.get("tombstone", 0)))
                vs = st.get("versions", [])
                if vs:
                    latest = max(latest, max(int(v) for v in vs))
                    holders.add(h)
            if latest <= tomb:
                if tomb > self.local.tombstones().get(name, 0):
                    # adopt the newest tombstone so version numbers stay
                    # monotone when this master re-puts the deleted name
                    self.local.delete(name, tomb)
                continue
            with self._meta_lock:
                self._versions[name] = max(self._versions.get(name, 0),
                                           latest)
                self._locations.setdefault(name, set()).update(holders)

    def _master_get(self, name: str, want: int | None = None,
                    trace: tuple | None = None) -> Message:
        snap = self._snapshot_or_resolve(name)
        if snap is None:
            return self._err("file not found")   # FILE_NOT_EXIST (`:443-448`)
        version, holders = snap
        if want is not None:
            if not 1 <= want <= version:
                return self._err(f"version {want} out of range 1..{version}")
            version = want
        fsp = None
        if self.spans is not None and trace is not None:
            fsp = self.spans.start(
                "sdfs.fetch", trace=trace[0], parent=trace[1],
                attrs={"name": name, "version": version,
                       "holders": len(holders)})
        blob = self._fetch_version(name, version, holders)
        if blob is None:
            # the holder view may predate a ring repair (repairing holders
            # don't report to the master) — re-probe this key's ring
            # hosts once and retry the fetch against the fresh set
            self._resolve(name)
            snap = self._snapshot(name)
            if snap is not None:
                blob = self._fetch_version(name, version, snap[1])
        if fsp is not None:
            self.spans.finish(fsp, found=blob is not None)
        if blob is None:
            return self._err("no holder reachable")
        return Message(MessageType.ACK, self.host, {"version": version},
                       blob=blob)

    def _master_get_versions(self, name: str, k: int) -> Message:
        snap = self._snapshot_or_resolve(name)
        if snap is None:
            return self._err("file not found")
        latest, holders = snap
        parts, included = [], []
        for v in range(latest, max(latest - k, 0), -1):
            blob = self._fetch_version(name, v, holders)
            if blob is None:
                continue
            parts.append(VERSION_DELIM % v + blob + b"\n")
            included.append(v)
        return Message(MessageType.ACK, self.host, {"versions": included},
                       blob=b"".join(parts))

    def _master_delete(self, name: str) -> Message:
        snap = self._snapshot_or_resolve(name)
        if snap is None:
            return self._err("file not found")
        version, _ = snap
        # tombstone + remove on EVERY alive host (not just known holders) so
        # stale replicas can't resurrect the file at metadata rebuild.
        req = Message(MessageType.DELETE, self.host,
                      {"name": name, "version": version, "internal": True,
                       "epoch": list(self.membership.epoch.view())})
        self.local.delete(name, version)
        for h in self.membership.members.alive_hosts():
            if h == self.host:
                continue
            try:
                self.transport.call(h, SERVICE, req, timeout=30.0)
            except TransportError:
                continue
        with self._meta_lock:
            self._versions.pop(name, None)
            self._locations.pop(name, None)
        return Message(MessageType.ACK, self.host)

    # ------------------------------------------------------------------ #
    # failure handling: ring-native re-replication
    # ------------------------------------------------------------------ #

    def _on_member_change(self, host: str, old: MemberStatus | None,
                          new: MemberStatus) -> None:
        if new is not MemberStatus.LEAVE:
            return
        # master metadata catch-up is synchronous and cheap (no I/O):
        # just forget the dead holder — a fresh master resolves each
        # key lazily instead of rebuilding, so failover never blocks
        # on a cluster-wide inventory sweep
        if self.membership.is_acting_master:
            with self._meta_lock:
                for hs in self._locations.values():
                    hs.discard(host)

        # repair OFF the monitor loop: re-replication streams whole files
        # (30 s timeouts per copy) — failure detection for other hosts
        # must not stall behind it (same discipline as lm_manager/
        # inference_service member-change handling). Repairs for
        # successive deaths serialize on _repair_serial. Unlike the
        # master-driven reference (`mp4_machinelearning.py:852-874`),
        # the ring repair runs on EVERY node over its own replicas.
        def _repair() -> None:
            with self._repair_serial:
                self._ring_repair(host)

        th = threading.Thread(target=_repair, daemon=True,
                              name=f"{self.host}-sdfs-repair")
        # start before recording: joining an unstarted thread raises
        th.start()
        with self._meta_lock:
            self._repair_threads = [t for t in self._repair_threads
                                    if t.is_alive()] + [th]

    def _ring_repair(self, dead: str) -> None:
        """Successor-driven re-replication, per key, over THIS host's own
        replicas. For each live local key whose ring replica set (first
        ``replication_factor`` in ring order over the pre-death view)
        contained the dead host, push every locally-held version to the
        ring successors that joined the post-death set. No master
        metadata is read and none is rebuilt — repair completes even
        through a simultaneous coordinator failover, and the master
        learns the new holders lazily via ``_resolve``. Every surviving
        holder drives its own copy of the key (pushes are epoch-stamped
        internal PUTs of immutable versions, so concurrent pushers
        converge on identical bytes instead of conflicting)."""
        alive_set = {h for h in self.membership.members.alive_hosts()
                     if h != dead}
        if not alive_set:
            return
        rf = self.config.replication_factor
        tombs = self.local.tombstones()
        for name, versions in sorted(self.local.files().items()):
            if not versions or max(versions) <= tombs.get(name, 0):
                continue                          # tombstoned — stay dead
            ordered = ring_order(name, self.config.hosts)
            old_set = [h for h in ordered
                       if h in alive_set or h == dead][:rf]
            if dead not in old_set:
                continue                # this key lost no ring replica
            new_set = [h for h in ordered if h in alive_set][:rf]
            targets = [h for h in new_set
                       if h not in old_set and h != self.host]
            pushed = [t for t in targets
                      if self._push_versions(name, versions, t)]
            if pushed and self.membership.is_acting_master:
                with self._meta_lock:
                    if name in self._locations:
                        self._locations[name].update(pushed)

    def _push_versions(self, name: str, versions: list[int],
                       target: str) -> bool:
        """Stream this host's local versions of ``name`` to ``target``
        (ring-repair data path); True if at least one version landed."""
        pushed = False
        for v in versions:
            blob = self.local.read(name, v)
            if blob is None:
                continue
            push = Message(MessageType.PUT, self.host,
                           {"name": name, "version": int(v),
                            "internal": True,
                            "epoch": list(self.membership.epoch.view())},
                           blob=blob)
            try:
                out = self.transport.call(target, SERVICE, push,
                                          timeout=30.0)
            except TransportError:
                return pushed
            if out is not None and out.type is MessageType.ACK:
                pushed = True
        return pushed

    def join_repair(self, timeout: float = 10.0) -> None:
        """Wait for in-flight death-event repairs (they run on background
        threads so file streaming can't stall the membership monitor
        loop). Deterministic tests call this after `monitor_once`."""
        import time as _time
        with self._meta_lock:
            threads = list(self._repair_threads)
        deadline = _time.monotonic() + timeout
        for th in threads:
            th.join(timeout=max(0.0, deadline - _time.monotonic()))

    def rebuild_metadata(self) -> None:
        """Full inventory sweep: reconstruct versions/locations by querying
        every alive host's inventory + tombstones. A file is live iff some
        replica's max version exceeds the newest tombstone. NO LONGER runs
        on failover (ring repair + lazy ``_resolve`` replaced it — tests
        pin ``rebuilds`` at 0 across a master takeover); kept as a
        diagnostic/administrative surface."""
        self.rebuilds += 1
        req = Message(MessageType.STORE, self.host,
                      {"internal": True,
                       "epoch": list(self.membership.epoch.view())})
        inventories: dict[str, dict[str, list[int]]] = {
            self.host: self.local.files()}
        tombs: dict[str, int] = dict(self.local.tombstones())
        for h in self.membership.members.alive_hosts():
            if h == self.host:
                continue
            try:
                out = self.transport.call(h, SERVICE, req, timeout=10.0)
            except TransportError:
                continue
            if out is None:
                continue
            inventories[h] = out.payload["files"]
            for n, v in out.payload.get("tombstones", {}).items():
                tombs[n] = max(tombs.get(n, 0), int(v))
        versions: dict[str, int] = {}
        locations: dict[str, set[str]] = {}
        for h, files in inventories.items():
            for n, vs in files.items():
                if not vs:
                    continue
                top = max(vs)
                if top <= tombs.get(n, 0):
                    continue                      # deleted — stay dead
                versions[n] = max(versions.get(n, 0), top)
                locations.setdefault(n, set()).add(h)
        with self._meta_lock:
            for n, v in versions.items():
                self._versions[n] = max(self._versions.get(n, 0), v)
                self._locations.setdefault(n, set()).update(locations[n])

