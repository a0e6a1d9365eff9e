"""Seeded chaos harness: deterministic fault schedules over a full
in-process cluster, with global safety invariants checked continuously.

FoundationDB-style simulation testing (Zhou et al., SIGMOD 2021): one
``random.Random(seed)`` drives BOTH the fault schedule (partitions,
one-way cuts, probabilistic drop/dup/delay, kills) and the workload (CNN
queries, managed LM submits, SDFS puts), so any failing schedule replays
exactly from its seed. The reference has nothing like this — its failover
was only ever exercised by hand-killing VMs (SURVEY.md §4), and its
fencing-free design (`mp4_machinelearning.py:956-963`) cannot pass these
invariants at all.

Invariants (``ChaosCluster.check_invariants`` after ``converge``):
- at most one acting master per epoch, ever (fence owners are recorded at
  every step; two owners for one epoch number = split brain);
- at most one owner per POOL-SCOPE epoch (per-pool fences are
  sampled from every host's scope registry exactly like the cluster
  fence — two owners for one (scope, epoch) = per-pool split brain);
- at most one ownership CLAIMANT per (scope, claim seq) across every
  host's gossiped map, the first claim on each scope lands exactly on
  its rendezvous placement, and with a second pool the owners spread
  over more than one host (multi-owner control plane);
- zero stale-epoch messages ACCEPTED anywhere (a transport-level probe
  snapshots each receiver's fence before the handler runs: a stamped
  payload below that high-water mark must produce an ERROR, never an
  ACK) — and the same for scoped stamps below a scope's high-water;
- every CNN query acked by the surviving master lineage completes exactly
  once — result set exact, no duplicate records;
- every LM request admitted into the surviving journal reaches exactly one
  terminal state, no completion is delivered twice, and every completion
  surfaces from the POOL it was submitted to (cross-pool isolation: a
  deposed pool-A owner must never leak or lose pool-B work);
- every SDFS put acked by the surviving lineage reads back exactly, and
  each surviving version keeps >= min(replication_factor, holders-at-ack)
  alive holders (ring re-replication restored what a death took);
- membership views converge after heal.

The LM node tier is a deterministic stand-in (`ChaosControl`): tokens are
a pure function of (prompt, seed), so replay token-exactness is checkable
without a model — the real tier's epoch fencing and lm_submit idempotency
semantics are mirrored verb-for-verb from `serve/control.py`.

The port's `serve/control.py` is not a copy: its verbs run the port's
engines on the node's device (``generate``, ``lm_serve``, the prefix and
handoff verbs, ``train_start``, ``profile``). None of that reaches what
`ChaosControl` mirrors — the epoch and scope fences, owner routing with
its one-hop forward, ``lm_submit`` idempotency, the lm_serve spec
(``n_model`` included) and the pool verbs' replies — which the port keeps
as the JAX package has them, so this harness is the JAX package's.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import time
from types import SimpleNamespace

from idunno_tpu_torch.comm.inproc import InProcNetwork
from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.retry import call_with_retry
from idunno_tpu_torch.comm.transport import TransportError
from idunno_tpu_torch.config import ClusterConfig
from idunno_tpu_torch.membership.epoch import (check_payload, check_scoped,
                                         observe_payload, place_scope,
                                         pool_scope)
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.scheduler.fair import FairScheduler
# the typed owner-hop relay is SHARED with the real control plane: one
# class, so the sim and the product can never drift on which
# markers survive a forwarded hop
from idunno_tpu_torch.serve.control import RelayedError as _RelayedError
from idunno_tpu_torch.serve.failover import FailoverManager
from idunno_tpu_torch.serve.inference_service import (InferenceService,
                                                InferenceServiceError)
from idunno_tpu_torch.serve.lm_manager import LMPoolManager
from idunno_tpu_torch.serve.metrics import MetricsTracker
from idunno_tpu_torch.store.sdfs import FileStoreService, StoreError
from idunno_tpu_torch.utils.spans import SpanStore, trace_from_payload
from idunno_tpu_torch.utils.types import MessageType

# services whose handlers are epoch-fenced; the membership service is
# deliberately NOT probed — its gossip must accept any epoch stamp (that
# is how a deposed coordinator learns it was deposed)
PROBED_SERVICES = ("inference", "control", "store", "metadata")


class ChaosClock:
    """Fake wall clock shared by every node (tests/test_membership.py
    idiom) so suspicion timeouts are schedule-driven, not real-time."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class ChaosEngine:
    """Deterministic CNN engine stand-in: 10 ms/image, name-derived
    records (same contract as the serving tests' FakeEngine)."""

    def __init__(self, host: str, clock: ChaosClock) -> None:
        self.host = host
        self.clock = clock

    def infer(self, name, start, end, dataset_root=None):
        n = end - start + 1
        self.clock.advance(0.01 * n)
        return SimpleNamespace(
            records=[(f"test_{i}.JPEG", f"class_{(i * 7) % 1000}", 0.9)
                     for i in range(start, end + 1)],
            elapsed_s=0.01 * n,
            weights="pretrained")


def lm_tokens(prompt: list[int], seed: int, max_new: int) -> list[int]:
    """The fake decode function: pure in (prompt, seed), so a journaled
    replay with the pinned seed is token-exact by construction."""
    base = sum(prompt) % 50257
    return list(prompt) + [(seed * 1000003 + i * 7919 + base) % 50257
                           for i in range(max_new)]


def chunk_content(chunk: list[int]) -> dict:
    """Deterministic stand-in for one KV block's leaf arrays: a pure
    function of the chunk tokens, so two replicas publishing the same
    prefix produce byte-identical blobs (the content-address dedupe
    property the real pool gets from causal attention) and every fetched
    blob is CHECKABLE against its tokens — a mismatch is a wrong-token
    graft, recorded as an invariant violation."""
    import numpy as np
    return {"kv": np.asarray([(t * 31 + 7) % 997 for t in chunk],
                             np.int64)}




class ChaosControl:
    """Per-host control-verb handler: cluster routing + a fake node-local
    LM tier, mirroring `serve/control.py` (epoch fence at the top,
    owner-aware routing of pool verbs with a one-hop forward, the
    deposed-holder ``scope_owner`` redirect, per-name lm_submit
    idempotency purged on rebuild/stop)."""

    _POOL_VERBS = ("lm_submit", "lm_poll", "lm_stats", "lm_qos",
                   "lm_autoscale", "prefix_publish", "prefix_probe",
                   "prefix_fetch", "kv_handoff")

    def __init__(self, host: str, membership: MembershipService,
                 lm_manager: LMPoolManager, store=None,
                 violations: list | None = None) -> None:
        self.host = host
        self.membership = membership
        self.mgr = lm_manager
        # this host's FileStoreService + the cluster violation ledger:
        # the fake LM tier runs the REAL ClusterPrefixCache against the
        # real SDFS ring, checking fetched content inline
        self.store = store
        self.violations = violations if violations is not None else []
        self._loops: dict = {}     # name -> {"next", "done"}
        self._lm_idem: dict = {}   # (name, key) -> node-local row id

    def handle(self, service: str, msg: Message) -> Message:
        stale = check_payload(self.membership.epoch, msg.payload, self.host)
        if stale is not None:
            return stale
        # per-pool fence mirror (serve/control.py): a verb stamped by a
        # deposed POOL owner is rejected for that scope only
        stale = check_scoped(self.membership.scopes, msg.payload, self.host)
        if stale is not None:
            return stale
        try:
            out = self._dispatch(msg.payload.get("verb", ""), msg.payload)
            return Message(MessageType.ACK, self.host, out)
        except _RelayedError as e:
            return Message(MessageType.ERROR, self.host, e.payload)
        except Exception as e:  # noqa: BLE001 - RPC boundary
            return Message(MessageType.ERROR, self.host,
                           {"error": f"{type(e).__name__}: {e}"})

    def _forward_owner(self, p: dict, name: str) -> dict | None:
        """Owner-aware one-hop forward, mirroring
        serve/control.py:_forward_scope_owner — the claimed owner is
        trusted ahead of the local liveness view, ``_owner_hop`` guards
        against loops, and ERROR replies relay verbatim. None = no
        forwardable owner, fall through to the node-local tier."""
        if p.get("_owner_hop"):
            return None
        scope = pool_scope(name)
        owner = self.membership.owners.owner(scope)
        if owner is None or owner == self.host:
            alive = set(self.membership.members.alive_hosts())
            # quarantine-blind on purpose: this guess must match the
            # adoption formula (failover._adopt_scopes_of), not the
            # assignment-time view — see the note there
            owner = place_scope(scope, self.membership.config.hosts, alive)
        if owner is None or owner == self.host:
            return None
        self.mgr.service.metrics.record_counter("scope_owner_redirects")
        fwd = dict(p, _owner_hop=True,
                   epoch=list(self.membership.epoch.view()))
        try:
            out = self.mgr.transport.call(
                owner, "control",
                Message(MessageType.INFERENCE, self.host, fwd),
                timeout=0.5)
        except TransportError as e:
            raise ValueError(f"scope owner {owner} for {name!r} "
                             f"unreachable: {e}") from e
        if out is None:
            raise ValueError(
                f"scope owner {owner} for {name!r} gave no reply")
        observe_payload(self.membership.epoch, out.payload)
        if out.type is MessageType.ERROR:
            raise _RelayedError(dict(out.payload or {}))
        return dict(out.payload or {})

    def _dispatch(self, verb: str, p: dict) -> dict:
        mgr = self.mgr
        if mgr is not None and not p.get("local"):
            if verb == "lm_serve" and p.get("placement") == "assign":
                # owner landing of a master handoff (pool_assign): serve
                # here, no re-forward — a replay absorbs as already=True
                return mgr.serve(p, assigned=True)
            if p.get("placement") == "auto" and verb == "lm_serve":
                if not self.membership.is_acting_master:
                    raise ValueError("placement=auto must go to the "
                                     "acting master")
                return mgr.serve(p)
            name = p.get("name")
            if verb in self._POOL_VERBS and not mgr.has_pool(name):
                out = self._forward_owner(p, name)
                if out is not None:
                    return out
            if verb in self._POOL_VERBS and mgr.has_pool(name):
                claimed = self.membership.owners.owner(pool_scope(name))
                if claimed is None:
                    # unclaimed scope: the pre-ownership rule — only the
                    # acting master serves a managed journal
                    if not self.membership.is_acting_master:
                        raise ValueError(f"{self.host} is not the acting "
                                         f"master; journal fenced")
                elif claimed != self.host:
                    # deposed holder: adopter out-claimed this scope —
                    # step down for it only, typed redirect to the owner
                    mgr.step_down_scope(pool_scope(name))
                    self.mgr.service.metrics.record_counter(
                        "scope_owner_redirects")
                    raise _RelayedError({
                        "error": f"scope {pool_scope(name)} is owned by "
                                 f"{claimed}; redirect",
                        "scope": pool_scope(name),
                        "scope_owner": claimed})
                if verb == "lm_submit":
                    rid = mgr.submit(
                        name, [int(t) for t in p["prompt"]],
                        int(p["max_new"]),
                        seed=(int(p["seed"])
                              if p.get("seed") is not None else None),
                        tenant=str(p.get("tenant", "default")),
                        idem_key=p.get("idem"),
                        trace=trace_from_payload(p))
                    return {"id": rid}
                if verb == "lm_poll":
                    return mgr.poll(name)
                if verb == "lm_qos":
                    return mgr.qos(name)
                if verb == "lm_autoscale":
                    if p.get("policy"):
                        return mgr.autoscale_set(name, dict(p["policy"]))
                    return mgr.autoscale_get(name)
                if verb in ("prefix_publish", "prefix_probe",
                            "prefix_fetch"):
                    # same relay as serve/control.py:_route_cluster —
                    # prefix state lives on the serving node
                    return mgr.prefix_op(verb, name, p)
                if verb == "kv_handoff":
                    # same relay as serve/control.py:_route_cluster —
                    # block state lives on the serving replicas
                    return mgr.kv_handoff(name, p)
                return {"stats": mgr.stats(name)}
        # -- node-local fake LM tier --
        if verb == "lm_serve":
            name = p["name"]
            if name in self._loops and not p.get("reload"):
                return {"already": True}
            # prefill_chunk rides the spec (journaled, replayed on
            # failover like every serving knob): the fake tier models a
            # chunked admission as completion deferred by one poll round
            # — the watchdog/poll-retry machinery must tolerate a pool
            # that holds work across a poll without losing or duping it
            # n_model rides the spec the same way: the fake tier only
            # records the TP shape (no real mesh), proving the knob
            # journals/replays through failover like every serving knob
            self._loops[name] = {"next": 0, "done": [], "defer": [],
                                 "chunk": int(p.get("prefill_chunk")
                                              or 0),
                                 "n_model": int(p.get("n_model") or 1),
                                 "cp": None,
                                 "bs": int(p.get("kv_block_size") or 0),
                                 "tree": set(),
                                 "remote_hits": 0, "published": 0,
                                 "warmed": 0,
                                 # DistServe handoff gauges
                                 "shipped": 0, "adopted": 0,
                                 "fallbacks": 0}
            if p.get("cluster_prefix") and self.store is not None:
                # the fake tier runs the REAL
                # ClusterPrefixCache against the real SDFS ring; only
                # the KV content is a stand-in (chunk_content). The
                # namespace is the pool BASE name so group replicas and
                # a failover rebuild share the published set.
                from idunno_tpu_torch.serve.cluster_prefix import \
                    ClusterPrefixCache
                bs = int(p.get("kv_block_size") or 2)
                loop = self._loops[name]
                loop["bs"] = bs
                loop["cp"] = ClusterPrefixCache(
                    self.store, str(name).split("@", 1)[0], bs,
                    publish_min_hits=0)
            for k in [k for k in self._lm_idem if k[0] == name]:
                del self._lm_idem[k]
            return {"slots": int(p.get("slots", 4))}
        if verb == "lm_submit":
            name = p["name"]
            if name not in self._loops:
                raise ValueError(f"no lm_serve pool for {name!r}; "
                                 "call lm_serve first")
            key = p.get("idem")
            if key is not None and (name, key) in self._lm_idem:
                return {"id": self._lm_idem[(name, key)],
                        "duplicate": True}
            loop = self._loops[name]
            rid = loop["next"]
            loop["next"] += 1
            prompt = [int(t) for t in p["prompt"]]
            if loop["cp"] is not None:
                self._prefix_admit(name, loop, prompt,
                                   str(p.get("tenant", "default")))
            toks = lm_tokens(prompt, int(p.get("seed") or 0),
                             int(p["max_new"]))
            comp = {"id": rid, "tokens": toks,
                    "prompt_len": len(prompt), "service_s": 0.001}
            # chunked pools admit over multiple steps: completion lands
            # a poll round later (tokens identical — chunking is pure
            # scheduling, the exactness ledger must not notice)
            dest = "defer" if loop["chunk"] and \
                len(prompt) > loop["chunk"] else "done"
            loop[dest].append(comp)
            if key is not None:
                self._lm_idem[(name, key)] = rid
            return {"id": rid}
        if verb == "lm_poll":
            name = p["name"]
            if name not in self._loops:
                raise ValueError(f"no lm_serve pool for {name!r}; "
                                 "call lm_serve first")
            loop = self._loops[name]
            done = loop["done"]
            loop["done"], loop["defer"] = loop["defer"], []
            return {"completions": done}
        if verb == "lm_stop":
            self._loops.pop(p["name"], None)
            for k in [k for k in self._lm_idem if k[0] == p["name"]]:
                del self._lm_idem[k]
            return {"stopped": True}
        if verb == "lm_qos":
            # the fake tier has no gateway; the autoscaler's live-gauge
            # reader treats a qos-less node as n=0 (never scales on it) —
            # chaos schedules drive pressure through the injected
            # gauges_fn instead
            return {"qos": None}
        if verb in ("prefix_publish", "prefix_probe", "prefix_fetch"):
            return self._prefix_verb(verb, p)
        if verb == "kv_handoff":
            return self._handoff_verb(p)
        raise ValueError(f"unknown control verb {verb!r}")

    # -- fake-tier cluster prefix cache -------------------------

    @staticmethod
    def _chunks(toks: list[int], bs: int) -> list[tuple[int, ...]]:
        return [tuple(toks[j * bs:(j + 1) * bs])
                for j in range(len(toks) // bs)]

    @staticmethod
    def _tree_depth(tree: set, chunks: list, cap: int) -> int:
        d = 0
        while d < cap and tuple(chunks[:d + 1]) in tree:
            d += 1
        return d

    def _fetch_into(self, name: str, loop: dict, toks: list[int],
                    local: int, depth: int) -> int:
        """Fetch depths [local, depth) through the REAL cache, verify
        each blob's content against the pure ``chunk_content`` of its
        chunk (a mismatch is a wrong-token graft — invariant violation),
        and insert contiguously into the fake radix tree. Returns blocks
        grafted. A store failure mid-fetch just ends the graft early —
        degradation is legal, corruption is not."""
        import numpy as np
        cp, bs, tree = loop["cp"], loop["bs"], loop["tree"]
        chunks = self._chunks(toks, bs)
        got = 0
        for i, (chunk, arrays) in enumerate(cp.fetch(toks, local, depth)):
            if tuple(chunk) != chunks[local + i]:
                self.violations.append(
                    f"{self.host}/{name}: fetched chunk at depth "
                    f"{local + i} mismatches the prompt (double-prefill "
                    f"hazard): {chunk}")
                return got
            want = chunk_content(list(chunk))["kv"]
            if not np.array_equal(np.asarray(arrays.get("kv")), want):
                self.violations.append(
                    f"{self.host}/{name}: wrong-token KV content fetched "
                    f"at depth {local + i} for chunk {chunk}")
                return got
            tree.add(tuple(chunks[:local + i + 1]))
            got += 1
        return got

    def _prefix_admit(self, name: str, loop: dict, prompt: list[int],
                      tenant: str = "default") -> None:
        """Model the admission-path flow over the REAL subsystem: local
        radix depth from the fake tree, ring probe + suffix-only fetch,
        inline content checks, then insert + publish. Mirrors
        engine/serve_lm.py:_admit/_finish_admission."""
        cp, bs, tree = loop["cp"], loop["bs"], loop["tree"]
        if len(prompt) <= bs:
            return
        # admission caps the hit so >= 1 token always prefills
        want = (len(prompt) - 1) // bs
        chunks = self._chunks(prompt, bs)
        local = self._tree_depth(tree, chunks, want)
        hit = local
        if local < want:
            depth = cp.probe(prompt[:want * bs], start_depth=local)
            if depth > local:
                got = self._fetch_into(name, loop, prompt[:want * bs],
                                       local, depth)
                if got:
                    hit = local + got
                    loop["remote_hits"] += 1
                    cp.remote_hits += 1
        if hit > want or len(prompt) - hit * bs < 1:
            self.violations.append(
                f"{self.host}/{name}: admission covered {hit} blocks of "
                f"a {len(prompt)}-token prompt (no tokens left to "
                f"prefill)")
            return
        for d in range(1, want + 1):
            tree.add(tuple(chunks[:d]))
        out = cp.publish(
            [t for c in chunks[:want] for t in c], want,
            lambda j: chunk_content(list(chunks[j])), tenant=tenant)
        loop["published"] += out["published"]

    def _prefix_verb(self, verb: str, p: dict) -> dict:
        """Node-local handlers mirroring serve/lm_pool.py:_fulfill_prefix
        over the fake tier's tree + the real ClusterPrefixCache."""
        name = p["name"]
        loop = self._loops.get(name)
        if loop is None:
            raise ValueError(f"no lm_serve pool for {name!r}; "
                             "call lm_serve first")
        cp, bs, tree = loop["cp"], loop["bs"], loop["tree"]
        if cp is None:
            raise ValueError(f"pool {name!r} has no cluster prefix "
                             "cache (serve with cluster_prefix=...)")
        if verb == "prefix_probe":
            toks = [int(t) for t in p.get("tokens") or []]
            chunks = self._chunks(toks, bs)
            local = self._tree_depth(tree, chunks, len(chunks))
            return {"local_blocks": local,
                    "remote_blocks": cp.probe(toks),
                    "namespace": cp.namespace, "block_size": bs}
        if verb == "prefix_publish":
            targets = []
            if p.get("tokens") is not None:
                targets.append([int(t) for t in p["tokens"]])
            else:
                # every maximal chain in the tree (no extension present)
                for path in sorted(tree):
                    if not any(len(o) > len(path) and
                               o[:len(path)] == path for o in tree):
                        targets.append([t for c in path for t in c])
            published = 0
            for toks in targets:
                chunks = self._chunks(toks, bs)
                out = cp.publish(
                    toks, len(chunks),
                    lambda j, c=chunks: chunk_content(list(c[j])),
                    force=True)
                published += out["published"]
            loop["published"] += published
            return {"published_blocks": published,
                    "chains": len(targets)}
        # prefix_fetch: warm explicit tokens or a tenant's published set
        targets = []
        if p.get("tokens") is not None:
            targets.append([int(t) for t in p["tokens"]])
        elif p.get("tenant") is not None:
            targets = [[int(t) for t in e.get("tokens", [])]
                       for e in cp.tenant_entries(str(p["tenant"]))]
        fetched = 0
        for toks in targets:
            chunks = self._chunks(toks, bs)
            local = self._tree_depth(tree, chunks, len(chunks))
            if local >= len(chunks):
                continue
            depth = cp.probe(toks, start_depth=local)
            if depth > local:
                fetched += self._fetch_into(name, loop, toks, local,
                                            depth)
        cp.warm_blocks += fetched
        loop["warmed"] += fetched
        return {"fetched_blocks": fetched, "targets": len(targets)}

    # -- fake-tier DistServe KV handoff -------------------------

    def _handoff_verb(self, p: dict) -> dict:
        """Node-local handlers mirroring serve/control.py:_kv_handoff
        over the fake tier's radix tree, with the REAL KVC1 wire codec
        (store/kv_chain.py): a ship encodes the prefill replica's blocks,
        pushes them point-to-point to the decode node, and the adopt side
        decodes with ``expect_tokens`` + checks content against the pure
        ``chunk_content`` — a mismatch is a wrong-token graft, recorded
        as an invariant violation exactly like the prefix-cache path."""
        import numpy as np

        from idunno_tpu_torch.store.kv_chain import decode_block, encode_block
        name = p["name"]
        loop = self._loops.get(name)
        if loop is None:
            raise ValueError(f"no lm_serve pool for {name!r}; "
                             "call lm_serve first")
        bs = int(loop.get("bs") or 0)
        if bs <= 0:
            raise ValueError(f"pool {name!r} has no KV block tier "
                             "(serve with kv_block_size > 0)")
        op = p.get("op")
        toks = [int(t) for t in p.get("tokens") or []]
        chunks = self._chunks(toks, bs)
        # admission cap mirror: >= 1 token must remain to prefill
        want = max(0, (len(toks) - 1) // bs)
        tree = loop["tree"]
        if op == "probe":
            return {"depth": self._tree_depth(tree, chunks, want),
                    "want": want, "block_size": bs}
        if op == "adopt":
            start = int(p.get("start_depth") or 0)
            wrote = 0
            nbytes = 0
            for j, blob_s in enumerate(p.get("blobs") or []):
                d = start + j
                blob = blob_s.encode("latin-1")
                nbytes += len(blob)
                _, arrays = decode_block(blob,
                                         expect_tokens=list(chunks[d]))
                wantkv = chunk_content(list(chunks[d]))["kv"]
                if not np.array_equal(np.asarray(arrays.get("kv")),
                                      wantkv):
                    self.violations.append(
                        f"{self.host}/{name}: wrong-token KV content "
                        f"adopted at depth {d} for chunk {chunks[d]} "
                        f"(handoff corruption)")
                    raise ValueError("handoff blob content mismatch")
                tree.add(tuple(chunks[:d + 1]))
                wrote += 1
            loop["adopted"] += wrote
            return {"adopted": wrote, "wrote": wrote,
                    "depth": start + wrote, "bytes": nbytes}
        if op == "ship":
            target_host = p["target_host"]
            target_name = p["target_name"]
            # model the prefill leg: this replica fills its own blocks
            for d in range(1, want + 1):
                tree.add(tuple(chunks[:d]))

            def rcall(fwd: dict) -> dict:
                out = self.mgr.transport.call(
                    target_host, "control",
                    Message(MessageType.INFERENCE, self.host,
                            dict(fwd, local=True,
                                 epoch=list(self.membership.epoch
                                            .view()))),
                    timeout=0.5)
                if out is None:
                    raise TransportError(
                        f"kv_handoff: {target_host} gave no reply",
                        reason="timeout")
                observe_payload(self.membership.epoch, out.payload)
                if out.type is MessageType.ERROR:
                    raise ValueError(
                        str((out.payload or {}).get("error", "")))
                return dict(out.payload or {})

            probe = rcall({"verb": "kv_handoff", "op": "probe",
                           "name": target_name, "tokens": toks})
            depth = int(probe.get("depth") or 0)
            if depth >= want:
                # delta-only ship: the decode replica already holds the
                # full chain (a replayed ship after a lost ACK)
                return {"shipped": 0, "bytes": 0, "depth": depth,
                        "already": True}
            blobs = []
            for d in range(depth, want):
                blob = encode_block(
                    {"tokens": list(chunks[d]), "depth": d,
                     "block_size": bs},
                    chunk_content(list(chunks[d])))
                blobs.append(blob.decode("latin-1"))
            out = rcall({"verb": "kv_handoff", "op": "adopt",
                         "name": target_name, "tokens": toks,
                         "blobs": blobs, "start_depth": depth})
            loop["shipped"] += int(out.get("wrote") or 0)
            return {"shipped": int(out.get("wrote") or 0),
                    "bytes": int(out.get("bytes") or 0),
                    "depth": int(out.get("depth") or 0)}
        if op == "fallback":
            loop["fallbacks"] += 1
            return {"fallback": True}
        raise ValueError(f"unknown kv_handoff op {op!r}")


class ChaosCluster:
    """A 5-host in-process cluster (coordinator n0, standby n1) with every
    control-plane layer wired the way `serve/node.py` wires it, a seeded
    fault/workload schedule, and invariant recording."""

    LM_POOL = "chaos-lm"
    LM_POOL_B = "chaos-lmB"
    LM_GROUP = "chaos-grp"
    LM_GROUP_D = "chaos-dsg"

    def __init__(self, seed: int, data_dir: str, n_hosts: int = 5,
                 prefill_chunk: int = 0, n_model: int = 1,
                 autoscale: bool = False, multi_pool: bool = False,
                 cluster_prefix: bool = False,
                 distserve: bool = False,
                 fail_slow: bool = False) -> None:
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        self.n_model = n_model
        # gate ALL group workload behind the flag: the group ops draw
        # extra rng, which would shift every existing seed's schedule
        self.autoscale = autoscale
        # a second concurrent managed pool, flag-gated for the
        # same reason — its submissions draw extra rng in step()
        self.multi_pool = multi_pool
        # cluster prefix cache over the SDFS ring — flag-gated
        # for the same reason (prefix submissions draw extra rng, and the
        # real store traffic the cache generates draws chaos rng)
        self.cluster_prefix = cluster_prefix
        # a role-split replica group (prefill + decode) with a
        # KV block pool, so long-prompt submissions route in DistServe
        # handoff mode (manager ships real KVC1 blobs between the fake
        # loops) — flag-gated: submissions AND ship RPCs draw chaos rng
        self.distserve = distserve
        # gray-failure schedule — flag-gated because attaching
        # the health ledger to the transports, the victim rng draw, and
        # the per-step latency-sampling sweep all consume rng / send
        # extra datagrams, which would shift every existing seed
        self.fail_slow = fail_slow
        self.slow_victim: str | None = None
        self.slow_prober: str | None = None
        self.saw_quarantine = False
        # per-host consecutive steps the victim was missing from that
        # host's alive view while both ends' links were clean
        self._leave_streak: dict[str, int] = {}
        # created before the host loop: the controls hold a reference so
        # the fake tier's inline content checks (wrong-token graft,
        # double-prefill) land in the same invariant ledger
        self.violations: list[str] = []
        # synthetic interactive-p95 the injected gauges_fn reports for
        # group replicas; schedules script overload/underload through it
        self.group_pressure = 0.0
        self._steps_run = 0
        # overload for the first chunk of a seeded schedule, then idle:
        # one run crosses the scale-out threshold AND the scale-in one
        self.overload_steps = 24
        self.rng = random.Random(seed)
        self.cfg = ClusterConfig(
            hosts=tuple(f"n{i}" for i in range(n_hosts)),
            coordinator="n0", standby_coordinator="n1", introducer="n0",
            query_batch_size=100, query_interval_s=0.0,
            straggler_timeout_s=4.0, rpc_retry_deadline_s=0.5)
        self.net = InProcNetwork(seed=seed)
        self.clock = ChaosClock()
        if fail_slow:
            # victim off the coordinator chain (the limp is a worker-side
            # gray failure; deposing masters is the kill schedules' job);
            # the prober is a fixed second host whose ledger derives the
            # verdict and gossips it
            self.slow_victim = self.rng.choice(self.cfg.hosts[2:])
            self.slow_prober = ("n3" if self.slow_victim == "n2"
                                else "n2")
        self.members: dict[str, MembershipService] = {}
        self.services: dict[str, InferenceService] = {}
        self.stores: dict[str, FileStoreService] = {}
        self.failovers: dict[str, FailoverManager] = {}
        self.managers: dict[str, LMPoolManager] = {}
        self.controls: dict[str, ChaosControl] = {}
        # per-host span stores on the FAKE clock: span capture runs through
        # every chaos schedule (the whole point — traces of the runs that
        # trip invariants), and fake-clock timestamps make replays of one
        # seed produce identical waterfalls
        self.spans: dict[str, SpanStore] = {}
        # populated by check_invariants on any invariant trip: the last
        # window of every host's spans, so the failing request's trace is
        # in hand without re-running the schedule
        self.last_span_dump: dict[str, list[dict]] | None = None
        for h in self.cfg.hosts:
            t = self.net.transport(h)
            self.spans[h] = SpanStore(h, clock=self.clock)
            self.members[h] = MembershipService(h, self.cfg, t,
                                                clock=self.clock)
            if fail_slow:
                # node.py wiring, flag-gated: every reliable call now
                # feeds the caller's ledger with the net's SYNTHESIZED
                # latency (call_latency — no clock advance, no rng)
                t.health = self.members[h].health
            self.services[h] = InferenceService(
                h, self.cfg, t, self.members[h],
                ChaosEngine(h, self.clock),
                metrics=MetricsTracker(clock=self.clock),
                scheduler=FairScheduler(self.cfg,
                                        rng=random.Random(seed),
                                        clock=self.clock),
                clock=self.clock)
            self.services[h].spans = self.spans[h]
            self.stores[h] = FileStoreService(
                h, self.cfg, t, self.members[h],
                os.path.join(data_dir, h))
            self.stores[h].spans = self.spans[h]
            mgr = LMPoolManager(h, self.cfg, t, self.members[h],
                                inference_service=self.services[h])
            mgr.spans = self.spans[h]
            # the fake tier completes instantly: shrink the watchdog so a
            # poll reply lost to chaos re-forwards within the convergence
            # loop instead of after the production 120 s allowance
            mgr.request_timeout_s = 0.2
            mgr.build_rpc_timeout_s = 0.5
            self.managers[h] = mgr
            self.failovers[h] = FailoverManager(
                h, self.cfg, t, self.members[h], self.services[h],
                lm_manager=mgr)
            self.services[h].wal_hook = self.failovers[h].wal_append
            # node.py wiring: scaling decisions write ahead to the standby
            mgr.failover = self.failovers[h]
            # the autoscaler runs on the fake clock (dwell/drain windows
            # are schedule-driven) and, when the group workload is on,
            # reads scripted pressure instead of live gateway RPCs
            mgr.autoscaler.clock = self.clock
            if autoscale:
                mgr.autoscaler.gauges_fn = (
                    lambda name, _m=mgr: self._scripted_gauges(_m, name))
            self.controls[h] = ChaosControl(
                h, self.members[h], mgr, store=self.stores[h],
                violations=self.violations)
            t.serve("control", self.controls[h].handle)
        # invariant recorders (violations created above, pre-host-loop)
        self.epoch_owners: dict[int, set[str]] = {}
        self.acting_by_epoch: dict[int, set[str]] = {}
        # (scope, epoch) -> owners seen: >1 owner = per-pool split brain
        self.scope_owners: dict[tuple[str, int], set[str]] = {}
        # (scope, claim seq) -> claimants seen across every host's
        # gossiped ownership map: >1 = conflicting placement claims
        self.claim_owners: dict[tuple[str, int], set[str]] = {}
        # scope -> the deterministic rendezvous owner over the FULL host
        # set (filled after the pools are served): the seq-1 claim must
        # land exactly there on every run of this seed
        self.expected_owners: dict[str, str] = {}
        self._wrap_probes()
        # workload ledgers
        self._serial = 0
        self.cnn_acked: list[tuple[str, int, int, int]] = []  # model,q,lo,hi
        self.lm_acked: list[dict] = []       # {serial, prompt, seed, max_new}
        self.lmb_acked: list[dict] = []      # second-pool submissions
        # every ATTEMPTED lm submit, acked or not: a submit whose ACK was
        # lost may still have been journaled (the classic "maybe" outcome)
        # and legitimately completes — but tokens from a request nobody
        # ever attempted would mean cross-wired journals
        self.lm_attempted: list[dict] = []
        self.grp_acked: list[dict] = []      # group-routed lm submissions
        self.lmp_acked: list[dict] = []      # shared-head prefix workload
        self.lmh_acked: list[dict] = []      # distserve handoff workload
        # (name, version, blob, holders-at-ack): the holder set feeds the
        # ring-RF invariant — a death must not shrink it below min(RF, |set|)
        self.sdfs_acked: list[tuple[str, int, bytes, frozenset]] = []
        self.lm_delivered: dict[tuple, int] = {}   # token tuple -> count
        # token tuple -> pool name that delivered it (cross-pool isolation:
        # must equal the pool the tokens were submitted to)
        self.lm_delivered_pool: dict[tuple, str] = {}
        for h in self.cfg.hosts:
            self.members[h].join()
            self.clock.advance(0.01)
        self.pump_membership(waves=3)
        # one managed decode pool up-front; its journal rides failover
        out = self._client_control("n2", {
            "verb": "lm_serve", "placement": "auto", "name": self.LM_POOL,
            "prompt_len": 8, "max_len": 64, "slots": 4,
            **({"prefill_chunk": self.prefill_chunk}
               if self.prefill_chunk else {}),
            **({"n_model": self.n_model}
               if self.n_model > 1 else {}),
            **({"cluster_prefix": True, "kv_block_size": 2}
               if self.cluster_prefix else {})})
        assert out.get("node") or out.get("already"), out
        if multi_pool:
            # a SECOND independent managed pool: its journal, fence scope,
            # and WAL segment must ride failover without ever coupling to
            # the first pool's (cross-pool isolation invariant)
            outb = self._client_control("n3", {
                "verb": "lm_serve", "placement": "auto",
                "name": self.LM_POOL_B, "prompt_len": 8, "max_len": 64,
                "slots": 4})
            assert outb.get("node") or outb.get("already"), outb
        if autoscale:
            # a replica group under a tight policy: windows sized to the
            # 0.3 s pump waves so one schedule crosses both thresholds
            gout = self._client_control("n2", {
                "verb": "lm_serve", "placement": "auto",
                "name": self.LM_GROUP, "prompt_len": 8, "max_len": 64,
                "slots": 4,
                "autoscale": {"deadline_slack_s": 1.0,
                              "scale_in_frac": 0.25,
                              "dwell_s": 1.0, "drain_window_s": 1.0,
                              "max_replicas": 3}})
            assert gout.get("group") or gout.get("already"), gout
        if distserve:
            # a role-split group with a KV block pool: prefill-heavy
            # prompts (>= 4 tokens) route in handoff mode. The policy is
            # DISABLED so the autoscaler never retires the role pair
            # mid-schedule — the handoff path itself is what is under
            # test, not scaling.
            dout = self._client_control("n2", {
                "verb": "lm_serve", "placement": "auto",
                "name": self.LM_GROUP_D, "prompt_len": 8, "max_len": 64,
                "slots": 4, "kv_block_size": 2,
                "autoscale": {"enabled": False,
                              "prefill_len_threshold": 4,
                              "max_replicas": 3}})
            assert dout.get("group") or dout.get("already"), dout
            owner = next(h for h in self.cfg.hosts
                         if self.LM_GROUP_D in self.managers[h]._groups)
            sd = self.managers[owner].group_spawn(self.LM_GROUP_D,
                                                  role="prefill")
            assert sd is not None, "distserve prefill spawn failed"
        names = ([self.LM_POOL]
                 + ([self.LM_POOL_B] if multi_pool else [])
                 + ([self.LM_GROUP] if autoscale else [])
                 + ([self.LM_GROUP_D] if distserve else []))
        full = set(self.cfg.hosts)
        self.expected_owners = {
            pool_scope(n): place_scope(pool_scope(n), self.cfg.hosts, full)
            for n in names}

    # -- probes -----------------------------------------------------------

    def _wrap_probes(self) -> None:
        for h in self.cfg.hosts:
            t = self.net._nodes[h]
            fence = self.members[h].epoch
            scopes = self.members[h].scopes
            for svc in PROBED_SERVICES:
                handler = t._handlers.get(svc)
                if handler is None:
                    continue
                t._handlers[svc] = self._probe(h, svc, fence, scopes,
                                               handler)

    def _probe(self, host, svc, fence, scopes, handler):
        def wrapped(service, msg):
            pre = fence.current()     # BEFORE the handler can observe
            sp = (msg.payload or {}).get("scope_epoch")
            pre_scope = (scopes.fence(str(sp[0])).current()
                         if sp else None)
            out = handler(service, msg)
            ep = (msg.payload or {}).get("epoch")
            if (ep and int(ep[0]) < pre and out is not None
                    and out.type is not MessageType.ERROR):
                self.violations.append(
                    f"{host}/{svc} ACKed stale epoch {ep[0]} < {pre}")
            if (sp and int(sp[1]) < pre_scope and out is not None
                    and out.type is not MessageType.ERROR):
                self.violations.append(
                    f"{host}/{svc} ACKed stale scope {sp[0]} "
                    f"epoch {sp[1]} < {pre_scope}")
            return out
        return wrapped

    def record_fences(self) -> None:
        """Sample every node's fence view: two owners for one epoch — or
        two nodes acting as master under one epoch — is split brain.
        Scope fences are sampled the same way: two owners for one
        (scope, epoch) is per-pool split brain."""
        for h in self.cfg.hosts:
            e, owner = self.members[h].epoch.view()
            if owner is not None:
                self.epoch_owners.setdefault(e, set()).add(owner)
            if self.members[h].is_acting_master:
                self.acting_by_epoch.setdefault(
                    self.members[h].epoch.current(), set()).add(h)
            for scope, view in self.members[h].scopes.view_all().items():
                se, sowner = int(view[0]), view[1]
                if sowner is not None:
                    self.scope_owners.setdefault(
                        (scope, se), set()).add(sowner)
            # ownership claims: two hosts claiming one
            # (scope, seq) would mean the rendezvous/adoption protocol
            # minted conflicting owners — routing split brain
            for scope, view in self.members[h].owners.view_all().items():
                self.claim_owners.setdefault(
                    (scope, int(view[1])), set()).add(view[0])

    # -- client helpers (route like real clients: chain + retry) ----------

    def _client_control(self, client: str, payload: dict,
                        idem: str | None = None) -> dict:
        if idem is not None:
            payload = dict(payload, idem=idem)
        t = self.net._nodes[client]
        # owner-aware pre-route: pool-directed verbs go to the
        # client's gossiped scope-owner view FIRST — the chain stays as
        # fallback, and a typed scope_owner redirect adds ONE extra hop
        targets = []
        name = payload.get("name")
        if (payload.get("verb") in ChaosControl._POOL_VERBS
                and payload.get("placement") is None and name):
            o = self.members[client].owners.owner(pool_scope(name))
            if o is not None:
                targets.append(o)
        for x in (self.members[client].acting_master(),
                  self.cfg.coordinator, self.cfg.standby_coordinator):
            if x not in targets:
                targets.append(x)
        last = None
        redirected = False
        i = 0
        while i < len(targets):
            target = targets[i]
            i += 1
            try:
                out = call_with_retry(
                    lambda target=target: t.call(
                        target, "control",
                        Message(MessageType.INFERENCE, client, payload)),
                    attempts=2, base_s=0.0, cap_s=0.0, deadline_s=0.2,
                    sleep=lambda s: None)
            except TransportError as e:
                last = e
                continue
            if out is None:
                continue
            err = out.payload.get("error", "")
            if out.type is MessageType.ERROR:
                ro = out.payload.get("scope_owner")
                if ro and not redirected and ro not in targets:
                    # follow exactly one typed redirect to the claimed
                    # owner the deposed holder named
                    redirected = True
                    targets.insert(i, ro)
                    last = err
                    continue
                if ("acting master" in err or "fenced" in err
                        or "scope owner" in err or ro
                        or out.payload.get("stale_epoch")):
                    last = err
                    continue
                raise RuntimeError(err)
            return out.payload
        raise TransportError(f"no master reachable: {last}")

    # -- workload ops -----------------------------------------------------

    def op_cnn(self, client: str) -> None:
        self._serial += 1
        model = f"m{self._serial}"        # one model per logical query:
        lo = self._serial * 100           # ack/result matching is exact
        hi = lo + 19                      # even across deposed lineages
        try:
            q = self.services[client].submit_query(model, lo, hi)
        except (InferenceServiceError, TransportError, StoreError):
            return                        # no master reachable — lost, fine
        self.cnn_acked.append((model, q, lo, hi))

    def op_lm(self, client: str) -> None:
        self._serial += 1
        s = self._serial
        prompt = [s % 251, (s * 7) % 251, (s * 13) % 251]
        self.lm_attempted.append({"serial": s, "prompt": prompt,
                                  "seed": s, "max_new": 4,
                                  "pool": self.LM_POOL})
        try:
            out = self._client_control(
                client, {"verb": "lm_submit", "name": self.LM_POOL,
                         "prompt": prompt, "max_new": 4, "seed": s},
                idem=f"{client}:{s}")
        except (TransportError, RuntimeError):
            return
        self.lm_acked.append({"serial": s, "rid": int(out["id"]),
                              "prompt": prompt, "seed": s, "max_new": 4})

    def op_lm_b(self, client: str) -> None:
        """A submission to the SECOND managed pool. Prompts are
        serial-unique, so token keys stay globally unique and the global
        exactly-once ledger decomposes per pool; the delivered-pool
        attribution check is what makes cross-pool isolation explicit."""
        self._serial += 1
        s = self._serial
        prompt = [s % 251, (s * 7) % 251, (s * 13) % 251]
        self.lm_attempted.append({"serial": s, "prompt": prompt,
                                  "seed": s, "max_new": 4,
                                  "pool": self.LM_POOL_B})
        try:
            out = self._client_control(
                client, {"verb": "lm_submit", "name": self.LM_POOL_B,
                         "prompt": prompt, "max_new": 4, "seed": s},
                idem=f"{client}:{s}:b")
        except (TransportError, RuntimeError):
            return
        self.lmb_acked.append({"serial": s, "rid": int(out["id"]),
                               "prompt": prompt, "seed": s, "max_new": 4})

    def op_lm_group(self, client: str) -> None:
        """A group submission: routes like op_lm but lands on whichever
        replica the group picks; the seed is pinned by the client, so
        tokens are replica-independent and ride the same exactness
        ledger as pool submissions."""
        self._serial += 1
        s = self._serial
        prompt = [s % 251, (s * 7) % 251, (s * 13) % 251]
        self.lm_attempted.append({"serial": s, "prompt": prompt,
                                  "seed": s, "max_new": 4,
                                  "pool": self.LM_GROUP})
        try:
            out = self._client_control(
                client, {"verb": "lm_submit", "name": self.LM_GROUP,
                         "prompt": prompt, "max_new": 4, "seed": s,
                         "tenant": f"t{s % 3}"},
                idem=f"{client}:{s}:g")
        except (TransportError, RuntimeError):
            return
        self.grp_acked.append({"serial": s, "grid": int(out["id"]),
                               "prompt": prompt, "seed": s, "max_new": 4})

    # shared 6-token head = exactly 3 full blocks at kv_block_size=2:
    # every prefix submission publishes/remote-hits the SAME chain, so a
    # serving-node death followed by a failover rebuild must re-derive it
    # from the ring (the fake radix tree died with the node)
    PREFIX_HEAD = (11, 13, 17, 19, 23, 29)

    def op_lm_prefix(self, client: str) -> None:
        """A shared-head submission to the prefix-enabled pool: the
        head is 3 publishable blocks, the 1-token tail keeps
        the token tuple serial-unique for the exactness ledger. The
        fake tier's admission probes/fetches/publishes the head through
        the REAL ClusterPrefixCache; content checks append violations."""
        self._serial += 1
        s = self._serial
        prompt = list(self.PREFIX_HEAD) + [s % 251]
        self.lm_attempted.append({"serial": s, "prompt": prompt,
                                  "seed": s, "max_new": 4,
                                  "pool": self.LM_POOL})
        try:
            out = self._client_control(
                client, {"verb": "lm_submit", "name": self.LM_POOL,
                         "prompt": prompt, "max_new": 4, "seed": s},
                idem=f"{client}:{s}:p")
        except (TransportError, RuntimeError):
            return
        self.lmp_acked.append({"serial": s, "rid": int(out["id"]),
                               "prompt": prompt, "seed": s, "max_new": 4})

    def op_lm_handoff(self, client: str) -> None:
        """A LONG-prompt submission to the role-split group:
        7 tokens crosses the prefill_len_threshold (4), so the manager
        routes it in handoff mode — the prefill replica fills + ships 3
        KV blocks to the tenant-sticky decode replica before the request
        forwards there. Tokens stay serial-unique, so the submission
        rides the same exactness ledger; a ship that dies mid-flight
        must fall back or replay, never lose or double the request."""
        self._serial += 1
        s = self._serial
        prompt = [s % 251, (s * 7) % 251, (s * 13) % 251,
                  (s * 17) % 251, (s * 19) % 251, (s * 23) % 251,
                  (s * 29) % 251]
        self.lm_attempted.append({"serial": s, "prompt": prompt,
                                  "seed": s, "max_new": 4,
                                  "pool": self.LM_GROUP_D})
        try:
            out = self._client_control(
                client, {"verb": "lm_submit", "name": self.LM_GROUP_D,
                         "prompt": prompt, "max_new": 4, "seed": s,
                         "tenant": f"t{s % 3}"},
                idem=f"{client}:{s}:h")
        except (TransportError, RuntimeError):
            return
        self.lmh_acked.append({"serial": s, "hrid": int(out["id"]),
                               "prompt": prompt, "seed": s, "max_new": 4})

    def probe_sweep(self, prober: str) -> None:
        """One latency-sampling sweep (fail_slow schedules only): the
        prober calls every peer once so its ledger holds >= min_samples
        on the whole fleet — the fleet median needs healthy samples, not
        just the victim's. Replies (even ERROR) observe the synthesized
        latency; a cut link observes an error sample. Consumes net rng,
        so it only ever runs under the fail_slow flag."""
        t = self.net._nodes[prober]
        for peer in self.cfg.hosts:
            if peer == prober:
                continue
            try:
                t.call(peer, "control",
                       Message(MessageType.INFERENCE, prober,
                               {"verb": "health_probe"}))
            except TransportError:
                pass

    def _scripted_gauges(self, mgr: LMPoolManager, name: str) -> dict:
        """Deterministic stand-in for `group_gauges`: scripted p95
        pressure (one number for the whole group), real journal backlog
        from the manager the autoscaler is ticking on."""
        out: dict = {}
        with mgr._lock:
            g = mgr._groups.get(name)
            if g is None:
                return out
            for r, meta in g["replicas"].items():
                if meta["state"] != "active":
                    continue
                pool = mgr._pools.get(r)
                backlog = 0
                if pool is not None:
                    backlog = sum(
                        1 for q in pool["requests"].values()
                        if q["status"] in ("pending", "inflight"))
                out[r] = {"interactive_p95": float(self.group_pressure),
                          "n": 8, "backlog": backlog}
        return out

    def op_sdfs(self, client: str) -> None:
        self._serial += 1
        name = f"f{self._serial}"
        blob = f"blob-{self.seed}-{self._serial}".encode()
        try:
            v = self.stores[client].put_bytes(name, blob)
        except (StoreError, TransportError):
            return
        # holders-at-ack for the ring-RF invariant, read straight off the
        # acting master's metadata (in-process, NO extra network traffic —
        # an ls RPC here would consume the net's chaos rng and shift every
        # existing seed's schedule)
        master = self.members[client].acting_master()
        store = self.stores[master]
        with store._meta_lock:
            holders = frozenset(store._locations.get(name, set()))
        self.sdfs_acked.append((name, v, blob, holders))

    # -- fault ops --------------------------------------------------------

    def op_partition(self) -> None:
        a, b = self.rng.sample(self.cfg.hosts, 2)
        self.net.partition(a, b)

    def op_isolate(self, host: str | None = None) -> None:
        h = host or self.rng.choice(self.cfg.hosts)
        for x in self.cfg.hosts:
            if x != h:
                self.net.partition(h, x)

    def op_oneway(self) -> None:
        a, b = self.rng.sample(self.cfg.hosts, 2)
        self.net.cut_oneway(a, b)

    def op_heal(self) -> None:
        self.net.heal_all()

    # -- pumping ----------------------------------------------------------

    def pump_membership(self, waves: int = 1, dt: float = 0.3) -> None:
        for _ in range(waves):
            for m in self.members.values():
                m.ping_once()
            self.clock.advance(dt)
            for m in self.members.values():
                m.monitor_once()

    def pump_work(self) -> None:
        for h in self.cfg.hosts:
            self.services[h].process_jobs_once()
        for h in self.cfg.hosts:
            if self.members[h].is_acting_master:
                self.services[h].monitor_stragglers_once()
            # multi-owner control plane: EVERY host pumps its
            # manager — pool owners drive their own scopes' dispatch and
            # WAL shipping, not just the master (pump_once no-ops on
            # hosts with nothing to do; replicate_once gates internally)
            self.managers[h].pump_once()
            self.failovers[h].replicate_once()

    def step(self) -> None:
        """One seeded schedule step: a workload or fault op, then a pump
        wave, then fence sampling."""
        self._steps_run += 1
        if self.autoscale:
            # scripted load curve: overload long enough to cross the
            # scale-out threshold, then idle so the group scales back in
            self.group_pressure = (5.0 if self._steps_run
                                   <= self.overload_steps else 0.0)
        if self.fail_slow:
            # scripted fail-slow window: the victim limps —
            # heartbeats still flow, so this is GRAY, not fail-stop —
            # through the middle of the schedule, then heals. The sweep
            # and the fault itself live entirely behind the flag so
            # existing seeds replay unshifted.
            if self._steps_run == 4:
                self.net.slow_host(self.slow_victim, 10.0)
            elif self._steps_run == self.overload_steps + 4:
                self.net.clear_slow(self.slow_victim)
            self.probe_sweep(self.slow_prober)
        r = self.rng.random()
        client = self.rng.choice(self.cfg.hosts)
        if r < 0.22:
            self.op_cnn(client)
        elif r < 0.44:
            # every extra draw is flag-gated: existing seeds' schedules
            # must not shift when the group/second-pool workload is off
            if self.autoscale and self.rng.random() < 0.5:
                self.op_lm_group(client)
            elif self.multi_pool and self.rng.random() < 0.5:
                self.op_lm_b(client)
            elif self.cluster_prefix and self.rng.random() < 0.5:
                self.op_lm_prefix(client)
            elif self.distserve and self.rng.random() < 0.5:
                self.op_lm_handoff(client)
            else:
                self.op_lm(client)
        elif r < 0.58:
            self.op_sdfs(client)
        elif r < 0.68:
            self.op_partition()
        elif r < 0.74:
            self.op_oneway()
        elif r < 0.80:
            self.op_isolate()
        elif r < 0.90:
            self.op_heal()
        # else: pure pump step
        self.pump_membership(waves=1)
        self.pump_work()
        self.record_fences()
        if self.fail_slow:
            self._sample_fail_slow()

    def _sample_fail_slow(self) -> None:
        """Per-step fail-slow invariant sampling: record that some
        ledger reached QUARANTINED, and trip a FALSE-LEAVE violation if
        a host keeps the victim out of its alive view for many
        consecutive steps while both ends' links are verifiably clean —
        the health plane diverting traffic must never suppress the
        heartbeats that would refute a drop-induced suspicion, and the
        fault itself advances no clock so it can never cause a timeout.
        One-off missing views are legal (datagram drop chaos); a LONG
        streak over clean links is the forged-LEAVE smell."""
        victim = self.slow_victim
        if not self.saw_quarantine:
            for m in self.members.values():
                if m.health.state(victim) == "quarantined":
                    self.saw_quarantine = True
                    break
        clean_victim = self.net.unperturbed(victim)
        for h in self.cfg.hosts:
            if h == victim:
                continue
            missing = (clean_victim and self.net.unperturbed(h)
                       and victim
                       not in self.members[h].members.alive_hosts())
            streak = self._leave_streak.get(h, 0) + 1 if missing else 0
            self._leave_streak[h] = streak
            if streak >= 8:
                self.violations.append(
                    f"false LEAVE: {h} kept fail-slow victim {victim} "
                    f"out of its alive view for {streak} clean-link "
                    f"steps (step {self._steps_run})")

    def run_schedule(self, steps: int = 40,
                     chaos: dict | None = None) -> None:
        if chaos:
            self.net.set_chaos(**chaos)
        for _ in range(steps):
            self.step()

    # -- convergence ------------------------------------------------------

    def final_master(self) -> str:
        acting = [h for h in self.cfg.hosts
                  if self.members[h].is_acting_master]
        assert len(acting) == 1, f"no unique acting master: {acting}"
        return acting[0]

    def converge(self, deadline_s: float = 20.0) -> float:
        """Heal everything and pump until all surviving work is terminal.
        Returns wall-clock seconds spent converging."""
        t0 = time.monotonic()
        self.net.heal_all()
        self.net.clear_chaos()
        self.net.flush_held()
        for h in self.cfg.hosts:
            self.net.revive(h)
        while True:
            self.pump_membership(waves=2)
            self.pump_work()
            for h in self.cfg.hosts:
                self.services[h].join_reassign_dispatch(timeout=1.0)
                self.stores[h].join_repair(timeout=1.0)
            self.record_fences()
            if self._settled():
                return time.monotonic() - t0
            if time.monotonic() - t0 > deadline_s:
                raise AssertionError(
                    f"seed {self.seed}: no convergence in {deadline_s}s: "
                    f"{self._unsettled()}")
            time.sleep(0.02)    # real time for the lm watchdog / threads

    def _surviving_cnn(self):
        """Acked queries present in the final master's journal lineage
        (a doomed minority-master ack books a model name the surviving
        journal never saw — a lost ack, the shape client idempotent
        retries exist for). Keyed on the BOOKING: results alone can leak
        into the survivor from workers finishing a deposed master's
        dispatches (`_handle_result` observes, never rejects), and such a
        query has no tasks to ever flip query_done."""
        m = self.services[self.final_master()]
        return [(model, q, lo, hi) for model, q, lo, hi in self.cnn_acked
                if m.scheduler.book.tasks_for_query(model, q)]

    def _pool_owner(self, name: str) -> str:
        """The host whose manager holds ``name``'s journal NOW: the final
        master's gossiped claim if its holder is alive, else the master
        itself (pre-ownership fallback). Every owner-aware read — drains,
        settle checks, invariant sweeps — goes through here instead of
        assuming the master holds every pool."""
        fm = self.final_master()
        o = self.members[fm].owners.owner(pool_scope(name))
        if o is not None and o in self.members[fm].members.alive_hosts():
            return o
        return fm

    def _surviving_lm(self):
        mgr = self.managers[self._pool_owner(self.LM_POOL)]
        with mgr._lock:
            pool = mgr._pools.get(self.LM_POOL)
            rids = set(pool["requests"]) if pool else set()
            done = pool["done_total"] if pool else 0
        return rids, done

    def _unsettled(self) -> list[str]:
        out = []
        m = self.services[self.final_master()]
        for model, q, lo, hi in self._surviving_cnn():
            if not (m.query_done(model, q) or m.query_failed(model, q)):
                out.append(f"cnn {model} q{q}")
        pools = [("lm", self.LM_POOL)]
        if self.multi_pool:
            pools.append(("lmB", self.LM_POOL_B))
        for tag, pname in pools:
            mgr = self.managers[self._pool_owner(pname)]
            with mgr._lock:
                pool = mgr._pools.get(pname)
                if pool is None:
                    continue
                if pool["node"] is None:
                    out.append(f"{tag} pool unplaced")
                for rid, r in pool["requests"].items():
                    if r["status"] in ("pending", "inflight"):
                        out.append(f"{tag} rid {rid} {r['status']}")
        for gname in (self.LM_GROUP, self.LM_GROUP_D):
            mgr = self.managers[self._pool_owner(gname)]
            with mgr._lock:
                g = mgr._groups.get(gname)
                if g is None:
                    continue
                replicas = list(g["replicas"])
                placed = [r for r in replicas
                          if (mgr._pools.get(r) or {}).get("node")]
                if not placed:
                    out.append(f"group {gname} has no placed replica")
                for r in replicas:
                    rpool = mgr._pools.get(r)
                    if rpool is None:
                        continue
                    for rid, q in rpool["requests"].items():
                        if q["status"] in ("pending", "inflight"):
                            out.append(f"grp {r} rid {rid} {q['status']}")
        if self.fail_slow:
            # probation must HEAL once the fault clears: converge ends
            # only when no ledger still watches anyone — quarantine is a
            # verdict about a fault, not a permanent exile
            for h in self.cfg.hosts:
                w = self.members[h].health.watched()
                if w:
                    out.append(f"health {h} watches {sorted(w)}")
        return out

    def _settled(self) -> bool:
        acting = [h for h in self.cfg.hosts
                  if self.members[h].is_acting_master]
        if len(acting) != 1:
            return False
        # membership must re-converge too: every host sees every host
        # alive again (false LEAVEs refuted post-heal) — settling on work
        # completion alone would snapshot views mid-refutation
        full = set(self.cfg.hosts)
        for h in self.cfg.hosts:
            if set(self.members[h].members.alive_hosts()) != full:
                return False
        return not self._unsettled()

    # -- invariants -------------------------------------------------------

    def drain_lm(self) -> list[dict]:
        """Poll the surviving journal through the client path, recording
        per-completion delivery counts (token tuple = logical request
        identity, since every prompt is serial-unique)."""
        got = []
        names = ([self.LM_POOL]
                 + ([self.LM_POOL_B] if self.multi_pool else [])
                 + ([self.LM_GROUP] if self.autoscale else [])
                 + ([self.LM_GROUP_D] if self.distserve else []))
        for _ in range(3):
            for name in list(names):
                try:
                    out = self._client_control("n3", {"verb": "lm_poll",
                                                      "name": name})
                except RuntimeError as e:
                    # the pool died with a doomed lineage (created but
                    # never replicated before the master was deposed):
                    # nothing to drain — its acks were lost, never wrong
                    if "pool" in str(e):
                        names.remove(name)
                        continue
                    raise
                for c in out.get("completions", ()):
                    key = tuple(c["tokens"])
                    self.lm_delivered[key] = (
                        self.lm_delivered.get(key, 0) + 1)
                    self.lm_delivered_pool[key] = name
                    got.append(c)
            if not names:
                break
            self.pump_work()
        return got

    def span_dump(self) -> dict[str, list[dict]]:
        """Every host's current span window (chaos-causal
        dumps) — the raw material `idunno_tpu_torch/tools/trace_export.py`
        turns into a Perfetto timeline of the failing schedule."""
        return {h: s.dump() for h, s in self.spans.items()}

    def check_invariants(self) -> dict:
        """Assert every global invariant; returns a summary dict. On any
        trip the full per-host span dump is snapshotted into
        ``last_span_dump`` BEFORE the assertion propagates, so the failing
        request's trace (the one named in the assertion message) can be
        pulled out and exported without replaying the seed."""
        try:
            return self._check_invariants()
        except AssertionError:
            self.last_span_dump = self.span_dump()
            raise

    def _check_invariants(self) -> dict:
        assert not self.violations, self.violations
        for e, owners in self.epoch_owners.items():
            assert len(owners) <= 1, \
                f"epoch {e} owned by {sorted(owners)} (split brain)"
        for e, hosts in self.acting_by_epoch.items():
            assert len(hosts) <= 1, \
                f"epoch {e} acted by {sorted(hosts)} (split brain)"
        for (scope, e), owners in self.scope_owners.items():
            assert len(owners) <= 1, \
                f"scope {scope} epoch {e} owned by {sorted(owners)} " \
                f"(per-pool split brain)"
        # ownership claims: at most one claimant per
        # (scope, seq) across every host's gossiped view, the FIRST
        # claim lands exactly on the rendezvous placement, and with a
        # second pool the owners genuinely spread over >1 host
        for (scope, seq), owners in self.claim_owners.items():
            assert len(owners) <= 1, \
                f"scope {scope} claim seq {seq} by {sorted(owners)} " \
                f"(ownership split brain)"
        for scope, want in self.expected_owners.items():
            got = self.claim_owners.get((scope, 1))
            if got:
                assert got == {want}, \
                    f"scope {scope} first claim {sorted(got)} != " \
                    f"rendezvous placement {want}"
        if self.multi_pool:
            assert len(set(self.expected_owners.values())) >= 2, \
                f"owner spread: every scope placed on one host " \
                f"{self.expected_owners}"
        # membership converged: every alive host agrees on the alive set
        views = {h: tuple(self.members[h].members.alive_hosts())
                 for h in self.cfg.hosts}
        assert len(set(views.values())) == 1, views
        # CNN: exact result sets, no duplicate records
        m = self.services[self.final_master()]
        survived = self._surviving_cnn()
        for model, q, lo, hi in survived:
            if m.query_failed(model, q):
                continue        # terminal (move-cap) — still exactly-once
            recs = m.results(model, q)
            names = [r[0] for r in recs]
            assert len(names) == len(set(names)) == hi - lo + 1, \
                f"{model} q{q}: {len(names)} records for {hi - lo + 1}"
            assert set(names) == {f"test_{i}.JPEG"
                                  for i in range(lo, hi + 1)}
        # LM: exactly one terminal state per surviving admitted request,
        # token-exact completions, at-most-once delivery
        self.drain_lm()
        rids, done_total = self._surviving_lm()
        by_tokens = {tuple(lm_tokens(a["prompt"], a["seed"],
                                     a["max_new"])): a
                     for a in self.lm_attempted}
        for key, n in self.lm_delivered.items():
            assert n == 1, f"completion delivered {n}x: {key}"
            assert key in by_tokens, f"tokens never submitted: {key}"
            # cross-pool isolation: the completion surfaced from the pool
            # its tokens were submitted to — a deposed pool-A owner whose
            # outbox leaked into pool B would trip here
            want_pool = by_tokens[key].get("pool", self.LM_POOL)
            got_pool = self.lm_delivered_pool.get(key, want_pool)
            assert got_pool == want_pool, \
                f"completion crossed pools: submitted to {want_pool}, " \
                f"delivered by {got_pool}: {key}"
        # SDFS: surviving puts read back exactly, and ring re-replication
        # kept every surviving version at full strength — alive holders
        # >= min(replication_factor, holders-at-ack)
        store = self.stores[self.final_master()]
        alive_now = set(self.members[self.final_master()]
                        .members.alive_hosts())
        sdfs_survived = 0
        for name, version, blob, holders in self.sdfs_acked:
            try:
                got, v = store.get_bytes(name, version=version)
            except StoreError:
                continue        # doomed-lineage ack (lost, never wrong)
            assert got == blob, f"{name} v{version} corrupt"
            sdfs_survived += 1
            have = {h for h in self.cfg.hosts
                    if version in self.stores[h].local.files().get(name, [])}
            want = min(self.cfg.replication_factor,
                       len(holders) if holders else 1, len(alive_now))
            assert len(have & alive_now) >= max(want, 1), \
                f"{name} v{version}: alive holders " \
                f"{sorted(have & alive_now)} < {want} (RF not restored)"
        # replica group: the scaling journal itself is an invariant
        # surface — exactly-once decisions, fenced epochs, no replica
        # double-spawned by a replayed decision
        grp_summary: dict = {}
        if self.autoscale:
            mgr = self.managers[self._pool_owner(self.LM_GROUP)]
            with mgr._lock:
                g = mgr._groups.get(self.LM_GROUP)
                gview = (None if g is None
                         else {"decisions": [dict(d)
                                             for d in g["decisions"]],
                               "next_seq": g["next_seq"],
                               "replicas": {r: dict(m) for r, m
                                            in g["replicas"].items()}})
            assert gview is not None, "replica group lost from journal"
            seqs = [d["seq"] for d in gview["decisions"]]
            assert seqs == sorted(set(seqs)), \
                f"scale decisions not strictly increasing: {seqs}"
            assert not seqs or seqs[-1] == gview["next_seq"] - 1, \
                f"decision journal truncated wrong: {seqs[-6:]} " \
                f"vs next_seq {gview['next_seq']}"
            spawned = [d["replica"] for d in gview["decisions"]
                       if d["action"] == "spawn"]
            assert len(spawned) == len(set(spawned)), \
                f"replica double-spawned: {spawned}"
            eps = [int(d["epoch"][0]) for d in gview["decisions"]]
            assert eps == sorted(eps), \
                f"scale-decision epochs regressed: {eps}"
            # every replica the journal believes in must be a real
            # {group}@r{i} name within the minted range
            for r in gview["replicas"]:
                idx = LMPoolManager._replica_index(r)
                assert 0 <= idx, f"malformed replica name {r!r}"
            # forecast determinism: the decision
            # rows carry the Holt predicted_rate that justified them —
            # digesting the full journal lets the soak driver replay the
            # seed and assert the forecast reproduced bit-for-bit
            blob = json.dumps(gview["decisions"], sort_keys=True)
            grp_summary = {"grp_acked": len(self.grp_acked),
                           "grp_replicas": len(gview["replicas"]),
                           "grp_decisions": gview["next_seq"],
                           "grp_decision_digest":
                               hashlib.sha256(blob.encode()).hexdigest()[:16]}
        # cluster prefix cache: inline content checks landed
        # in self.violations (asserted empty above); the summary carries
        # the aggregate fake-tier gauges so soak JSON shows the workload
        # actually exercised remote hits, not just cold misses
        prefix_summary: dict = {}
        if self.cluster_prefix:
            loops = [loop for ctl in self.controls.values()
                     for loop in ctl._loops.values()
                     if loop.get("cp") is not None]
            prefix_summary = {
                "lmp_acked": len(self.lmp_acked),
                "prefix_remote_hits": sum(x["remote_hits"]
                                          for x in loops),
                "prefix_published": sum(x["published"] for x in loops),
                "prefix_warmed": sum(x["warmed"] for x in loops)}
        # DistServe handoff: every handed-off request reached
        # a TERMINAL handoff state (adopted or fallback) by convergence —
        # a request stuck "prefilling"/"shipping" would mean the replay
        # machinery lost a ship edge. Content corruption landed in
        # self.violations (asserted empty above) via the adopt-side
        # KVC1 expect_tokens + chunk_content checks.
        ds_summary: dict = {}
        if self.distserve:
            mgr = self.managers[self._pool_owner(self.LM_GROUP_D)]
            with mgr._lock:
                g = mgr._groups.get(self.LM_GROUP_D)
                assert g is not None, "distserve group lost from journal"
                roles = {m["role"] for m in g["replicas"].values()}
                rc = dict(g["route_counts"])
                states: dict[str, int] = {}
                for r in list(g["replicas"]):
                    rpool = mgr._pools.get(r)
                    if rpool is None:
                        continue
                    for rid, q in rpool["requests"].items():
                        hop = q.get("handoff")
                        if not hop:
                            continue
                        st = hop.get("state")
                        states[st] = states.get(st, 0) + 1
                        assert st in ("adopted", "fallback"), \
                            f"handoff {r}:{rid} non-terminal at " \
                            f"convergence: {st!r}"
            assert {"prefill", "decode"} <= roles, \
                f"distserve group lost its role split: {sorted(roles)}"
            shipped = sum(x["shipped"] for ctl in self.controls.values()
                          for x in ctl._loops.values())
            adopted = sum(x["adopted"] for ctl in self.controls.values()
                          for x in ctl._loops.values())
            ds_summary = {
                "lmh_acked": len(self.lmh_acked),
                "handoff_routed": rc.get("handoff", 0),
                "handoff_adopted": states.get("adopted", 0),
                "handoff_fallback": states.get("fallback", 0),
                "handoff_blocks_shipped": shipped,
                "handoff_blocks_adopted": adopted}
        # gray failure: the differential plane must have
        # QUARANTINED the scripted limping victim (heartbeats alive the
        # whole time — the false-LEAVE streak check above feeds
        # self.violations), and every ledger must be back to all-healthy
        # after the fault cleared (probation heals; also a converge
        # gate, re-asserted here so the summary can't lie)
        fs_summary: dict = {}
        if self.fail_slow:
            assert self.saw_quarantine, \
                f"fail-slow victim {self.slow_victim} never quarantined"
            for h in self.cfg.hosts:
                w = self.members[h].health.watched()
                assert not w, \
                    f"{h} still watches {sorted(w)} after fault clear"
            fs_summary = {"slow_victim": self.slow_victim,
                          "quarantine_seen": True}
        pool_epochs: dict[str, int] = {}
        for scope, e in self.scope_owners:
            pool_epochs[scope] = max(pool_epochs.get(scope, 0), e)
        # final ownership map + total claim movement (seq 1 is the
        # placement claim; every later seq is an adoption move)
        fm_owners = self.members[self.final_master()].owners
        final_owners = {s: fm_owners.owner(s) for s in fm_owners.scopes()}
        max_seq: dict[str, int] = {}
        for scope, seq in self.claim_owners:
            max_seq[scope] = max(max_seq.get(scope, 1), seq)
        owner_moves = sum(s - 1 for s in max_seq.values())
        return {"cnn_acked": len(self.cnn_acked),
                "cnn_survived": len(survived),
                "lm_acked": len(self.lm_acked),
                "lmb_acked": len(self.lmb_acked),
                "lm_delivered": len(self.lm_delivered),
                "sdfs_acked": len(self.sdfs_acked),
                "sdfs_survived": sdfs_survived,
                "epochs": max(self.epoch_owners, default=0),
                "pool_epochs": pool_epochs,
                "scope_owners": final_owners,
                "owner_moves": owner_moves,
                "hosts": len(self.cfg.hosts),
                "final_master": self.final_master(),
                **grp_summary, **prefix_summary, **ds_summary,
                **fs_summary}


def run_seeded_schedule(seed: int, data_dir: str, steps: int = 40,
                        chaos: dict | None = None,
                        prefill_chunk: int = 0,
                        n_model: int = 1,
                        autoscale: bool = False,
                        multi_pool: bool = False,
                        n_hosts: int = 5,
                        cluster_prefix: bool = False,
                        distserve: bool = False,
                        fail_slow: bool = False) -> dict:
    """One full seeded chaos run: schedule -> converge -> invariants.
    Returns the invariant summary plus convergence time.
    ``prefill_chunk`` rides the managed pool's lm_serve spec:
    the fake tier defers long-prompt completions by a poll round, so the
    schedule exercises journaled specs + watchdog retries against a pool
    with in-flight chunked admissions. ``autoscale`` adds a replica
    group with scripted overload→underload pressure: the
    autoscaler's spawn/retire decisions ride the same fault schedule and
    the group's scaling journal joins the invariant surface.
    ``multi_pool`` serves a SECOND concurrent managed pool and
    ``n_hosts`` scales the cluster: per-pool fence scopes,
    scoped adoption, and cross-pool isolation join the invariant surface,
    certified at 50-100 hosts by the soak driver.
    ``cluster_prefix`` serves the first pool with the cluster prefix
    cache on: a shared-head workload publishes/remote-hits
    real KVC1 blobs on the real SDFS ring, with inline wrong-token /
    double-prefill checks feeding the violations ledger.
    ``distserve`` serves a role-split replica group with a KV block pool:
    long-prompt submissions route in handoff mode — the
    manager journals prefilling→shipping→adopted edges and ships real
    KVC1 blobs between the fake loops; deaths mid-handoff must replay
    the ship or fall back, never lose or double the request.
    ``fail_slow`` runs the gray-failure schedule: one scripted
    limping victim (synthesized latency, heartbeats alive), a fixed
    prober sampling the whole fleet, quarantine-without-LEAVE and
    probation-heals invariants on top of everything above."""
    c = ChaosCluster(seed, data_dir, n_hosts=n_hosts,
                     prefill_chunk=prefill_chunk,
                     n_model=n_model, autoscale=autoscale,
                     multi_pool=multi_pool,
                     cluster_prefix=cluster_prefix,
                     distserve=distserve,
                     fail_slow=fail_slow)
    try:
        c.run_schedule(steps=steps,
                       chaos=chaos if chaos is not None
                       else {"drop": 0.05, "dup": 0.03, "delay": 0.10,
                             "seed": seed})
        convergence_s = c.converge()
        out = c.check_invariants()
    except Exception as e:
        # any failure — invariant trip or convergence timeout — carries
        # the cluster's span windows out with it (chaos-causal dump: the
        # failing request's trace is in here, replayable from the seed)
        if c.last_span_dump is None:
            c.last_span_dump = c.span_dump()
        e.span_dump = c.last_span_dump
        raise
    out["convergence_s"] = round(convergence_s, 3)
    out["seed"] = seed
    out["spans_recorded"] = sum(s.recorded_total()
                                for s in c.spans.values())
    return out
