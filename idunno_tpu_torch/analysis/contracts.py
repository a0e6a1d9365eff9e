"""Declared protocol contracts the checkers enforce.

These registries are the machine-readable half of the repository's
contributor rules for "when adding a coordinator verb". They are
*declarations*, not detection: a new mutating verb must be added to
``IDEM_VERBS`` (and its anchors must then resolve), a new lock-guarded
field to ``GUARDED``, a new retry site to ``RETRY_SAFE`` — the checkers
fail loudly when an anchor no longer resolves, so a refactor cannot
silently shed a contract.
"""
from __future__ import annotations

import dataclasses

from idunno_tpu_torch.analysis.core import Finding


@dataclasses.dataclass(frozen=True)
class Allow:
    """One reviewed suppression. ``symbol``/``tag`` may be ``"*"``; the
    justification is mandatory and must be a real sentence."""
    checker: str
    file: str
    symbol: str
    tag: str
    justification: str

    def __post_init__(self) -> None:
        if len(self.justification.strip()) < 20:
            raise ValueError(
                f"allowlist entry {self.checker}:{self.file}:{self.symbol}"
                f":{self.tag} needs a real justification sentence, got "
                f"{self.justification!r}")

    def matches(self, f: Finding) -> bool:
        return (self.checker == f.checker and self.file == f.file
                and self.symbol in ("*", f.symbol)
                and self.tag in ("*", f.tag))


@dataclasses.dataclass(frozen=True)
class IdemVerb:
    """A mutating verb and where its exactly-once story is anchored.

    kind="keyed": the client threads an idempotency key and the server
    dedupes it (anchor = the structure name that must appear in the
    anchored function). kind="natural": the verb is idempotent by
    construction (named resource / journaled deterministic counter); the
    anchor is the construct that makes it so."""
    verb: str
    kind: str                                  # "keyed" | "natural"
    anchors: tuple[tuple[str, str, str], ...]  # (file, qualname, marker)
    why: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ("keyed", "natural"):
            raise ValueError(f"{self.verb}: kind {self.kind!r}")
        if self.kind == "natural" and len(self.why.strip()) < 20:
            raise ValueError(f"{self.verb}: a 'natural' idempotency claim "
                             "needs a justification sentence")


@dataclasses.dataclass(frozen=True)
class Guard:
    """Fields of ``cls`` in ``file`` that must only be touched under
    ``with self.<lock>``. Methods named ``*_locked`` assert the caller
    holds it (the repo's documented convention) and are exempt, as is
    ``__init__`` (no concurrency before construction completes)."""
    file: str
    cls: str
    lock: str
    fields: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class RetrySite:
    """A ``call_with_retry`` call site and why retrying there is safe."""
    file: str
    symbol: str      # qualname of the enclosing function
    verbs: tuple[str, ...]   # idem-registry verbs it may carry
    why: str

    def __post_init__(self) -> None:
        if len(self.why.strip()) < 20:
            raise ValueError(f"retry site {self.file}:{self.symbol} needs "
                             "a justification sentence")


@dataclasses.dataclass(frozen=True)
class HedgeVerb:
    """An idempotent READ verb allowed to tail-hedge: fire a
    duplicate request at a second host and take the first reply. Only
    verbs declared here may appear at a ``call_hedged`` site — hedging a
    mutation would double-book exactly like an unkeyed retry."""
    verb: str
    why: str

    def __post_init__(self) -> None:
        if len(self.why.strip()) < 20:
            raise ValueError(f"hedge verb {self.verb!r} needs a "
                             "justification sentence")


@dataclasses.dataclass(frozen=True)
class HedgeSite:
    """A ``call_hedged`` call site and the read verbs it may carry."""
    file: str
    symbol: str      # qualname of the enclosing function
    verbs: tuple[str, ...]   # HEDGE_VERBS entries it may carry
    why: str

    def __post_init__(self) -> None:
        if len(self.why.strip()) < 20:
            raise ValueError(f"hedge site {self.file}:{self.symbol} needs "
                             "a justification sentence")


@dataclasses.dataclass
class Contracts:
    fence_targets: tuple[str, ...]
    stamp_targets: tuple[str, ...]
    determinism_targets: tuple[str, ...]
    idem_verbs: tuple[IdemVerb, ...]
    guarded: tuple[Guard, ...]
    retry_safe: tuple[RetrySite, ...]
    allowlist: tuple[Allow, ...]
    hedge_verbs: tuple[HedgeVerb, ...] = ()
    hedge_safe: tuple[HedgeSite, ...] = ()


# -- the shipped registries -------------------------------------------------

# modules whose ``transport.serve`` handlers must fence (everything — the
# checker itself exempts mutation-free handlers and membership gossip)
FENCE_TARGETS = ("idunno_tpu_torch/",)

# modules whose transport send sites are coordinator-plane: every site
# must stamp an epoch, observe replies fence-aware, or be allowlisted
STAMP_TARGETS = ("idunno_tpu_torch/serve/", "idunno_tpu_torch/membership/",
                 "idunno_tpu_torch/store/")

# chaos-reachable modules: no wall-clock/rng draws outside injection
DETERMINISM_TARGETS = ("idunno_tpu_torch/serve/", "idunno_tpu_torch/membership/",
                       "idunno_tpu_torch/comm/", "idunno_tpu_torch/store/",
                       "idunno_tpu_torch/chaos.py")

IDEM_VERBS = (
    IdemVerb("submit", "keyed", anchors=(
        ("idunno_tpu_torch/serve/inference_service.py",
         "InferenceService.submit_query", "idem"),
        ("idunno_tpu_torch/serve/inference_service.py",
         "InferenceService._master_submit", "_idem"),
        # the key replicates with the failover snapshot, so a retry
        # against the ADOPTED master still dedupes
        ("idunno_tpu_torch/serve/failover.py",
         "FailoverManager._snapshot_locked", "idem"),
    )),
    IdemVerb("lm_submit", "keyed", anchors=(
        # node-local dedupe of a manager's re-forward after a lost ACK
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "_lm_idem"),
        # manager-side: journaled key → rid map, replayed by recovery
        ("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager.submit", "idem"),
    )),
    IdemVerb("put", "keyed", anchors=(
        ("idunno_tpu_torch/store/sdfs.py", "FileStoreService.put_bytes", "idem"),
        ("idunno_tpu_torch/store/sdfs.py", "FileStoreService._master_put",
         "_put_idem"),
    )),
    IdemVerb("train_start", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "already"),
        ("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager.train",
         "already"),),
        why="train jobs are a named resource: a retried start finds the "
            "live job and is rejected/absorbed, never double-started"),
    IdemVerb("lm_serve", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "already"),),
        why="pools are a named resource: a duplicate serve returns "
            "already=True instead of building a second loop"),
    IdemVerb("group_scale", "natural", anchors=(
        # deterministic replica names off a journaled counter: a replayed
        # spawn decision resolves to the same "{group}@r{i}" and dedupes
        ("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager.group_spawn",
         "next_replica"),),
        why="replica names derive from a journaled counter, so a replayed "
            "spawn decision recreates the same name instead of a twin"),
    IdemVerb("pool_wal", "natural", anchors=(
        # standby side keeps only the strictly newest per-pool entry
        ("idunno_tpu_torch/serve/failover.py", "FailoverManager._handle",
         "pool_wal"),
        # delta frames merge only onto the exact acked base_seq; any gap
        # NACKs need_full and the sender re-ships the full entry
        ("idunno_tpu_torch/serve/failover.py",
         "FailoverManager._merge_pool_delta_locked", "base_seq"),
        # adoption-time replay compares the per-pool monotone wal_seq
        ("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager.apply_pool_wal",
         "wal_seq"),),
        why="per-pool WAL entries carry a monotone per-pool wal_seq; a "
            "duplicated or replayed delta collapses because receivers "
            "keep only strictly newer entries per pool scope, and a "
            "delta frame applies only on its exact acked base"),
    IdemVerb("pool_assign", "natural", anchors=(
        # the acting master hands a pool spec to its placed scope owner
        # by re-sending lm_serve with placement="assign"; the owner's
        # manager absorbs duplicates as a named resource
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._route_cluster", "assign"),
        ("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager.serve",
         "already"),),
        why="pools are a named resource on the owner too: a replayed "
            "assign finds the live pool (or its _Starting reservation) "
            "and returns already=True instead of a second build"),
    IdemVerb("prefix_publish", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "prefix_publish"),
        # blobs are content-addressed by the rolling chunk hash: a
        # duplicate publish PUTs identical bytes under identical names
        ("idunno_tpu_torch/serve/cluster_prefix.py",
         "ClusterPrefixCache.publish", "chain_names"),),
        why="chain blobs are content-addressed by the rolling token-chunk "
            "hash, so a duplicated or replayed publish writes the "
            "identical bytes under the identical SDFS names and the "
            "version history converges instead of forking"),
    IdemVerb("prefix_probe", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "prefix_probe"),
        ("idunno_tpu_torch/serve/cluster_prefix.py",
         "ClusterPrefixCache.probe", "stat"),),
        why="probe is a pure read (ring STATs of content-addressed "
            "names); it mutates nothing on any node so a retried or "
            "duplicated probe is trivially exactly-once"),
    IdemVerb("prefix_fetch", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "prefix_fetch"),
        # grafting a chunk the radix tree already holds is a no-op: the
        # walk reuses the existing node instead of allocating a block
        ("idunno_tpu_torch/serve/prefix_cache.py",
         "RadixPrefixCache.graft", "children"),),
        why="fetch grafts content-addressed chunks into the radix tree; "
            "chunks already present are reused not reallocated, so a "
            "duplicated fetch converges on the same tree and pool state"),
    IdemVerb("kv_handoff", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "kv_handoff"),
        # adopt decodes each KVC1 blob against the expected token chunk
        # (wrong-content blobs are refused, not grafted) and grafts via
        # the radix tree, which reuses chunks it already holds
        ("idunno_tpu_torch/engine/serve_lm.py",
         "DecodeServer.handoff_adopt", "expect_tokens"),
        ("idunno_tpu_torch/serve/prefix_cache.py",
         "RadixPrefixCache.graft", "children"),),
        why="a replayed ship re-probes the decode replica's radix depth "
            "and adopt grafts content-verified chunks that dedupe against "
            "blocks already held, so duplicated handoffs converge on the "
            "same block-pool state and the journaled request decodes once"),
    # -- verbs the port's own control tier serves on its own engines ------
    IdemVerb("generate", "natural", anchors=(
        # the node-local model cache fills once per name under _reg_lock;
        # a retried generate reuses the cached model
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "_lms"),),
        why="generate only fills the node's load-once model cache (keyed "
            "by store name, under the registry lock) and returns tokens "
            "that are a pure function of the prompt, the weights and the "
            "caller's seed, so a retried generate changes no state twice"),
    IdemVerb("lm_stop", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "_lm_loops.pop"),
        ("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager.stop",
         "_pools.pop"),),
        why="stop pops the named pool from its registry: a replayed stop "
            "finds nothing and answers stopped=False, never stopping a "
            "pool that a later lm_serve rebuilt under the same name twice"),
    IdemVerb("train_stop", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "job.stop()"),
        ("idunno_tpu_torch/engine/train_job.py", "LMTrainJob.stop",
         "_stop.set()"),
        # manager-side: the stop intent is journaled before the node call
        ("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager.train_stop",
         "stop_requested"),),
        why="a stop sets the job's stop event and the manager's journaled "
            "stop_requested flag; setting either again is a no-op, so a "
            "retried stop leaves the same stopped job and checkpoint"),
    IdemVerb("profile", "natural", anchors=(
        ("idunno_tpu_torch/serve/control.py",
         "ControlService._dispatch", "log_dir"),
        # one trace a process: a duplicate arriving mid-window raises
        ("idunno_tpu_torch/utils/tracing.py", "trace", "_active_trace"),),
        why="profile writes one new trace file into its log directory and "
            "touches no serving state; a duplicate that lands inside the "
            "window is refused by the one-trace-a-process rule, one after "
            "it records a second file beside the first"),
)

GUARDED = (
    Guard("idunno_tpu_torch/serve/control.py", "ControlService", "_reg_lock",
          ("_lm_loops", "_train_jobs", "_lm_idem", "_lms")),
    Guard("idunno_tpu_torch/serve/failover.py", "FailoverManager", "_lock",
          ("_seq", "_received", "_received_seq", "_wal", "_scale_wal",
           "_pool_wal", "_pool_wal_bytes")),
    Guard("idunno_tpu_torch/membership/epoch.py", "ScopeOwners", "_lock",
          ("_map",)),
    Guard("idunno_tpu_torch/membership/health.py", "HealthLedger", "_lock",
          ("_peers", "_remote")),
    Guard("idunno_tpu_torch/serve/inference_service.py", "InferenceService",
          "_results_lock", ("_results", "_qnum", "_idem")),
    Guard("idunno_tpu_torch/serve/inference_service.py", "InferenceService",
          "_jobs_lock", ("_jobs", "_pending_results")),
    Guard("idunno_tpu_torch/serve/lm_manager.py", "LMPoolManager", "_lock",
          ("_pools", "_jobs", "_groups", "_wal_shipped")),
    Guard("idunno_tpu_torch/store/sdfs.py", "FileStoreService", "_meta_lock",
          ("_put_idem", "_versions")),
)

RETRY_SAFE = (
    RetrySite("idunno_tpu_torch/serve/inference_service.py",
              "InferenceService._master_call", verbs=("submit",),
              why="every mutating payload routed here carries the submit "
                  "idempotency key; reads are naturally idempotent"),
    RetrySite("idunno_tpu_torch/store/sdfs.py", "FileStoreService._master_call",
              verbs=("put",),
              why="put carries the keyed idem; get/ls/stat are reads and "
                  "delete is a tombstone overwrite, idempotent by shape"),
    RetrySite("idunno_tpu_torch/chaos.py", "ChaosCluster._client_control",
              verbs=("lm_submit", "train_start", "lm_serve"),
              why="harness client path mirrors real clients: mutating "
                  "verbs carry idem keys threaded by the workload"),
    RetrySite("idunno_tpu_torch/serve/lm_manager.py",
              "LMPoolManager._handoff_ship", verbs=("kv_handoff",),
              why="kv_handoff is naturally idempotent: a replayed ship "
                  "re-probes the decode depth and adopt grafts dedupe "
                  "against blocks already held, converging on one state"),
)


# idempotent READ verbs that may tail-hedge. A new verb joins
# this table only with a sentence explaining why a duplicated, concurrent
# read converges — then a HEDGE_SAFE row names each call site.
HEDGE_VERBS = (
    HedgeVerb("lm_poll",
              why="poll delivery is at-most-once per completion and the "
                  "hedged caller merges the losing reply via on_late, so "
                  "a doubled poll neither loses nor double-delivers rows"),
    HedgeVerb("prefix_probe",
              why="probe is a pure read (ring STATs of content-addressed "
                  "names); it mutates nothing so concurrent duplicates "
                  "are trivially exactly-once"),
    HedgeVerb("sdfs_stat",
              why="STAT is a pure metadata read; masters max-merge "
                  "versions/tombstones so two replies can only disagree "
                  "transiently and the caller takes either"),
)

HEDGE_SAFE = (
    HedgeSite("idunno_tpu_torch/store/sdfs.py", "FileStoreService.stat",
              verbs=("sdfs_stat", "prefix_probe"),
              why="stat hedges its pure STAT read across the master "
                  "chain; cluster_prefix probe/publish ride this same "
                  "read so prefix_probe is covered at the store layer"),
    HedgeSite("idunno_tpu_torch/utils/lm_bench.py", "_gray_hedged_poll",
              verbs=("lm_poll",),
              why="the gray-suite client hedges lm_poll across two ring "
                  "hosts and merges the losing reply's completions via "
                  "on_late before counting delivered rows"),
)


def default() -> Contracts:
    from idunno_tpu_torch.analysis.allowlist import ALLOWLIST
    return Contracts(
        fence_targets=FENCE_TARGETS,
        stamp_targets=STAMP_TARGETS,
        determinism_targets=DETERMINISM_TARGETS,
        idem_verbs=IDEM_VERBS,
        guarded=GUARDED,
        retry_safe=RETRY_SAFE,
        allowlist=tuple(ALLOWLIST),
        hedge_verbs=HEDGE_VERBS,
        hedge_safe=HEDGE_SAFE,
    )
