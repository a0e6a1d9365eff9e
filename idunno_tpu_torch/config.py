"""Cluster and runtime configuration.

The reference hardcodes its whole topology: a 10-VM hostname ring and IP map
(`utils.py:57-61, 70-92`), coordinator IPs edited by hand (`README.md:10-16`,
`mp4_machinelearning.py:47-48`), ports derived from a username (`:29-42`), and
scheduling knobs as module constants (`:44-46, 56-57`). Here all of that is a
dataclass, loadable from JSON or the environment, with zero hardcoded
addresses.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class PortConfig:
    """One UDP port for membership datagrams and TCP ports per control-plane
    service (reference: five fixed ports, `mp4_machinelearning.py:29-42`)."""

    membership: int = 18700
    store: int = 18710
    inference: int = 18720
    result: int = 18730
    metadata: int = 18740
    grep: int = 18750

    def offset(self, delta: int) -> "PortConfig":
        """Shift every port by ``delta`` — lets many nodes share one machine
        (the in-process/loopback test clusters)."""
        return PortConfig(**{f.name: getattr(self, f.name) + delta
                             for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class ClusterConfig:
    """Static cluster topology + protocol knobs.

    ``hosts`` is the orderd host registry (the ring). The reference's
    equivalents: `get_all_hosts` (`utils.py:57-61`), `COORDINATOR_IP` /
    `STANDBY_COORDINATOR_IP` (`mp4_machinelearning.py:47-48`),
    `INTRODUCER_HOST` (`utils.py:4`).
    """

    hosts: tuple[str, ...] = tuple(f"node{i}" for i in range(10))
    coordinator: str = "node0"
    standby_coordinator: str = "node1"
    introducer: str = "node0"
    ports: PortConfig = field(default_factory=PortConfig)

    # Failure detection (reference: 0.3 s ping loop `mp4_machinelearning.py:199`,
    # 2 s suspicion timeout `:847`).
    ping_interval_s: float = 0.3
    failure_timeout_s: float = 2.0

    # File store (reference: 4-5 ring replicas, `utils.py:48-55`).
    replication_factor: int = 4

    # Scheduler (reference: RATE_FACTOR=10 `mp4_machinelearning.py:44`,
    # straggler threshold 30 s `:812`).
    rate_factor: int = 10
    straggler_timeout_s: float = 30.0
    # re-dispatch caps: past max_task_retries STRAGGLER moves (worker
    # alive, task never finishes) or max_task_moves TOTAL moves (also
    # counting crash/transport churn — bounds a job that kills its
    # workers), the task is marked permanently FAILED and surfaced via
    # query_failed instead of bouncing between workers forever
    max_task_retries: int = 3
    max_task_moves: int = 12

    # Query pump (reference: batch 400, 1 query / 20 s,
    # `mp4_machinelearning.py:45-46, 1104-1109`).
    query_batch_size: int = 400
    query_interval_s: float = 20.0

    # Failover metadata replication period (reference: 1 Hz, `:971-987`).
    metadata_interval_s: float = 1.0

    # Control-plane RPC retry: bounded exponential backoff + jitter under
    # a deadline (comm/retry.py). Retries are exactly-once because the
    # mutating verbs (submit / lm_submit / SDFS put) carry client
    # idempotency keys deduped server-side. Small on purpose — this layer
    # rides out blips; real failover is the caller's primary→standby loop.
    rpc_retry_attempts: int = 3
    rpc_retry_base_s: float = 0.02
    rpc_retry_cap_s: float = 0.25
    rpc_retry_deadline_s: float = 2.0

    # LM fair-share slot resizes (serve/lm_manager.py): minimum seconds
    # between APPLIED in-place resizes of one pool. A resize is a full
    # rebuild (recompile + in-flight requeue), so a service rate hovering
    # on a share boundary must not thrash the pool. A config field so
    # operators can tune dwell without code edits.
    lm_resize_dwell_s: float = 30.0

    # Closed-loop autoscaler defaults (serve/autoscaler.py) — per-group
    # policy overrides ride the `autoscale={...}` lm_serve spec; these
    # seed `AutoscalePolicy.from_config`.
    #
    # Scale-OUT trigger: interactive p95 queue wait above this slack is
    # a Clockwork-style SLO breach — the system, not the operator, must
    # add capacity (Gujarati et al., OSDI 2020).
    autoscale_deadline_slack_s: float = 1.0
    # Scale-IN safety: a draining replica is retired only after its
    # journal is fully delivered AND this window has elapsed since the
    # retire_start decision — late pollers and in-flight drains land
    # before the pool disappears (zero admitted-request loss).
    autoscale_drain_window_s: float = 10.0
    # Replica-count bounds per group. min is the floor scale-in respects
    # (≥1: a group never scales to zero); max caps spawn decisions so a
    # runaway gauge cannot eat the cluster.
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 4
    # Minimum seconds between scaling DECISIONS per group (spawn /
    # retire_start / rebalance): replica builds recompile and tenants
    # re-home, so gauge noise must not flap capacity — the autoscaler's
    # analogue of lm_resize_dwell_s.
    autoscale_dwell_s: float = 15.0

    # Differential health scoring (membership/health.py): fail-SLOW
    # detection beside the fail-stop detector. A peer whose RPC-latency
    # EWMA exceeds deviation_factor × the fleet median (and the absolute
    # floor — nothing breaches on microsecond noise) while still
    # heartbeat-alive walks healthy → suspect → quarantined; these seed
    # `HealthPolicy.from_config`.
    health_deviation_factor: float = 3.0
    health_floor_s: float = 0.02
    health_min_samples: int = 5
    # sustained-breach window before suspect escalates to quarantined,
    # and the clean dwell probation must hold before re-admitting
    health_suspect_window_s: float = 1.0
    health_probation_s: float = 2.0
    # error-rate EWMA breach (transport errors / calls)
    health_error_rate: float = 0.5

    # Tail-hedged reads (comm/retry.py:call_hedged): a HEDGE_SAFE read
    # not answered within hedge_delay_s fires a duplicate to the next
    # chain host and takes the first reply. OFF by default — hedge
    # threads would interleave the chaos harness's seeded rng draws, so
    # only real deployments and the gray bench opt in.
    hedge_reads: bool = False
    hedge_delay_s: float = 0.05

    # Early straggler re-dispatch: a task whose worker the health ledger
    # marks SUSPECT/QUARANTINED re-dispatches after this fraction of
    # straggler_timeout_s instead of waiting the full window.
    straggler_early_frac: float = 0.25

    def __post_init__(self) -> None:
        for name in ("coordinator", "standby_coordinator", "introducer"):
            host = getattr(self, name)
            if host not in self.hosts:
                raise ValueError(f"{name}={host!r} is not in hosts")
        if len(set(self.hosts)) != len(self.hosts):
            raise ValueError("duplicate hosts in registry")

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    def ring_index(self, host: str) -> int:
        return self.hosts.index(host)

    def ring_successors(self, host: str) -> list[str]:
        """All other hosts in ring order starting after ``host`` (the
        reference's `get_replica_neighbors`, `utils.py:30-39`)."""
        i = self.ring_index(host)
        n = self.n_hosts
        return [self.hosts[(i + k) % n] for k in range(1, n)]

    @classmethod
    def from_json(cls, path: str) -> "ClusterConfig":
        with open(path) as f:
            raw = json.load(f)
        if "ports" in raw:
            raw["ports"] = PortConfig(**raw["ports"])
        if "hosts" in raw:
            raw["hosts"] = tuple(raw["hosts"])
        return cls(**raw)

    @classmethod
    def from_env(cls) -> "ClusterConfig":
        """Load from ``IDUNNO_CONFIG`` (a JSON path) or fall back to the
        default local topology."""
        path = os.environ.get("IDUNNO_CONFIG")
        if path:
            return cls.from_json(path)
        return cls()


PREPROCESS_MODES = ("auto", "fold", "kernel", "plain")


@dataclass(frozen=True)
class EngineConfig:
    """Model-engine knobs: the replacement for the reference's per-task
    torch.hub reload + batch=1 loop (`alexnet_resnet.py:17-22, 67`).

    ``preprocess`` names the uint8 → normalized path. The modes are the JAX
    package's ``auto|fold|pallas|xla`` under names that mean something on
    a GPU:

        auto   → the JAX package's ``auto``: ``kernel`` on CUDA, ``plain``
                 on the CPU (the JAX package's TPU fold default came from a
                 TPU trace and does not carry over)
        fold   → ``fold``: the normalize affine folded into the stem conv
                 (``models/stem_fold.py``); the model reads raw 0..255
        kernel → ``pallas``: the hand-written CUDA crop + normalize kernel
                 (``ops/preprocess_kernel.py``, ``csrc/preprocess.cu``)
        plain  → ``xla``: plain tensor ops (``ops/preprocess.py``)

    ``quantize`` takes only ``"none"``; int8 weights are still to port
    (ROADMAP.md)."""

    batch_size: int = 256           # device batch per forward
    image_size: int = 224           # crop fed to the model
    resize_size: int = 256          # canonical host-decoded size
    compute_dtype: str = "bfloat16"  # MXU-friendly
    param_dtype: str = "float32"
    # uint8→normalized preprocess: auto | fold | kernel | plain (see the
    # class docstring for what each means and its JAX-package name)
    preprocess: str = "auto"
    # "none" only: weight-only int8 is still to port (ROADMAP.md)
    quantize: str = "none"
    # ResNet stem as a space-to-depth 4x4/s1 conv (models/resnet.py
    # _S2DStem): same parameters and outputs, better MXU shape for the
    # 3-channel stride-2 stem; opt-in until measured on hardware
    stem_s2d: bool = False
    # models to load + compile in the background at node start, so the first
    # query doesn't pay the (remote) compile — the reference instead paid a
    # model download+load on EVERY task (`alexnet_resnet.py:17-22`) and its
    # second job took 40-49 s to start (BASELINE.md)
    warmup_models: tuple = ()

    def __post_init__(self) -> None:
        if self.preprocess not in PREPROCESS_MODES:
            raise ValueError(f"EngineConfig.preprocess={self.preprocess!r}: "
                             f"want {'|'.join(PREPROCESS_MODES)}")
        if self.quantize != "none":
            raise ValueError(
                f"EngineConfig.quantize={self.quantize!r}: only 'none' is "
                "ported so far; int8 weights are listed in ROADMAP.md")
        # JSON configs carry lists; keep the dataclass hashable/frozen-safe
        object.__setattr__(self, "warmup_models",
                           tuple(self.warmup_models))
