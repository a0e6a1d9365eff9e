"""Node assembly — the per-host runtime (SURVEY.md C15).

The reference's ``Server`` object wires all state in ``__init__``
(`mp4_machinelearning.py:115-160`) and ``run()`` spawns ~13 daemon threads
(`:1270-1334`). Here a ``Node`` composes the layered services over one
transport and runs four periodic loops (heartbeat, failure monitor,
straggler monitor + metadata replication, worker job pump). Loops are
plain-step methods on the services, so tests drive them synchronously and
only the real runtime sleeps.

A port of ``idunno_tpu/serve/node.py``. The node has one device
(``device``, the card unless the caller passes ``device="cpu"``; no card
raises): its engine runs the CNN queries there, and the control service
loads every LM it generates with or serves onto it.
"""
from __future__ import annotations

import threading
import time

import torch

from idunno_tpu_torch.comm.transport import Transport
from idunno_tpu_torch.config import ClusterConfig, EngineConfig
from idunno_tpu_torch.engine.inference import InferenceEngine, resolve_device
from idunno_tpu_torch.grep.loggrep import LogGrepService
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.serve.control import ControlService
from idunno_tpu_torch.serve.failover import FailoverManager
from idunno_tpu_torch.serve.inference_service import InferenceService
from idunno_tpu_torch.serve.lm_manager import LMPoolManager
from idunno_tpu_torch.serve.metrics import MetricsTracker
from idunno_tpu_torch.store.sdfs import FileStoreService
from idunno_tpu_torch.utils.logging import setup_node_logging
from idunno_tpu_torch.utils.spans import SpanStore


class Node:
    def __init__(self, host: str, config: ClusterConfig,
                 transport: Transport, data_dir: str,
                 engine=None, engine_config: EngineConfig | None = None,
                 dataset_root: str | None = None,
                 log_dir: str | None = None,
                 device: str | torch.device | None = None) -> None:
        self.host = host
        # the node's device: the given one, else the given engine's, else
        # the card
        self.device = resolve_device(
            device if device is not None
            else getattr(engine, "device", None))
        self.config = config
        self.transport = transport
        self.log = setup_node_logging(host, log_dir or data_dir)
        # per-node span ring buffer: always on (Dapper-style), bounded
        # memory, read back via the spans_dump / trace / metrics_export
        # verbs (utils/spans.py)
        self.spans = SpanStore(host)
        self.membership = MembershipService(host, config, transport)
        # attach the differential-health ledger to the transport: every
        # reliable call from this node now feeds per-peer latency/error
        # EWMAs (gray-failure defense; membership/health.py)
        transport.health = self.membership.health
        self.store = FileStoreService(host, config, transport,
                                      self.membership, data_dir)
        self.store.spans = self.spans
        if engine is None:
            engine = InferenceEngine(engine_config or EngineConfig(),
                                     device=self.device, store=self.store)
        self.engine = engine
        self.metrics = MetricsTracker()
        self.inference = InferenceService(host, config, transport,
                                          self.membership, engine,
                                          metrics=self.metrics,
                                          dataset_root=dataset_root)
        self.inference.spans = self.spans
        self.lm_manager = LMPoolManager(host, config, transport,
                                        self.membership, self.inference)
        self.lm_manager.spans = self.spans
        self.failover = FailoverManager(host, config, transport,
                                        self.membership, self.inference,
                                        lm_manager=self.lm_manager)
        # submit-path write-ahead: an acked query survives an immediate
        # coordinator death (see InferenceService._master_submit)
        self.inference.wal_hook = self.failover.wal_append
        # scaling-decision write-ahead: an autoscaler action the master
        # just journaled survives an immediate coordinator death too
        # (serve/lm_manager.py:_replicate_scale → wal_scale)
        self.lm_manager.failover = self.failover
        self.grep = LogGrepService(host, config, transport, self.membership,
                                   log_dir or data_dir)
        self.control = ControlService(self)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.membership.join()
        loops = [
            ("heartbeat", self._heartbeat_loop),
            ("monitor", self._monitor_loop),
            ("master-duties", self._master_loop),
            ("worker", self._worker_loop),
        ]
        warmup = getattr(getattr(self.engine, "config", None),
                         "warmup_models", ())
        if warmup and hasattr(self.engine, "warmup"):
            loops.append(("warmup", lambda: self._warmup(warmup)))
        for name, fn in loops:
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"{self.host}-{name}")
            t.start()
            self._threads.append(t)
        self.log.info("node %s started", self.host)

    def _warmup(self, models) -> None:
        """Load and run the configured models before the first job arrives
        (the worker loop still serves: jobs for a still-loading model
        block on the engine's load lock)."""
        for name in models:
            if self._stop.is_set():
                return
            try:
                secs = self.engine.warmup(name)
                self.log.info("warmed %s in %.1fs", name, secs)
            except Exception as e:  # noqa: BLE001 - warmup must not kill node
                self.log.warning("warmup %s failed: %s", name, e)

    def stop(self) -> None:
        self._stop.set()
        self.control.close()          # continuous-batching decode loops
        for t in self._threads:
            t.join(timeout=2.0)
        self.transport.close()
        self.log.info("node %s stopped", self.host)

    def leave(self) -> None:
        """Voluntary leave (shell command 4)."""
        self.membership.leave()

    # -- loops ------------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            self.membership.ping_once()
            time.sleep(self.config.ping_interval_s)

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            self.membership.monitor_once()
            time.sleep(self.config.ping_interval_s)

    def _master_loop(self) -> None:
        """Straggler re-dispatch + standby metadata replication, both 1 Hz
        (`:809-830, 971-987`)."""
        while not self._stop.is_set():
            # each duty isolated: one raising must not take down the
            # others (a dead master loop = no straggler re-dispatch, no
            # LM pump, no standby replication — silent loss of the
            # cluster's guarantees)
            for duty in (self.inference.monitor_stragglers_once,
                         self.lm_manager.pump_once,
                         self.failover.replicate_once):
                try:
                    duty()
                except Exception:  # noqa: BLE001 - loop must stay alive
                    self.log.exception("master duty %s failed",
                                       getattr(duty, "__name__", duty))
            time.sleep(self.config.metadata_interval_s)

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            if self.inference.wait_for_jobs(timeout=0.2):
                self.inference.process_jobs_once()
