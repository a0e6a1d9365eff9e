"""The reviewed suppression ledger — every entry carries its why.

One ``Allow`` row per call site (checker, file, symbol, tag). Adding a row
is a code-review decision, not a lint chore: the justification must say
why the contract does not apply HERE, and a row that stops matching
anything becomes a finding itself (core.run_analysis), so the ledger can
never drift from the tree. Zero unexplained entries ship.
"""
from idunno_tpu_torch.analysis.contracts import Allow

ALLOWLIST = [
    # -- determinism-lint -------------------------------------------------
    Allow("determinism", "idunno_tpu_torch/serve/control.py",
          "ControlService._dispatch", "secrets.randbits",
          "the generate verb without a caller seed explicitly promises "
          "varied samples per RPC; chaos workloads always pass seed=, so "
          "this draw is unreachable under a seeded schedule"),
    Allow("determinism", "idunno_tpu_torch/serve/control.py",
          "ControlService._dispatch", "time.strftime",
          "names the profile-capture artifact directory after wall time; "
          "an observability filename, never journaled or replayed"),
    Allow("determinism", "idunno_tpu_torch/serve/inference_service.py",
          "InferenceService.join_reassign_dispatch", "time.monotonic",
          "bounds the real-thread join wait for re-dispatch workers at "
          "shutdown/adoption; a pure watchdog deadline that never lands "
          "in journaled state (chaos drives a fake-thread engine)"),
    Allow("determinism", "idunno_tpu_torch/store/sdfs.py",
          "FileStoreService.join_repair", "time.monotonic",
          "bounds the real-thread join wait for repair workers at "
          "shutdown; a pure watchdog deadline that never lands in "
          "journaled state (chaos drives repair synchronously)"),
    Allow("determinism", "idunno_tpu_torch/chaos.py", "ChaosCluster.converge",
          "time.monotonic",
          "the harness's own convergence stopwatch: it MEASURES the real "
          "cluster from outside the simulation; faults and workload stay "
          "on the seeded rng/fake clock"),

    # -- fence-check ------------------------------------------------------
    Allow("fence", "idunno_tpu_torch/serve/inference_service.py",
          "InferenceService._handle_result", "_handle_result",
          "worker results are valid at ANY epoch (membership/epoch.py): "
          "the handler observes the stamp — demoting us if the worker "
          "saw a higher fence — and the task book dedupes re-delivery; "
          "rejecting stale-stamped results would lose finished work"),

    # -- stamp-check ------------------------------------------------------
    Allow("stamp", "idunno_tpu_torch/serve/control.py",
          "ControlService._dispatch", "_dispatch",
          "metrics_export relay: read-only observability fan-out on "
          "behalf of a client; the reply is a Prometheus text page with "
          "no fence view to observe and nothing a deposed sender could "
          "corrupt"),
    Allow("stamp", "idunno_tpu_torch/serve/control.py",
          "ControlService._collect_trace", "_collect_trace",
          "trace assembly fans spans_dump to every member on behalf of a "
          "client; read-only, best-effort, and span buffers carry no "
          "fence state"),
]
