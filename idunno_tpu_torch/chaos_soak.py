"""Chaos soak driver: N seeded fault schedules, ONE JSON line out.

The port's counterpart of ``tools/chaos_soak.py``: exactly one JSON object
on stdout regardless of outcome, so a cron/CI wrapper can append it to a
ledger; exit 0 only when every schedule held its invariants. Each schedule
is an independent ``idunno_tpu_torch.chaos.run_seeded_schedule`` (full
in-process cluster — 5 hosts by default, 50-100 via `--hosts` for the sharded
control-plane certification — seeded drop/dup/delay + partitions/
isolations, convergence + invariant check); a schedule that trips an
invariant is recorded, not raised.

    python -m idunno_tpu_torch.chaos_soak --schedules 25 --steps 40 --seed0 1
    python -m idunno_tpu_torch.chaos_soak --schedules 20 --hosts 50
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile

from idunno_tpu_torch.chaos import run_seeded_schedule

# the checkout's root: the determinism preflight lints idunno_tpu_torch/
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m idunno_tpu_torch.chaos_soak")
    ap.add_argument("--schedules", type=int, default=10)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed0", type=int, default=1)
    ap.add_argument("--drop", type=float, default=0.05)
    ap.add_argument("--dup", type=float, default=0.03)
    ap.add_argument("--delay", type=float, default=0.10)
    # chunked-prefill spec for schedule 0 (0 disables); see chaos.py
    ap.add_argument("--prefill-chunk", type=int, default=2)
    # tensor-parallel spec for schedule 0 (1 disables): the managed fake
    # pool carries n_model in its journaled lm_serve spec, so failover
    # replays a TP pool under the same fault surface
    ap.add_argument("--n-model", type=int, default=2)
    # replica-group autoscaler for schedule 1 (0 disables): scripted
    # overload→underload pressure makes the loop spawn AND retire under
    # the fault surface; the scaling journal joins the invariant checks
    ap.add_argument("--autoscale", type=int, default=1)
    # cluster size per schedule: the sharded control plane is
    # certified at 50-100 hosts with `--hosts 50`; default stays 5 so
    # the fast soak keeps its historical runtime
    ap.add_argument("--hosts", type=int, default=5)
    # cluster prefix cache for schedule 2 (0 disables): the shared-head
    # workload publishes real KVC1 blobs to the real SDFS ring, with
    # inline wrong-token / double-prefill checks on every fetch
    ap.add_argument("--cluster-prefix", type=int, default=1)
    # DistServe handoff group for schedule 3 (0 disables): role-split
    # replicas ship real KVC1 block chains between the fake loops with
    # journaled prefilling→shipping→adopted edges; death-mid-handoff
    # faults must replay or fall back, never lose or double a request
    ap.add_argument("--distserve", type=int, default=1)
    # gray-failure schedule for schedule 4 (0 disables): one scripted
    # limping host (synthesized latency, heartbeats alive) under the
    # full fault surface + the autoscale group so quarantine-and-drain
    # has replicas to move; invariants: quarantine fires with zero
    # false LEAVEs, zero lost/doubled requests through the drain,
    # probation heals every ledger post-clear
    ap.add_argument("--fail-slow", type=int, default=1)
    # second concurrent managed pool from schedule 5 on (schedule 4 when
    # --fail-slow 0; 0 disables): per-pool fence scopes + cross-pool
    # isolation under the fault surface (schedules 0-4 keep their
    # single-feature seeds replayable)
    ap.add_argument("--multi-pool", type=int, default=1)
    # lint preflight on by default: a wall-clock/rng draw in a chaos-
    # reachable module makes every printed seed unreplayable, so soaking
    # such a tree produces failure records nobody can debug
    ap.add_argument("--no-preflight", action="store_true",
                    help="skip the determinism-lint preflight")
    args = ap.parse_args(argv)
    logging.disable(logging.WARNING)   # wal-skip warnings are expected

    if not args.no_preflight:
        from idunno_tpu_torch.analysis import run_analysis
        pre = run_analysis(ROOT, checkers=["determinism"])
        if pre["findings"]:
            # refuse to soak: seeds would not replay. Same ONE-JSON-line
            # contract — the refusal IS the soak result.
            print(json.dumps({
                "suite": "chaos_soak", "schedules": 0, "passed": 0,
                "preflight": "determinism_lint_failed",
                "violations": [f.to_wire() for f in pre["findings"][:20]]}))
            return 1

    passed, failures = 0, []
    worst_convergence = 0.0
    epochs_total = 0
    quarantines_seen = 0
    # (seed, kwargs, digest) of the autoscale schedule: replayed once
    # after the loop to assert the Holt forecast (predicted_rate on
    # every autoscaler decision) reproduces bit-for-bit from the seed
    forecast_probe = None
    pool_epochs: dict[str, int] = {}
    # ownership ledger: the final rendezvous owner per scope
    # (last schedule's converged claim map wins — same scopes recur
    # across schedules) and the total ownership handoffs observed. The
    # owner-SPREAD invariant (multi-pool scopes land on >=2 distinct
    # hosts) is asserted inside every schedule's check_invariants.
    owner_moves_total = 0
    scope_owners: dict[str, str] = {}
    work = {"cnn_acked": 0, "lm_acked": 0, "lmb_acked": 0,
            "lmp_acked": 0, "sdfs_acked": 0, "spans_recorded": 0,
            "prefix_remote_hits": 0, "prefix_published": 0,
            "prefix_warmed": 0, "lmh_acked": 0, "handoff_routed": 0,
            "handoff_blocks_shipped": 0, "handoff_blocks_adopted": 0}
    multi_pool_from = 5 if args.fail_slow else 4
    for i in range(args.schedules):
        seed = args.seed0 + i
        kwargs = dict(
            steps=args.steps,
            chaos={"drop": args.drop, "dup": args.dup,
                   "delay": args.delay, "seed": seed},
            # first schedule runs the managed pool with chunked
            # prefill AND a TP shape in its journaled spec:
            # deferred completions + replayed
            # n_model under the same fault surface
            prefill_chunk=args.prefill_chunk if i == 0 else 0,
            n_model=args.n_model if i == 0 else 1,
            # second schedule runs the autoscaled replica group
            # — separate from schedule 0 so each
            # feature's faults replay in isolation by seed. The gray
            # schedule rides the group too: quarantine-and-drain
            # needs replicas to drain
            autoscale=bool(args.autoscale) and i == 1
            or bool(args.fail_slow) and i == 4,
            # third schedule runs the cluster prefix cache:
            # ring-published KV chains fetched back
            # under the fault surface, content-checked inline
            cluster_prefix=bool(args.cluster_prefix) and i == 2,
            # fourth schedule runs the DistServe handoff group:
            # KV-block ships between role-split
            # replicas, journaled + replayed under faults
            distserve=bool(args.distserve) and i == 3,
            # fifth schedule runs the gray-failure fault:
            # scripted limping host + fleet-sampling prober
            fail_slow=bool(args.fail_slow) and i == 4,
            # later schedules run TWO concurrent managed pools:
            # per-pool fences + cross-pool isolation
            multi_pool=bool(args.multi_pool) and i >= multi_pool_from,
            n_hosts=args.hosts)
        try:
            with tempfile.TemporaryDirectory() as d:
                out = run_seeded_schedule(seed, d, **kwargs)
        except Exception as e:  # noqa: BLE001 - invariant trip is data
            rec = {"seed": seed, "error":
                   f"{type(e).__name__}: {e}"[:300]}
            dump = getattr(e, "span_dump", None)
            if dump:
                # chaos-causal dump: which traces were live on each host
                # when the invariant tripped (replay with this seed and
                # export the full dump as a timeline)
                rec["span_dump"] = {
                    h: {"spans": len(spans),
                        "traces": sorted({s["trace_id"] for s in spans})[:8]}
                    for h, spans in dump.items()}
            failures.append(rec)
            continue
        passed += 1
        worst_convergence = max(worst_convergence, out["convergence_s"])
        epochs_total += out["epochs"]
        quarantines_seen += int(bool(out.get("quarantine_seen")))
        if kwargs["autoscale"] and out.get("grp_decision_digest"):
            forecast_probe = (seed, kwargs,
                              out["grp_decision_digest"])
        for scope, e in out.get("pool_epochs", {}).items():
            pool_epochs[scope] = max(pool_epochs.get(scope, 0), int(e))
        owner_moves_total += int(out.get("owner_moves", 0))
        scope_owners.update(out.get("scope_owners", {}))
        for k in work:
            work[k] += out.get(k, 0)
    # forecast determinism: replay the autoscale
    # schedule's seed and require the identical decision journal —
    # every predicted_rate the Holt filter stamped must reproduce, or
    # the printed seeds are not debuggable
    forecast = {}
    if forecast_probe is not None:
        seed, kwargs, digest = forecast_probe
        try:
            with tempfile.TemporaryDirectory() as d:
                redo = run_seeded_schedule(seed, d, **kwargs)
            deterministic = redo.get("grp_decision_digest") == digest
        except Exception as e:  # noqa: BLE001 - replay trip is data
            deterministic = False
            failures.append({"seed": seed, "error":
                             f"forecast replay: {type(e).__name__}: "
                             f"{e}"[:300]})
        forecast = {"forecast_digest": digest,
                    "forecast_deterministic": deterministic}
        if not deterministic and not any(
                f.get("seed") == seed for f in failures):
            failures.append({"seed": seed,
                             "error": "forecast replay digest mismatch"})
    print(json.dumps({
        "suite": "chaos_soak", "schedules": args.schedules,
        "steps": args.steps, "hosts": args.hosts, "passed": passed,
        "violations": failures,
        "epochs_minted_total": epochs_total,
        "pool_epochs": pool_epochs,
        "scope_owners": scope_owners,
        "owner_moves": owner_moves_total,
        "worst_convergence_s": round(worst_convergence, 3),
        "quarantines_seen": quarantines_seen,
        **forecast, **work}))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
