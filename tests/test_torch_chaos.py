"""Seeded chaos suite: the epoch-fenced control plane under deterministic
fault schedules (idunno_tpu_torch/chaos.py).

Every test is seconds-bounded: the membership clock is fake (suspicion is
schedule-driven), the LM tier is a deterministic stand-in, and the only
real time spent is the convergence loop's 20 ms sleeps. The reference
could only exercise failover by hand-killing VMs; its fencing-free
promotion (`mp4_machinelearning.py:956-963`) would fail the ≤1-acting-
master-per-epoch invariant here on the first coordinator isolation.
"""
from __future__ import annotations

import pytest

from idunno_tpu_torch.chaos import ChaosCluster, lm_tokens, run_seeded_schedule

# three distinct seeds, two of which (1, 3) drive schedules that depose
# the coordinator and mint a new epoch; 2 stays on the bootstrap chain —
# the invariants must hold on both kinds of history
SEEDS = (1, 2, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_schedule_invariants(seed, tmp_path):
    out = run_seeded_schedule(seed, str(tmp_path), steps=40)
    # the schedule must have produced real work to certify anything
    assert out["cnn_acked"] + out["lm_acked"] + out["sdfs_acked"] >= 5
    # acked work on the surviving lineage completed exactly once
    assert out["cnn_survived"] <= out["cnn_acked"]
    assert out["sdfs_survived"] <= out["sdfs_acked"]


def test_directed_coordinator_isolation(tmp_path):
    """The directed schedule: isolate the coordinator from
    every peer, let the standby promote and mint an epoch, submit on BOTH
    sides of the partition, heal — the deposed coordinator must come back
    fenced, with zero stale-epoch verbs accepted anywhere and all
    surviving work exactly-once."""
    c = ChaosCluster(101, str(tmp_path))
    # one replication cycle so the standby's snapshot includes the LM pool
    c.pump_work()
    c.op_isolate("n0")
    # 0.3 s waves push the majority side past the 2 s suspicion timeout:
    # n1 marks n0 LEAVE, adopts, and mints epoch 1
    for _ in range(10):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    assert c.members["n1"].is_acting_master
    assert c.members["n1"].epoch.view() == (1, "n1")
    # the isolated coordinator still *thinks* it is master (bootstrap
    # epoch 0: it cannot know better) — submissions on both sides
    assert c.members["n0"].is_acting_master      # doomed lineage
    for client in ("n0", "n2", "n3"):
        c.op_cnn(client)
        c.op_lm(client)
        c.op_sdfs(client)
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    c.converge()
    summary = c.check_invariants()
    # fencing: gossip deposed n0 — it routes to n1 and never acts again
    assert summary["final_master"] == "n1"
    assert not c.members["n0"].is_acting_master
    assert c.members["n0"].epoch.view() == (1, "n1")
    # both sides acted as master during the partition — but under
    # DIFFERENT epochs; per-epoch uniqueness is what fencing guarantees
    assert c.acting_by_epoch.get(0) == {"n0"}
    assert c.acting_by_epoch.get(1) == {"n1"}
    assert not c.violations
    # majority-side work survived; n0-side acks were doomed-lineage
    assert summary["cnn_survived"] >= 2
    assert summary["sdfs_survived"] >= 2


def test_heavy_chaos_with_failover(tmp_path):
    """Probabilistic drop/dup/delay on every link plus the seeded fault
    schedule: the strongest setting the suite certifies."""
    out = run_seeded_schedule(7, str(tmp_path), steps=40,
                              chaos={"drop": 0.08, "dup": 0.05,
                                     "delay": 0.15, "seed": 7})
    assert out["epochs"] >= 1        # seed 7 deposes the coordinator


def test_cnn_submit_retry_after_lost_ack_books_once(tmp_path):
    """Client idempotency end-to-end: the submit ACK is dropped AFTER the
    master booked the query; the transport retry re-sends the same key and
    must get the ORIGINAL qnum back — exactly one booking."""
    c = ChaosCluster(202, str(tmp_path))
    c.net.lose_next_reply("n2", "n0")
    q = c.services["n2"].submit_query("idem-model", 100, 119)
    master = c.services["n0"]
    booked = [k for k in master.scheduler.book._by_query
              if k[0] == "idem-model"]
    assert booked == [("idem-model", q)]
    c.converge()
    names = [r[0] for r in master.results("idem-model", q)]
    assert sorted(names) == sorted(f"test_{i}.JPEG" for i in range(100, 120))


def test_lm_submit_retry_and_lost_forward_dedupe(tmp_path):
    """Two lost-ACK shapes on the LM path: (a) client retries lm_submit
    with the same idempotency key → same rid, one journal entry; (b) the
    master's forward to the pool node loses its reply → the pump
    re-forwards under the same node-side key → the node decodes once."""
    c = ChaosCluster(303, str(tmp_path))
    # the pool's journal lives on its rendezvous scope owner (n4 for
    # pool:chaos-lm over n0..n4), not on the cluster master
    mgr = c.managers["n4"]
    # (a) client-side: same key twice → same rid, single journal row
    p = {"verb": "lm_submit", "name": c.LM_POOL,
         "prompt": [9, 9, 9], "max_new": 4, "seed": 9}
    first = c._client_control("n3", dict(p), idem="n3:k1")
    again = c._client_control("n3", dict(p), idem="n3:k1")
    assert again["id"] == first["id"]
    with mgr._lock:
        pool = mgr._pools[c.LM_POOL]
        node = pool["node"]
        assert len(pool["requests"]) == 1
    # (b) node-side: lose the forward's reply; the pump's re-forward must
    # hit the node's dedupe, not decode a second copy
    c.net.lose_next_reply("n4", node)
    c._client_control("n3", {"verb": "lm_submit", "name": c.LM_POOL,
                             "prompt": [8, 8, 8], "max_new": 4,
                             "seed": 8}, idem="n3:k2")
    c.converge()
    got = c.drain_lm()
    keys = [tuple(t["tokens"]) for t in got]
    assert len(keys) == len(set(keys)) == 2
    assert tuple(lm_tokens([8, 8, 8], 8, 4)) in keys


def test_sdfs_put_retry_after_lost_ack_writes_once(tmp_path):
    """SDFS put idempotency: the PUT ACK is dropped after replicas wrote;
    the retry must return the ORIGINAL version — not write (and version)
    the blob twice."""
    c = ChaosCluster(404, str(tmp_path))
    c.net.lose_next_reply("n4", "n0")
    v = c.stores["n4"].put_bytes("once.bin", b"exactly-once")
    version, _hosts = c.stores["n2"].stat("once.bin")
    assert version == v == 1
    blob, got_v = c.stores["n3"].get_bytes("once.bin")
    assert blob == b"exactly-once" and got_v == v


def test_autoscale_seeded_schedule_invariants(tmp_path):
    """The full seeded schedule with the replica-group workload on:
    scripted overload→underload pressure makes the autoscaler spawn and
    retire mid-chaos, and the scaling journal joins the invariant
    surface (strictly-increasing decision seqs, fenced epochs, no
    double-spawn, zero admitted-request loss)."""
    out = run_seeded_schedule(909, str(tmp_path), steps=40,
                              autoscale=True)
    assert out["grp_decisions"] >= 2      # at least serve-spawn + one more
    assert out["grp_replicas"] >= 1


def test_autoscale_partition_mid_scale_out(tmp_path):
    """Autoscale directed schedule: overload until the autoscaler
    journals a scale-out, isolate the master MID-scale-out (before the
    decision could finish replicating), let the standby adopt, then
    flip to underload under the new master. The adopted scaling state
    must replay exactly: no replica double-spawned across the adoption,
    the scale-in drains before retiring, and every admitted group
    request survives with exactly-once delivery."""
    c = ChaosCluster(515, str(tmp_path), autoscale=True)
    c.pump_work()        # replication cycle: standby snapshot has the group
    c.group_pressure = 5.0
    for client in ("n2", "n3", "n4"):
        c.op_lm_group(client)
    for _ in range(6):   # dwell_s=1.0 at 0.3 s waves: scale-out lands
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    g0 = c.managers["n0"]._groups[c.LM_GROUP]
    spawns0 = [d["replica"] for d in g0["decisions"]
               if d["action"] == "spawn"]
    assert len(spawns0) >= 2, spawns0    # initial replica + scale-out
    # mid-scale-out: the master drops off the network before the next
    # replication; the standby adopts from snapshot + scale WAL
    c.op_isolate("n0")
    for _ in range(10):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    assert c.members["n1"].is_acting_master
    # scoped adoption: the group's scope rendezvous-places on
    # n3 among the survivors (order n0→n3→n4→… for pool:chaos-grp), so
    # n3 — not the new cluster master — replays the scale WAL and owns
    # the group from here
    g1 = c.managers["n3"]._groups.get(c.LM_GROUP)
    assert g1 is not None, "adoption lost the replica group"
    # new-master lineage continues: more admissions, then underload so
    # the loop drains a replica and retires it with zero loss
    for client in ("n2", "n3"):
        c.op_lm_group(client)
    c.group_pressure = 0.0
    for _ in range(10):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    c.converge()
    summary = c.check_invariants()
    assert summary["final_master"] == "n1"
    assert not c.violations
    # the survivor's journal kept scaling after adoption (retire of the
    # overload-era replica, or fresh decisions) without ever reusing a
    # replica name — the no-double-spawn invariant inside
    # check_invariants covers the journal; spot-check the epochs moved
    g1 = c.managers[c._pool_owner(c.LM_GROUP)]._groups[c.LM_GROUP]
    eps = [int(d["epoch"][0]) for d in g1["decisions"]]
    assert eps and eps[-1] >= 1, eps     # post-adoption decisions fenced
    assert summary["grp_acked"] >= 2


def test_fail_slow_quarantine_drain_and_probation(tmp_path):
    """Gray-failure directed schedule: one group-replica host limps 10x
    (synthesized latency — its heartbeats flow the whole time). The
    differential plane must QUARANTINE it within the policy window with
    ZERO false LEAVEs, the autoscaler must drain-and-replace its replica
    with zero lost/doubled requests, and once the fault clears probation
    must heal every ledger back to all-healthy."""
    c = ChaosCluster(616, str(tmp_path), autoscale=True, fail_slow=True)
    c.pump_work()        # replication cycle: standby snapshot has the group
    for client in ("n2", "n3", "n4"):
        c.op_lm_group(client)
    for _ in range(3):   # claims + initial verdict-free gossip settle
        c.pump_membership(waves=1)
        c.pump_work()
    owner = c._pool_owner(c.LM_GROUP)
    mgr = c.managers[owner]
    with mgr._lock:
        replica = sorted(mgr._groups[c.LM_GROUP]["replicas"])[0]
        victim = mgr._pools[replica]["node"]
    # override the scripted choice: the directed fault targets the host
    # actually serving a group replica, so the drain path has real work
    c.slow_victim = victim
    c.slow_prober = prober = "n2" if victim != "n2" else "n3"
    c.net.slow_host(victim, 10.0)
    for _ in range(14):
        c.probe_sweep(prober)
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
        c._sample_fail_slow()
        # gray, not fail-stop: NO datagram chaos in this schedule, so
        # the victim must never leave anyone's alive view, not even once
        for h in c.cfg.hosts:
            assert victim in c.members[h].members.alive_hosts(), \
                f"{h} forged a LEAVE for the limping {victim}"
    assert c.saw_quarantine
    assert c.members[prober].health.state(victim) == "quarantined"
    # quarantine-and-drain (autoscaler step 1b): the owner's tick must
    # have journaled a replacement spawn AND a drain of the victim's
    # replica, both stamped quarantine=True
    with mgr._lock:
        decisions = [dict(d) for d in
                     mgr._groups[c.LM_GROUP]["decisions"]]
    q_spawns = [d for d in decisions
                if d["action"] == "spawn" and d.get("quarantine")]
    q_drains = [d for d in decisions
                if d["action"] == "retire_start" and d.get("quarantine")]
    assert q_spawns and q_spawns[0].get("replaced") == replica
    assert q_drains and q_drains[0]["replica"] == replica
    # work keeps landing mid-drain (the draining replica still delivers
    # its journal; new admissions route to healthy replicas only)
    c.op_lm_group("n3")
    c.pump_work()
    # fault clears -> probe-driven probation heals WITHOUT converge's
    # help: monitor_once keeps probing watched peers, samples decay
    c.net.clear_slow(victim)
    for _ in range(25):
        c.pump_membership(waves=1)
        c.pump_work()
        if all(not c.members[h].health.watched() for h in c.cfg.hosts):
            break
    assert c.members[prober].health.state(victim) == "healthy"
    c.converge()
    summary = c.check_invariants()     # zero lost/doubled through drain
    assert summary["quarantine_seen"]
    assert not c.violations
    for h in c.cfg.hosts:
        assert c.members[h].health.state(victim) == "healthy"


def test_multi_pool_seeded_schedule_invariants(tmp_path):
    """Two concurrent managed pools under the full seeded fault surface:
    per-pool fence scopes, cross-pool delivery attribution, and the
    ring-RF invariant all hold."""
    out = run_seeded_schedule(11, str(tmp_path), steps=40,
                              multi_pool=True)
    assert out["lm_acked"] + out["lmb_acked"] >= 2
    assert out["hosts"] == 5


def test_pool_fence_cross_pool_isolation(tmp_path):
    """Multi-pool directed schedule: the two pools have DISTINCT
    rendezvous owners (pool:chaos-lm → n4; pool:chaos-lmB → n0, which is
    also the cluster master). Isolating n0 deposes the cluster master
    AND pool B's owner in one stroke — pool B's scope adopts at its
    rendezvous successor n3 with an exactly-once journal replay, while
    pool A's owner n4 keeps serving UNINTERRUPTED: its scope fence never
    moves, its ownership never changes hands, and its node tier sees
    zero resubmission. Blast radius = exactly the dead owner's scopes."""
    c = ChaosCluster(616, str(tmp_path), multi_pool=True)
    c.pump_work()        # replication cycle: per-scope WALs shipped
    # in-flight work on BOTH pools before the fault
    for client in ("n2", "n3"):
        c.op_lm(client)
        c.op_lm_b(client)
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    # pool A (chaos-lm) lives on surviving owner n4: snapshot its
    # node-side submit counter so post-fault resubmission would show
    mgr4 = c.managers["n4"]
    with mgr4._lock:
        a_node = mgr4._pools[c.LM_POOL]["node"]
        a_reqs0 = dict(mgr4._pools[c.LM_POOL]["requests"])
    a_next0 = c.controls[a_node]._loops[c.LM_POOL]["next"]
    assert all(r["status"] == "done" for r in a_reqs0.values()), a_reqs0
    # depose the cluster master = pool B's owner; pool A's owner survives
    c.op_isolate("n0")
    for _ in range(10):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    assert c.members["n1"].is_acting_master
    # ONLY pool B's scope fence minted (scoped adoption at successor n3);
    # pool A's fence never moved — its owner was never deposed
    scopes1 = dict(c.members["n1"].scopes.view_all())
    assert scopes1.get(f"pool:{c.LM_POOL_B}", [0])[0] >= 1
    assert scopes1.get(f"pool:{c.LM_POOL}", [0, None])[0] == 0
    assert c.managers["n3"].has_pool(c.LM_POOL_B), \
        "pool B's journal did not adopt at its scope successor"
    assert c.members["n1"].owners.owner(f"pool:{c.LM_POOL}") == "n4"
    # new-lineage work on both pools, then converge + full invariants
    for client in ("n2", "n4"):
        c.op_lm(client)
        c.op_lm_b(client)
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    c.converge()
    summary = c.check_invariants()
    assert summary["final_master"] == "n1"
    assert not c.violations
    # zero resubmission into pool A's node tier: every pre-fault pool-A
    # request was already done and its owner was never deposed — the
    # node-side rid counter moved only for NEW submissions
    a_next1 = c.controls[a_node]._loops[c.LM_POOL]["next"]
    assert a_next1 - a_next0 == summary["lm_acked"] - len(a_reqs0)
    # pool B's scope minted by the adoption; pool A's never did, and the
    # ownership map moved only for the dead owner's scope
    assert summary["pool_epochs"][f"pool:{c.LM_POOL_B}"] >= 1
    assert f"pool:{c.LM_POOL}" not in summary["pool_epochs"]
    assert summary["scope_owners"][f"pool:{c.LM_POOL_B}"] == "n3"
    assert summary["scope_owners"][f"pool:{c.LM_POOL}"] == "n4"


def test_scope_owner_death_blast_radius(tmp_path):
    """Scope-ownership acceptance schedule: three managed scopes spread over two
    distinct owners (pool:chaos-lm → n4; pool:chaos-lmB and pool:chaos-grp
    → n0, the cluster master). Kill the NON-master owner n4 — only its
    scope adopts (at rendezvous successor n1), the cluster fence never
    moves, the surviving owners' pools serve uninterrupted with zero
    resubmission and zero fence movement, and the dead owner comes back
    fenced for exactly its old scope."""
    c = ChaosCluster(717, str(tmp_path), multi_pool=True, autoscale=True)
    c.pump_work()        # replication cycle: per-scope WALs shipped
    # the placement the whole test hangs on: two distinct owners
    assert c.expected_owners == {f"pool:{c.LM_POOL}": "n4",
                                 f"pool:{c.LM_POOL_B}": "n0",
                                 f"pool:{c.LM_GROUP}": "n0"}
    for client in ("n1", "n2"):
        c.op_lm(client)
        c.op_lm_b(client)
        c.op_lm_group(client)
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    # surviving pool B: snapshot its node tier so resubmission would show
    mgr0 = c.managers["n0"]
    with mgr0._lock:
        b_node = mgr0._pools[c.LM_POOL_B]["node"]
        b_reqs0 = dict(mgr0._pools[c.LM_POOL_B]["requests"])
    b_next0 = c.controls[b_node]._loops[c.LM_POOL_B]["next"]
    assert all(r["status"] == "done" for r in b_reqs0.values()), b_reqs0
    epoch0 = c.members["n0"].epoch.view()
    # isolate the owner of pool:chaos-lm — NOT the cluster master
    c.op_isolate("n4")
    for _ in range(10):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    # cluster mastership never moved: the death was not the master's
    assert c.members["n0"].is_acting_master
    assert c.members["n0"].epoch.view() == epoch0
    # ONLY the dead owner's scope adopted — at its successor n1, which
    # now holds the journal and the minted scope fence
    assert c.managers["n1"].has_pool(c.LM_POOL), \
        "dead owner's pool did not adopt at its scope successor"
    assert c.members["n0"].owners.owner(f"pool:{c.LM_POOL}") == "n1"
    assert c.members["n0"].owners.owner(f"pool:{c.LM_POOL_B}") == "n0"
    assert c.members["n0"].owners.owner(f"pool:{c.LM_GROUP}") == "n0"
    scopes0 = dict(c.members["n0"].scopes.view_all())
    assert scopes0.get(f"pool:{c.LM_POOL}", [0])[0] >= 1
    assert scopes0.get(f"pool:{c.LM_POOL_B}", [0, None])[0] == 0
    assert scopes0.get(f"pool:{c.LM_GROUP}", [0, None])[0] == 0
    # surviving scopes keep serving mid-outage, uninterrupted
    for client in ("n2", "n3"):
        c.op_lm(client)
        c.op_lm_b(client)
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    c.converge()
    summary = c.check_invariants()
    assert summary["final_master"] == "n0"
    assert not c.violations
    # zero resubmission into the surviving pool's node tier: every
    # pre-fault pool-B request was done before the fault, so the
    # node-side rid counter moved only for NEW submissions
    b_next1 = c.controls[b_node]._loops[c.LM_POOL_B]["next"]
    assert b_next1 - b_next0 == summary["lmb_acked"] - len(b_reqs0)
    # exactly one ownership move (the dead owner's scope), none else
    assert summary["owner_moves"] == 1
    assert summary["scope_owners"][f"pool:{c.LM_POOL}"] == "n1"
    assert f"pool:{c.LM_POOL_B}" not in summary["pool_epochs"]
    assert f"pool:{c.LM_GROUP}" not in summary["pool_epochs"]


def test_forwarded_owner_hop_relays_typed_errors(tmp_path):
    """when a forwarded pool verb's owner answers
    with a TYPED error, the forwarding node must relay the payload
    VERBATIM — `scope`/`scope_owner` (deposed holder) and `stale_epoch`
    markers survive the proxy hop instead of flattening to a ValueError
    string the client can't route on. Exercises the relay class now
    SHARED with serve/control.py (`RelayedError`)."""
    from idunno_tpu_torch.comm.message import Message
    from idunno_tpu_torch.membership.epoch import pool_scope
    from idunno_tpu_torch.utils.types import MessageType

    c = ChaosCluster(717, str(tmp_path), multi_pool=True)
    c.pump_work()
    for _ in range(4):            # claims need ~3 gossip waves
        c.pump_membership(waves=1)

    def ask(forwarder: str, name: str) -> Message:
        # raw client send (no redirect-following helper): the reply we
        # inspect is exactly what the FORWARDER relayed
        return c.net._nodes["n2"].call(
            forwarder, "control",
            Message(MessageType.INFERENCE, "n2",
                    {"verb": "lm_stats", "name": name}))

    # -- deposed holder: scope/scope_owner markers through the hop -------
    scope = pool_scope(c.LM_POOL)
    owner = c.members["n1"].owners.owner(scope)
    assert owner is not None and c.managers[owner].has_pool(c.LM_POOL)
    forwarder = next(h for h in c.cfg.hosts
                     if h != owner and not c.managers[h].has_pool(c.LM_POOL))
    # out-claim the scope in the HOLDER's own view: it steps down and
    # answers the typed redirect — which must reach the client intact
    usurper = next(h for h in c.cfg.hosts if h != owner and h != forwarder)
    c.members[owner].owners.claim(scope, usurper)
    out = ask(forwarder, c.LM_POOL)
    assert out.type is MessageType.ERROR
    assert out.payload.get("scope") == scope, out.payload
    assert out.payload.get("scope_owner") == usurper, out.payload
    assert "ValueError" not in out.payload.get("error", "")

    # -- stale cluster epoch: stale_epoch marker through the hop ---------
    scope_b = pool_scope(c.LM_POOL_B)
    owner_b = c.members["n1"].owners.owner(scope_b)
    assert owner_b is not None and c.managers[owner_b].has_pool(c.LM_POOL_B)
    fwd_b = next(h for h in c.cfg.hosts
                 if h != owner_b and not c.managers[h].has_pool(c.LM_POOL_B))
    # the owner's fence runs ahead of the forwarder's view, so the
    # forwarder's stamped hop is rejected stale — typed, and relayed
    cur, _ = c.members[owner_b].epoch.view()
    c.members[owner_b].epoch.observe(cur + 3, "n1")
    out = ask(fwd_b, c.LM_POOL_B)
    assert out.type is MessageType.ERROR
    assert out.payload.get("stale_epoch") is True, out.payload
    assert "ValueError" not in out.payload.get("error", "")


def test_invariant_trip_snapshots_span_dump(tmp_path):
    """Chaos-causal dumps: when any invariant trips, `check_invariants`
    snapshots every host's span window BEFORE re-raising, so the failing
    request's trace is in hand without re-running the schedule (the soak
    driver surfaces the same dump per failure record)."""
    c = ChaosCluster(818, str(tmp_path))
    # register the attempt like op_lm would: the delivery-vs-attempted
    # invariant must see this hand-rolled submit as legitimate
    c.lm_attempted.append({"serial": 0, "prompt": [1, 2, 3],
                           "seed": 1, "max_new": 4})
    root = c.spans["n3"].start("client.lm_submit")
    out = c._client_control(
        "n3", {"verb": "lm_submit", "name": c.LM_POOL,
               "prompt": [1, 2, 3], "max_new": 4, "seed": 1,
               "trace": [root.trace_id, root.span_id]}, idem="n3:dump1")
    c.spans["n3"].finish(root, rid=int(out["id"]))
    c.converge()
    assert c.check_invariants()["final_master"] == "n0"
    assert c.last_span_dump is None, "clean pass takes no snapshot"
    # forge a double delivery of exactly that request's token stream
    key = tuple(lm_tokens([1, 2, 3], 1, 4))
    c.lm_delivered[key] = 2
    with pytest.raises(AssertionError, match="delivered 2x"):
        c.check_invariants()
    dump = c.last_span_dump
    assert dump is not None and set(dump) == set(c.cfg.hosts)
    traces = {s["trace_id"] for spans in dump.values() for s in spans}
    assert root.trace_id in traces, \
        "dump names the failing request's trace"
    # both the client hop (n3) and the journal booking — on the pool's
    # scope OWNER (n4), not the master — are in the snapshot under that
    # one trace
    assert any(s["name"] == "client.lm_submit" for s in dump["n3"])
    assert any(s["name"] == "lm.submit"
               and s["trace_id"] == root.trace_id for s in dump["n4"])

def test_cluster_prefix_seeded_schedule_invariants(tmp_path):
    """The full seeded fault surface with the cluster prefix cache on
   : the shared-head workload publishes real KVC1 blobs to
    the real SDFS ring and the fake tier's inline content checks
    (wrong-token graft, double-prefill) feed the violations ledger.
    Remote hits here depend on WHEN the schedule re-places the pool
    relative to the last shared-head submission (recovery paces on the
    watchdog, which runs in real time during converge) — the directed
    test below proves the remote hit deterministically, so this one
    asserts only the published chain and a clean ledger."""
    out = run_seeded_schedule(11, str(tmp_path), steps=40,
                              cluster_prefix=True)
    assert out["lmp_acked"] >= 1
    assert out["prefix_published"] >= 3      # the 3-block shared head


def test_cluster_prefix_survives_serving_node_death(tmp_path):
    """Cluster-prefix directed schedule: publish the shared head, kill the
    serving node (its radix tree dies with it), and prove the re-placed
    pool re-derives the chain from the ring — probe shows local 0 /
    remote 3, a submission-or-warm under drop chaos fetches without ever
    grafting a wrong token or double-prefilling (inline content checks
    land in c.violations), and the clean-net warm completes the head."""
    c = ChaosCluster(828, str(tmp_path), cluster_prefix=True)
    c.pump_work()        # replication cycle: the pool spec rides the WAL
    for client in ("n1", "n2"):
        c.op_lm_prefix(client)
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    # the head's 3 blocks are published AND locally cached on the node
    probe = c._client_control("n3", {
        "verb": "prefix_probe", "name": c.LM_POOL,
        "tokens": list(c.PREFIX_HEAD)})
    assert probe["remote_blocks"] == 3
    assert probe["local_blocks"] == 3
    owner0 = c._pool_owner(c.LM_POOL)
    with c.managers[owner0]._lock:
        node0 = c.managers[owner0]._pools[c.LM_POOL]["node"]
    # kill the serving node: peer-detected death + scope adoption +
    # recovery lm_serve need ~15 pump rounds
    c.op_isolate(node0)
    for _ in range(15):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    owner1 = c._pool_owner(c.LM_POOL)
    with c.managers[owner1]._lock:
        node1 = c.managers[owner1]._pools[c.LM_POOL]["node"]
    assert node1 != node0, "pool never re-placed off the dead node"
    # the rebuilt node's radix tree is EMPTY; the ring still has the head
    probe = c._client_control("n3", {
        "verb": "prefix_probe", "name": c.LM_POOL,
        "tokens": list(c.PREFIX_HEAD)})
    assert probe["local_blocks"] == 0, "tree should have died with node0"
    assert probe["remote_blocks"] == 3, "published chain lost from ring"
    # death-mid-fetch shape: drop chaos on every link while the fresh
    # node fetches — a partial fetch must degrade (shorter hit, more
    # prefill), NEVER corrupt; inline checks would append violations
    c.net.set_chaos(drop=0.25, seed=99)
    c.op_lm_prefix("n3")
    c.pump_membership(waves=1)
    c.pump_work()
    c.record_fences()
    c.net.clear_chaos()
    c.net.flush_held()
    # clean-net warm from the tenant's published set completes the head
    c._client_control("n3", {"verb": "prefix_fetch",
                             "name": c.LM_POOL, "tenant": "default"})
    probe = c._client_control("n3", {
        "verb": "prefix_probe", "name": c.LM_POOL,
        "tokens": list(c.PREFIX_HEAD)})
    assert probe["local_blocks"] == 3, "warm did not complete the head"
    c.converge()
    summary = c.check_invariants()
    assert not c.violations
    # the head reached the rebuilt node from the RING, one way or the
    # other: an admission remote hit (counted per admission) and/or warm
    # blocks — the local==3 probe above already proved it arrived
    assert (summary.get("prefix_remote_hits", 0) >= 1
            or summary.get("prefix_warmed", 0) >= 1)
    assert summary["lmp_acked"] >= 2


# -- DistServe KV handoff --------------------------------------


def _dsg_view(c):
    """(owner, {role: replica}, {replica: node}) for the distserve group,
    read from whichever manager holds its journal right now — the
    claimed owner in a survivor's gossiped view wins over a deposed
    holder's stale journal."""
    from idunno_tpu_torch.membership.epoch import pool_scope
    claim = c.members["n0"].owners.owner(pool_scope(c.LM_GROUP_D))
    hosts = (([claim] if claim else [])
             + [h for h in c.cfg.hosts if h != claim])
    owner = next(h for h in hosts
                 if c.LM_GROUP_D in c.managers[h]._groups)
    mgr = c.managers[owner]
    with mgr._lock:
        g = mgr._groups[c.LM_GROUP_D]
        roles = {m["role"]: r for r, m in g["replicas"].items()}
        nodes = {r: (mgr._pools.get(r) or {}).get("node")
                 for r in g["replicas"]}
    return owner, roles, nodes


def _dsg_handoff_states(c):
    """{rid: handoff state} over every replica pool of the group."""
    owner, _, _ = _dsg_view(c)
    mgr = c.managers[owner]
    out = {}
    with mgr._lock:
        g = mgr._groups[c.LM_GROUP_D]
        for r in g["replicas"]:
            pool = mgr._pools.get(r)
            if pool is None:
                continue
            for rid, q in pool["requests"].items():
                hop = q.get("handoff")
                if hop:
                    out[(r, rid)] = hop["state"]
    return out


def test_distserve_seeded_schedule_invariants(tmp_path):
    """The full seeded fault surface with the role-split handoff group on
   : long-prompt submissions route in handoff mode, the
    manager journals prefilling→shipping→adopted edges and ships real
    KVC1 blobs between the fake loops. Exactly-once delivery and
    terminal handoff states are asserted inside check_invariants; this
    seed is known to exercise real ships, not just fallbacks."""
    out = run_seeded_schedule(1, str(tmp_path), steps=40, distserve=True)
    assert out["lmh_acked"] >= 1
    assert out["handoff_routed"] >= 1
    assert out["handoff_blocks_shipped"] >= 3     # at least one real ship


def test_distserve_lost_ship_ack_replays_delta_only(tmp_path):
    """A ship whose reply is lost (handler RAN — the decode node holds
    the blocks — but the manager saw a timeout) must replay, and the
    replay's probe must see the full chain and ship NOTHING (delta-only:
    the dedupe that makes kv_handoff naturally idempotent). The request
    reaches exactly one terminal state either way."""
    c = ChaosCluster(901, str(tmp_path), distserve=True)
    owner, roles, nodes = _dsg_view(c)
    pre_node = nodes[roles["prefill"]]
    dec_node = nodes[roles["decode"]]
    assert pre_node != dec_node, "placement colocated; seed unusable"
    # the ship RPC is owner -> prefill node: lose its reply once
    c.net.lose_next_reply(owner, pre_node)
    c.op_lm_handoff("n2")
    states = _dsg_handoff_states(c)
    assert list(states.values()) == ["adopted"], states
    # the handler ran exactly once worth of adopts: 3 blocks, not 6
    dec_loop = c.controls[dec_node]._loops[roles["decode"]]
    assert dec_loop["adopted"] == 3, dec_loop["adopted"]
    c.converge()
    summary = c.check_invariants()
    assert summary["lmh_acked"] == 1
    assert summary["handoff_blocks_adopted"] == 3


def test_distserve_prefill_unreachable_falls_back(tmp_path):
    """Death-of-prefill-endpoint mid-handoff: the prefill node cannot
    reach the decode node, so the ship's adopt RPC dies after retries →
    the manager journals the FALLBACK edge (decode-side prefill) and the
    request still completes exactly once after heal — never lost, never
    doubled, no blocks grafted on the decode side."""
    c = ChaosCluster(902, str(tmp_path), distserve=True)
    owner, roles, nodes = _dsg_view(c)
    pre_node = nodes[roles["prefill"]]
    dec_node = nodes[roles["decode"]]
    assert pre_node != dec_node, "placement colocated; seed unusable"
    c.net.partition(pre_node, dec_node)
    c.op_lm_handoff("n2")
    states = _dsg_handoff_states(c)
    assert list(states.values()) == ["fallback"], states
    dec_loop = c.controls[dec_node]._loops[roles["decode"]]
    assert dec_loop["adopted"] == 0, "fallback must not graft blocks"
    c.converge()
    summary = c.check_invariants()
    assert summary["lmh_acked"] == 1
    # delivered exactly once through the decode-side prefill path
    assert summary["lm_delivered"] >= 1


def test_distserve_death_of_prefill_node_mid_schedule(tmp_path):
    """Kill the host serving the PREFILL replica (which here also owns
    the group's journal — the harder variant: scope adoption + pool
    re-placement + handoff replay all ride the same death). A post-death
    handoff submission must still reach exactly one terminal state on
    the adopted journal."""
    c = ChaosCluster(903, str(tmp_path), distserve=True)
    # claims need ~3 gossip waves to reach every node BEFORE the death,
    # or the survivors have no scope to adopt; one work pump ships WALs
    c.pump_membership(waves=3)
    c.pump_work()
    owner0, roles0, nodes0 = _dsg_view(c)
    pre_node = nodes0[roles0["prefill"]]
    assert pre_node == owner0, "seed expectation: prefill colocated " \
        "with the journal owner (the harder death)"
    c.op_isolate(pre_node)
    # peer-detected death + scope adoption + re-place: ~15 pump rounds
    for _ in range(15):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    owner1, roles1, nodes1 = _dsg_view(c)
    assert owner1 != owner0, "scope never adopted off the dead owner"
    assert all(n != pre_node for n in nodes1.values() if n), nodes1
    c.op_lm_handoff("n2")
    for _ in range(3):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    states = _dsg_handoff_states(c)
    assert states and all(s in ("adopted", "fallback")
                          for s in states.values()), states
    c.converge()
    summary = c.check_invariants()
    assert summary["lmh_acked"] == 1


def test_distserve_death_of_decode_node_mid_handoff(tmp_path):
    """Kill the decode node AFTER the blocks were shipped and adopted but
    BEFORE the completion is delivered: re-placement resets the journaled
    handoff state (the new node holds no blocks), recovery re-ships to
    the new node, and the request completes exactly once — the shipped
    chain dies with the node, the request does not."""
    c = ChaosCluster(904, str(tmp_path), distserve=True)
    c.pump_work()
    owner, roles, nodes = _dsg_view(c)
    pre_node = nodes[roles["prefill"]]
    dec_node = nodes[roles["decode"]]
    assert pre_node != dec_node, "placement colocated; seed unusable"
    c.op_lm_handoff("n2")
    states = _dsg_handoff_states(c)
    assert list(states.values()) == ["adopted"], states
    # completion is parked on dec_node's loop, undelivered: kill it now
    c.op_isolate(dec_node)
    for _ in range(15):
        c.pump_membership(waves=1)
        c.pump_work()
        c.record_fences()
    owner1, roles1, nodes1 = _dsg_view(c)
    new_dec = nodes1[roles1["decode"]]
    assert new_dec != dec_node, "decode pool never re-placed"
    c.converge()
    summary = c.check_invariants()
    assert summary["lmh_acked"] == 1
    # the ledger proves exactly-once even though two loops completed the
    # request (only the re-placed node's journal delivers)
    states = _dsg_handoff_states(c)
    assert all(s in ("adopted", "fallback") for s in states.values())


def test_soak_entry_point_one_json_line():
    """``python -m idunno_tpu_torch.chaos_soak``: one JSON line, exit 0
    when every schedule holds its invariants (the determinism-lint
    preflight over the port included)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "idunno_tpu_torch.chaos_soak",
         "--schedules", "1", "--steps", "12"],
        cwd=root, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout + out.stderr
    d = json.loads(lines[0])
    assert d["suite"] == "chaos_soak"
    assert d["passed"] == 1 and d["violations"] == []
    assert out.returncode == 0
