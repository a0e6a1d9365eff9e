"""The PyTorch port's serving path end to end on the CPU: an in-process
cluster of the port's control plane (``InProcNetwork``,
``MembershipService``, ``InferenceService`` with ``FairScheduler`` and
``MetricsTracker`` per host) around one shared port engine, as
tests/test_cluster_e2e.py assembles it for the JAX package — a two-model
query, a worker death with reassignment, and an engine failure that must
surface at the master instead of looping silently.
"""
import random

import pytest

from idunno_tpu_torch.comm.inproc import InProcNetwork
from idunno_tpu_torch.config import ClusterConfig, EngineConfig
from idunno_tpu_torch.engine.inference import InferenceEngine
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.scheduler.fair import FairScheduler
from idunno_tpu_torch.serve.inference_service import InferenceService
from idunno_tpu_torch.serve.metrics import MetricsTracker

from tests.test_membership import FakeClock, pump


@pytest.fixture(scope="module")
def shared_engine():
    """One engine shared by all nodes (same process; seeded weights, so
    every node classifies alike)."""
    return InferenceEngine(EngineConfig(batch_size=8, image_size=64,
                                        resize_size=64,
                                        compute_dtype="float32"),
                           device="cpu", seed=0)


@pytest.fixture
def cluster(shared_engine):
    cfg = ClusterConfig(hosts=("n0", "n1", "n2"), coordinator="n0",
                        standby_coordinator="n1", introducer="n0",
                        query_batch_size=32, query_interval_s=0.0)
    net = InProcNetwork()
    clock = FakeClock()
    members, services = {}, {}
    for h in cfg.hosts:
        t = net.transport(h)
        members[h] = MembershipService(h, cfg, t, clock=clock)
        services[h] = InferenceService(
            h, cfg, t, members[h], shared_engine,
            metrics=MetricsTracker(clock=clock),
            scheduler=FairScheduler(cfg, rng=random.Random(0), clock=clock),
            clock=clock)
    for h in cfg.hosts:
        members[h].join()
        clock.advance(0.01)
    pump(members, clock)
    return cfg, net, clock, members, services


def run_jobs(services, rounds=10):
    for _ in range(rounds):
        if sum(s.process_jobs_once() for s in services.values()) == 0:
            break


def names(lo, hi):
    return {f"test_{i}.JPEG" for i in range(lo, hi + 1)}


def test_two_model_query_matches_the_engine(cluster, shared_engine):
    """AlexNet and ResNet-18 time-share the cluster (the reference's
    headline demo); every record comes back, as the engine computes it."""
    cfg, net, clock, members, services = cluster
    qa = services["n2"].submit_query("alexnet", 0, 15)
    qr = services["n2"].submit_query("resnet", 0, 15)
    run_jobs(services, rounds=20)
    master = services["n0"]
    assert master.query_done("alexnet", qa)
    assert master.query_done("resnet", qr)
    for model, q in (("alexnet", qa), ("resnet", qr)):
        got = sorted(master.results(model, q))
        want = sorted(shared_engine.infer(model, 0, 15).records)
        assert [r[:2] for r in got] == [r[:2] for r in want]
        assert got == pytest.approx(want)
        assert all(0.0 <= r[2] <= 1.0 for r in got)
    assert master.weights_provenance() == {"alexnet": "random",
                                           "resnet": "random"}
    assert not master._task_errors


def test_worker_death_reassigns_its_tasks(cluster):
    cfg, net, clock, members, services = cluster
    qnum = services["n1"].submit_query("alexnet", 0, 30)
    master = services["n0"]
    victims = {t.worker for t in master.scheduler.book.in_flight()
               if t.worker not in ("n0", "n1")}
    # the seeded scheduler splits 31 images over all three workers
    assert victims == {"n2"}
    net.kill("n2")
    for h in ("n0", "n1"):
        services[h].process_jobs_once()
    pump(members, clock, waves=8, dt=0.3)
    members["n0"].monitor_once()
    master.join_reassign_dispatch()       # sends run on background threads
    run_jobs({h: s for h, s in services.items() if h != "n2"})
    assert master.query_done("alexnet", qnum)
    assert {r[0] for r in master.results("alexnet", qnum)} == names(0, 30)


def test_engine_failure_surfaces_at_the_master(cluster):
    """The service catches engine exceptions and re-dispatches; the
    master's error count is what shows a failing engine."""
    cfg, net, clock, members, services = cluster
    qnum = services["n2"].submit_query("vit", 0, 5)    # not in the registry
    run_jobs(services, rounds=30)
    master = services["n0"]
    assert master._task_errors.get("vit", 0) > 0
    assert master.query_failed("vit", qnum)
    assert not master.query_done("vit", qnum)
