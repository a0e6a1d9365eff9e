"""The port's control RPC (``serve/control.py``) on two started port
``Node``s over ``InProcNetwork``, everything on the CPU — the port of the
JAX package's ``tests/test_serving.py::test_control_rpc_verbs``, with the
port's engines instead of a stub, held against the JAX package:

- the SDFS verbs, ``inference``/``query_done``/``results`` and ``stats``:
  the records equal the JAX engine's on the same (published) weights;
- ``generate``: greedy tokens equal JAX ``generate``; ``beam_width=2``
  equals JAX ``beam_search`` (the same sequences, scores within
  SCORE_ATOL);
- ``lm_serve``/``lm_submit``/``lm_poll``/``lm_stats``/``lm_stop`` on a
  paged pool with the radix cache: greedy tokens equal JAX ``generate``;
- the cluster KV tier over the RPC: ``lm_serve`` with ``cluster_prefix``,
  ``prefix_publish``/``prefix_probe``/``prefix_fetch`` (by tokens and by
  tenant) and every ``kv_handoff`` op, ``ship`` included: greedy tokens
  equal JAX ``generate``; a managed replica group whose prefill replica
  hands KV to its decode replica through the master;
- ``train_start``/``train_status``/``train_stop``, a resume, then
  ``lm_serve``/``generate`` of the trained LM; a placed training job
  resumed on a survivor after its node dies;
- every verb of a module not ported yet answers with an error naming
  ROADMAP.md.

Small models, f32: ResNet-18 at 64² images, batch 8; the LM at dim 32,
depth 2, vocab 61, KV blocks of 2.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idunno_tpu.config import EngineConfig as JaxEngineConfig
from idunno_tpu.engine.generate import beam_search as jax_beam_search
from idunno_tpu.engine.generate import generate as jax_generate
from idunno_tpu.engine.inference import InferenceEngine as JaxEngine
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.parallel.mesh import local_mesh
from idunno_tpu_torch.comm.inproc import InProcNetwork
from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.config import ClusterConfig, EngineConfig
from idunno_tpu_torch.engine.data_lm import save_corpus
from idunno_tpu_torch.engine.generate import load_lm, lm_store_name, save_lm
from idunno_tpu_torch.models.convert import (lm_state_dict_from_flax,
                                             state_dict_from_flax)
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.serve.node import Node
from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload
from idunno_tpu_torch.utils.types import MessageType
from tests.torch_workers import share_cores  # noqa: F401

VOCAB, BS = 61, 2
SMALL = dict(batch_size=8, image_size=64, resize_size=64,
             compute_dtype="float32")
# records against the JAX engine's, f32 both sides
PROB_ATOL = 1e-4
# beam scores (sums of f32 log-probs over 6 steps) against the JAX ones
SCORE_ATOL = 1e-5


class _BlobStore:
    def put_bytes(self, name, blob):
        self.name, self.blob = name, blob
        return 1


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("control")
    cfg = ClusterConfig(hosts=("n0", "n1"), coordinator="n0",
                        standby_coordinator="n1", introducer="n0",
                        replication_factor=2, query_batch_size=50,
                        query_interval_s=0.0, ping_interval_s=0.05,
                        failure_timeout_s=2.0, metadata_interval_s=0.1)
    net = InProcNetwork()
    nodes = {h: Node(h, cfg, net.transport(h), str(root / h),
                     engine_config=EngineConfig(**SMALL), device="cpu")
             for h in cfg.hosts}

    def control(host, verb, ok=True, **kw):
        out = net.transport("client").call(
            host, "control",
            Message(MessageType.INFERENCE, "client", {"verb": verb, **kw}),
            timeout=60.0)
        assert out is not None
        want = MessageType.ACK if ok else MessageType.ERROR
        assert out.type is want, out.payload
        return out.payload

    try:
        for n in nodes.values():
            n.start()
        deadline = time.time() + 10.0
        while time.time() < deadline and not all(
                len(n.membership.members.alive_hosts()) == 2
                for n in nodes.values()):
            time.sleep(0.02)
        yield nodes, control
    finally:
        for n in nodes.values():
            n.stop()


@pytest.fixture(scope="module")
def lm():
    """The JAX LM, its params, and the port's blob of the same weights."""
    jm = JaxLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    cap = _BlobStore()
    save_lm(cap, "chat", tm)
    return jm, params, cap.blob


def test_control_rpc_verbs_match_jax_engine(cluster):
    nodes, control = cluster
    st = control("n0", "status")
    assert st["acting_master"] == "n0"
    assert sorted(st["members"]) == ["n0", "n1"]

    assert control("n1", "put_bytes", name="f.txt",
                   data="abc")["version"] == 1
    assert control("n0", "get_bytes", name="f.txt")["data"] == "abc"
    assert len(control("n0", "ls", name="f.txt")["hosts"]) == 2

    # n0 carries the JAX engine's weights and publishes them; n1 loads
    # them from the store
    jeng = JaxEngine(JaxEngineConfig(preprocess="xla", **SMALL),
                     mesh=local_mesh(), seed=0, pretrained=False)
    jeng.load("resnet")
    variables = jax.tree.map(np.asarray, jeng._models["resnet"].variables)
    src = nodes["n0"].engine
    src.load("resnet", state_dict=state_dict_from_flax("resnet", variables))
    src.publish_weights("resnet", allow_random=True)
    nodes["n1"].engine.load("resnet")
    assert nodes["n1"].engine.weights_provenance("resnet") == "store"

    q = control("n0", "inference", model="resnet", start=0, end=49)
    qnum = q["qnums"][0]
    deadline = time.time() + 60.0
    while time.time() < deadline and not control(
            "n0", "query_done", model="resnet", qnum=qnum)["done"]:
        time.sleep(0.05)
    res = control("n0", "results", model="resnet", qnum=qnum)
    assert len(res["records"]) == 50
    got = sorted(tuple(r) for r in res["records"])
    want = sorted(jeng.infer("resnet", 0, 49).records)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=0, atol=PROB_ATOL)

    stats = control("n0", "stats")
    assert stats["stats"]["resnet"]["finished_images"] == 50
    assert stats["stats"]["resnet"]["processing"] is not None


def test_generate_verb_matches_jax(cluster, lm):
    nodes, control = cluster
    jm, params, blob = lm
    control("n1", "put_bytes", name=lm_store_name("chat"),
            data=blob.decode("latin-1"))
    prompts = [[7, 3, 11, 5], [1, 2, 40, 9]]
    out = control("n0", "generate", name="chat", prompt=prompts, max_new=6)
    want = jax_generate(jm, params, jnp.asarray(prompts, jnp.int32),
                        prompt_len=4, max_new=6)
    assert out["tokens"] == np.asarray(want).tolist()

    beam = control("n1", "generate", name="chat", prompt=prompts, max_new=6,
                   beam_width=2)
    seqs, scores = jax_beam_search(jm, params, jnp.asarray(prompts, jnp.int32),
                                   prompt_len=4, max_new=6, beam_width=2)
    assert beam["tokens"] == np.asarray(seqs).tolist()
    np.testing.assert_allclose(beam["log_probs"], np.asarray(scores),
                               rtol=0, atol=SCORE_ATOL)

    # a seeded sample is reproducible over the wire
    a, b = (control("n0", "generate", name="chat", prompt=prompts,
                    max_new=6, temperature=0.8, seed=5)["tokens"]
            for _ in range(2))
    assert a == b and all(0 <= t < VOCAB for row in a for t in row)


def test_lm_pool_verbs_match_jax(cluster, lm):
    nodes, control = cluster
    jm, params, blob = lm
    control("n0", "put_bytes", name=lm_store_name("pool"),
            data=blob.decode("latin-1"))
    prompts, _, buckets = prefix_bench_workload(
        {"prompt_len": 8, "vocab": VOCAB, "slots": 2}, BS)
    out = control("n0", "lm_serve", name="pool", slots=2, prompt_len=8,
                  max_len=24, decode_steps=2, prompt_buckets=list(buckets),
                  kv_block_size=BS, kv_cache_blocks=12, paged_kernel="auto",
                  warmup=True)
    assert out == {"slots": 2}
    ids = [control("n0", "lm_submit", name="pool", prompt=p,
                   max_new=6)["id"] for p in prompts]
    done = {}
    deadline = time.time() + 60
    while time.time() < deadline and len(done) < len(ids):
        reply = control("n0", "lm_poll", name="pool")
        assert not reply.get("errors"), reply["errors"]
        for c in reply["completions"]:
            done[c["id"]] = c
        time.sleep(0.02)
    assert sorted(done) == sorted(ids)
    for rid, p in zip(ids, prompts):
        want = jax_generate(jm, params, jnp.asarray([p], jnp.int32),
                            prompt_len=len(p), max_new=6)
        assert done[rid]["tokens"] == np.asarray(want[0]).tolist(), rid
    st = control("n0", "lm_stats", name="pool")["stats"]
    assert st["completed"] == len(prompts)
    assert st["prefix_cache"]["hits"] > 0
    assert st["config"]["paged_kernel"] == "plain"
    assert control("n0", "lm_stop", name="pool")["stopped"]
    assert "no lm_serve pool" in control("n0", "lm_poll", ok=False,
                                         name="pool")["error"]


UNPORTED = [
    ("lm_serve", {"n_model": 2}),
    ("lm_serve", {"placement": "auto", "n_model": 2}),
]


@pytest.mark.parametrize("verb,extra", UNPORTED,
                         ids=[f"{v}-{'-'.join(e)}" for v, e in UNPORTED])
def test_unported_verbs_name_roadmap(cluster, lm, verb, extra):
    """``lm_serve`` with ``n_model: 2``, which raised naming ROADMAP.md
    before tensor parallelism was ported, now serves a TP pool over the
    CPU node's virtual mesh, node-local and cluster-managed alike: greedy
    streams equal JAX ``generate`` and the pool reports its n_model."""
    nodes, control = cluster
    jm, params, blob = lm
    name = "tp-" + "-".join(extra)
    control("n1", "put_bytes", name=lm_store_name(name),
            data=blob.decode("latin-1"))
    kw = dict({"name": name, "slots": 2, "prompt_len": 8, "max_len": 24},
              **extra)
    out = control("n0", verb, **kw)
    host = out.get("owner", "n0") if "placement" in extra else "n0"
    prompts = [[7, 3, 11, 5], [1, 2, 40, 9, 13]]
    ids = [control(host, "lm_submit", name=name, prompt=p,
                   max_new=6)["id"] for p in prompts]
    done = wait_done(control, host, name, ids)
    for rid, p in zip(ids, prompts):
        assert done[rid] == jax_tokens(jm, params, p, 6), rid
    if "placement" not in extra:
        cfg = control(host, "lm_stats", name=name)["stats"]["config"]
        assert cfg["n_model"] == 2 and cfg["tp_collective_bytes"] > 0
    assert control(host, "lm_stop", name=name)["stopped"]


def test_profile_verb_through_the_node(cluster, tmp_path):
    """The ``profile`` verb over the node's transport: a trace of the
    window under the caller's directory, or under the node's data dir
    (``profiles/<stamp>``); a window outside (0, 60] is a typed error."""
    nodes, control = cluster
    log_dir = str(tmp_path / "prof")
    assert control("n0", "profile", seconds=0.2, log_dir=log_dir) == {
        "log_dir": log_dir, "seconds": 0.2}
    assert any(f.endswith(".pt.trace.json.gz") for f in os.listdir(log_dir))
    out = control("n1", "profile", seconds=0.1)
    assert out["log_dir"].startswith(os.path.join(
        nodes["n1"].store.local.data_dir, "profiles"))
    assert os.listdir(out["log_dir"])
    for bad in (0, 61):
        err = control("n0", "profile", ok=False, seconds=bad)["error"]
        assert "ValueError" in err and "seconds" in err, err


def test_shell_drives_the_port_node(cluster, lm, tmp_path):
    """The copied shell over a port node: membership, the store, the
    distributed log grep, an LM pool whose greedy tokens equal JAX
    ``generate``, and a training job through ``train``/``train-status``/
    ``train-stop``."""
    from idunno_tpu_torch.cli.shell import Shell

    nodes, _ = cluster
    jm, params, blob = lm
    sh = Shell(nodes["n1"], out=lambda s: None, async_inference=False)
    assert "n0" in sh.dispatch("list_mem")
    assert "acting master: n0" in sh.dispatch("list_master")
    local = tmp_path / "lm.blob"
    local.write_bytes(blob)
    assert "version 1" in sh.dispatch(f"put {local} {lm_store_name('sh')}")
    # every node logged its start; both logs answer the grep
    out = sh.dispatch("grep started")
    assert "--- n0: " in out and "--- n1: " in out, out
    assert "slots" in sh.dispatch("lm-serve sh 8 24 slots=2 kv_block_size=2")
    prompt = [7, 3, 11]
    sh.dispatch("lm-submit sh 6 " + " ".join(map(str, prompt)))
    want = jax_generate(jm, params, jnp.asarray([prompt], jnp.int32),
                        prompt_len=3, max_new=6)
    line = " ".join(str(t) for t in np.asarray(want[0]))
    deadline, polled = time.time() + 30, ""
    while time.time() < deadline and "#0:" not in polled:
        polled = sh.dispatch("lm-poll sh")
        time.sleep(0.02)
    assert polled.startswith(f"#0: {line} (prompt_len=3"), polled
    assert "stopped" in sh.dispatch("lm-stop sh")
    save_corpus(nodes["n1"].store, "corpus/sh",
                np.tile(np.arange(17, dtype=np.int32), 40))
    assert "started" in sh.dispatch(
        "train shjob corpus/sh 4 vocab=32 dim=16 depth=1 num_heads=2 "
        "batch_size=2 seq_len=16 checkpoint_every=2")
    deadline, st = time.time() + 60, ""
    while time.time() < deadline and " done " not in st:
        st = sh.dispatch("train-status shjob")
        assert "ERROR" not in st, st
        time.sleep(0.05)
    assert st.startswith("shjob: step=4 ") and " done " in st, st
    assert "shjob" in sh.dispatch("train-stop shjob")


def test_managed_pool_through_the_master_matches_jax(cluster, lm):
    """A cluster-managed pool (``placement="auto"``, the copied
    ``serve/lm_manager.py``): the acting master places it (handing the
    pool's scope to its owner, whose manager journals the requests and
    relays them to the port's pool on the placed node); the greedy tokens
    equal JAX ``generate``."""
    nodes, control = cluster
    jm, params, blob = lm
    control("n1", "put_bytes", name=lm_store_name("managed"),
            data=blob.decode("latin-1"))
    out = control("n0", "lm_serve", name="managed", placement="auto",
                  slots=2, prompt_len=4, max_len=16)
    assert out["node"] in ("n0", "n1"), out
    # follow-up verbs go to the scope's owner (another node may not have
    # heard its claim yet)
    owner = out.get("owner", "n0")
    prompts = [[7, 3, 11, 5], [1, 2, 40, 9], [60, 0, 4, 4]]
    ids = [control(owner, "lm_submit", name="managed", prompt=p,
                   max_new=6)["id"] for p in prompts]
    done = {}
    deadline = time.time() + 60
    while time.time() < deadline and len(done) < len(ids):
        for c in control(owner, "lm_poll", name="managed")["completions"]:
            done[c["id"]] = c["tokens"]
        time.sleep(0.05)
    assert sorted(done) == sorted(ids)
    want = jax_generate(jm, params, jnp.asarray(prompts, jnp.int32),
                        prompt_len=4, max_new=6)
    assert [done[i] for i in ids] == np.asarray(want).tolist()
    st = control(owner, "lm_stats", name="managed")["stats"]
    assert st["journal"]["done"] == len(prompts), st
    assert control(owner, "lm_stop", name="managed")["stopped"]


def wait_done(control, host, name, ids, seconds=90.0):
    """Poll ``lm_poll`` until every id in ``ids`` completed; tokens by id."""
    done = {}
    deadline = time.time() + seconds
    while time.time() < deadline and not set(ids) <= set(done):
        reply = control(host, "lm_poll", name=name)
        assert not reply.get("errors"), reply["errors"]
        for c in reply["completions"]:
            done[c["id"]] = c["tokens"]
        time.sleep(0.02)
    assert set(ids) <= set(done), (sorted(done), ids)
    return done


def jax_tokens(jm, params, prompt, max_new):
    out = jax_generate(jm, params, jnp.asarray([prompt], jnp.int32),
                       prompt_len=len(prompt), max_new=max_new)
    return np.asarray(out[0]).tolist()


LONG = [4, 9, 14, 19, 24, 29, 34, 39]


def kv_pool(name, **kw):
    return dict(name=name, model="cp", slots=2, prompt_len=8, max_len=24,
                prompt_buckets=[2, 4, 8], kv_block_size=BS,
                kv_cache_blocks=16, paged_kernel="auto", warmup=True, **kw)


def test_cluster_prefix_verbs_over_rpc(cluster, lm):
    """``lm_serve`` with ``cluster_prefix`` on two nodes: the first pool
    publishes, the second (same stored LM, same namespace) probes the
    chain, admits with a remote hit and prefills only the suffix; a third
    pool warms by tenant and by tokens; an explicit publish converges.
    Every stream equals JAX ``generate``."""
    nodes, control = cluster
    jm, params, blob = lm
    control("n0", "put_bytes", name=lm_store_name("cp"),
            data=blob.decode("latin-1"))
    cp = {"publish_min_hits": 0}
    for host, name in (("n0", "cpa"), ("n1", "cpb"), ("n1", "cpc")):
        control(host, "lm_serve", **kv_pool(name, cluster_prefix=cp))
    p2 = [11, 12, 13, 14, 15, 16, 17, 18]
    ids = [control("n0", "lm_submit", name="cpa", prompt=p, max_new=4,
                   tenant="acme")["id"] for p in (LONG, p2)]
    got = wait_done(control, "n0", "cpa", ids)
    assert [got[i] for i in ids] == [jax_tokens(jm, params, p, 4)
                                     for p in (LONG, p2)]
    pc = control("n0", "lm_stats", name="cpa")["stats"]["prefix_cache"]
    assert pc["prefix_published_chains"] == 2, pc
    probe_a = control("n0", "prefix_probe", name="cpa", tokens=LONG)
    probe_b = control("n1", "prefix_probe", name="cpb", tokens=LONG)
    assert probe_b["namespace"] == probe_a["namespace"]
    assert (probe_b["local_blocks"], probe_b["remote_blocks"]) == (0, 4)
    rid = control("n1", "lm_submit", name="cpb", prompt=LONG,
                  max_new=4)["id"]
    assert wait_done(control, "n1", "cpb", [rid])[rid] == \
        jax_tokens(jm, params, LONG, 4)
    st = control("n1", "lm_stats", name="cpb")["stats"]
    assert st["prefix_cache"]["prefix_remote_hits"] == 1
    assert st["prefill_tokens"] == 2, "a remote hit prefills the suffix"
    # warm by tenant: both of acme's chains land before any request
    out = control("n1", "prefix_fetch", name="cpc", tenant="acme")
    assert out["fetched_blocks"] == 8 and out["targets"] == 2, out
    assert control("n1", "prefix_fetch", name="cpc",
                   tokens=LONG)["fetched_blocks"] == 0   # already held
    rid = control("n1", "lm_submit", name="cpc", prompt=p2, max_new=4)["id"]
    assert wait_done(control, "n1", "cpc", [rid])[rid] == \
        jax_tokens(jm, params, p2, 4)
    # an explicit publish of every chain in the tree writes only the one
    # not on the ring yet: warmup's [1, 2] head, inserted before the cache
    # was attached; a second one writes nothing
    out = control("n0", "prefix_publish", name="cpa")
    assert out["chains"] == 3 and out["published_blocks"] == 1, out
    out = control("n0", "prefix_publish", name="cpa")
    assert out["chains"] == 3 and out["published_blocks"] == 0, out
    err = control("n0", "prefix_probe", ok=False, name="nope",
                  tokens=LONG)["error"]
    assert "nope" in err
    for host, name in (("n0", "cpa"), ("n1", "cpb"), ("n1", "cpc")):
        control(host, "lm_stop", name=name)


def test_kv_handoff_ops_over_rpc(cluster, lm):
    """Each ``kv_handoff`` op by hand (probe, export, adopt, fallback),
    then ``ship`` from a pool on n0 to one on n1: the shipped request
    prefills only its suffix there and its stream equals JAX
    ``generate``; a second ship finds the chain held and moves nothing."""
    nodes, control = cluster
    jm, params, blob = lm
    control("n1", "put_bytes", name=lm_store_name("cp"),
            data=blob.decode("latin-1"))
    control("n0", "lm_serve", **kv_pool("hoa"))
    control("n1", "lm_serve", **kv_pool("hob"))
    probe = control("n1", "kv_handoff", op="probe", name="hob",
                    tokens=LONG)
    assert probe == {"depth": 0, "want": 3, "block_size": BS}
    exp = control("n0", "kv_handoff", op="export", name="hoa", tokens=LONG)
    assert exp["blocks"] == 3 and len(exp["blobs"]) == 3 and exp["bytes"]
    adopt = control("n1", "kv_handoff", op="adopt", name="hob",
                    tokens=LONG, blobs=exp["blobs"])
    assert adopt["depth"] == 3 and adopt["wrote"] == 3
    assert control("n1", "kv_handoff", op="fallback",
                   name="hob")["fallbacks"] == 1
    other = [50, 51, 52, 53, 54, 55, 56]
    ship = control("n0", "kv_handoff", op="ship", name="hoa",
                   target_host="n1", target_name="hob", tokens=other)
    assert ship["shipped"] == 3 and ship["target_depth"] == 3, ship
    again = control("n0", "kv_handoff", op="ship", name="hoa",
                    target_host="n1", target_name="hob", tokens=other)
    assert again["already"] and again["shipped"] == 0
    ids = [control("n1", "lm_submit", name="hob", prompt=p,
                   max_new=4)["id"] for p in (LONG, other)]
    got = wait_done(control, "n1", "hob", ids)
    assert [got[i] for i in ids] == [jax_tokens(jm, params, p, 4)
                                     for p in (LONG, other)]
    st = control("n1", "lm_stats", name="hob")["stats"]
    assert st["prefill_tokens"] == 4, "two suffix-only admissions of 2"
    assert st["kv_handoff_bytes"] == exp["bytes"] + ship["bytes"]
    assert control("n0", "lm_stats", name="hoa")["stats"][
        "kv_handoff_requests"] == 2
    assert "unknown kv_handoff op" in control(
        "n0", "kv_handoff", ok=False, op="nope", name="hoa")["error"]
    for host, name in (("n0", "hoa"), ("n1", "hob")):
        control(host, "lm_stop", name=name)


def test_train_verbs_stop_resume_then_serve(cluster):
    """``train_start`` → ``train_status`` → ``train_stop`` on n1, a
    ``resume`` on n0 from the stored checkpoint, then the published LM
    served by ``lm_serve`` and ``generate``: equal to this process's
    ``generate`` of the stored weights."""
    import torch

    from idunno_tpu_torch.engine.generate import generate

    nodes, control = cluster
    pattern = np.random.default_rng(0).integers(0, 32, size=17)
    save_corpus(nodes["n0"].store, "corpus/rpc",
                np.tile(pattern, 200).astype(np.int32))
    job = dict(name="rpclm", corpus="corpus/rpc",
               model={"vocab": 32, "dim": 32, "depth": 1, "num_heads": 4},
               batch_size=4, seq_len=16, checkpoint_every=3, lr=1e-2)
    assert control("n1", "train_start", steps=100_000, **job)["started"]
    assert "already running" in control("n1", "train_start", ok=False,
                                        steps=5, **job)["error"]
    deadline, st = time.time() + 60, {}
    while time.time() < deadline:
        st = control("n1", "train_status", name="rpclm")
        assert st["error"] is None, st
        if st["checkpoint_version"] is not None and st["step"] >= 4:
            break
        time.sleep(0.02)
    out = control("n1", "train_stop", name="rpclm")
    assert out["stopped"] and out["status"]["stopped"], out
    stopped_at = out["status"]["step"]
    control("n0", "train_start", steps=stopped_at + 6, resume=True, **job)
    while time.time() < deadline + 60:
        st = control("n0", "train_status", name="rpclm")
        assert st["error"] is None, st
        if st["done"]:
            break
        time.sleep(0.02)
    assert st["done"] and st["start_step"] == stopped_at, st
    assert st["step"] == stopped_at + 6 and st["served_version"] is not None
    assert st["loss"] < st["first_loss"]
    assert "no training job" in control("n0", "train_status", ok=False,
                                        name="nope")["error"]
    assert control("n0", "train_stop", name="nope") == {"stopped": False}
    model = load_lm(nodes["n1"].store, "rpclm", device="cpu")
    prompt = [int(t) for t in pattern[:4]]
    want = generate(model, torch.tensor([prompt]), 4, 6)[0].tolist()
    control("n0", "lm_serve", name="rpclm", slots=2, prompt_len=4,
            max_len=12)
    rid = control("n0", "lm_submit", name="rpclm", prompt=prompt,
                  max_new=6)["id"]
    assert wait_done(control, "n0", "rpclm", [rid])[rid] == want
    assert control("n1", "generate", name="rpclm", prompt=[prompt],
                   max_new=6)["tokens"] == [want]
    control("n0", "lm_stop", name="rpclm")


@pytest.fixture
def trio(tmp_path):
    """Three started port nodes over ``InProcNetwork`` (fast failure
    detection): (network, nodes, control)."""
    cfg = ClusterConfig(hosts=("n0", "n1", "n2"), coordinator="n0",
                        standby_coordinator="n1", introducer="n0",
                        replication_factor=2, ping_interval_s=0.1,
                        failure_timeout_s=1.0, metadata_interval_s=0.2)
    net = InProcNetwork()
    nodes = {h: Node(h, cfg, net.transport(h), str(tmp_path / h),
                     engine_config=EngineConfig(**SMALL), device="cpu")
             for h in cfg.hosts}

    def control(host, verb, ok=True, **kw):
        out = nodes[host].control._handle("control", Message(
            MessageType.INFERENCE, "client", {"verb": verb, **kw}))
        want = MessageType.ACK if ok else MessageType.ERROR
        assert out.type is want, out.payload
        return out.payload

    try:
        for n in nodes.values():
            n.start()
        deadline = time.time() + 10.0
        while time.time() < deadline and not all(
                len(n.membership.members.alive_hosts()) == 3
                for n in nodes.values()):
            time.sleep(0.02)
        yield net, nodes, control
    finally:
        for n in nodes.values():
            n.stop()


def test_managed_group_hands_kv_to_its_decode_replica(trio, lm):
    """A managed replica group with a KV block pool and a prefill replica
    (``prefill_len_threshold`` 4): every prompt routes to the decode
    replica, whose node receives the prompt's blocks shipped from the
    prefill replica's node first; the streams equal JAX ``generate``."""
    net, nodes, control = trio
    jm, params, blob = lm
    control("n0", "put_bytes", name=lm_store_name("grp"),
            data=blob.decode("latin-1"))
    # fixed_slots: the fair-share resize would rebuild both replica pools
    # (and their counters) once the two are measured
    out = control("n0", "lm_serve", name="grp", placement="auto", slots=2,
                  fixed_slots=True, prompt_len=8, max_len=24,
                  kv_block_size=BS,
                  kv_cache_blocks=16, paged_kernel="auto",
                  autoscale={"enabled": False, "prefill_len_threshold": 4,
                             "max_replicas": 3})
    assert out.get("group"), out
    owner = next(h for h, n in nodes.items() if "grp" in n.lm_manager._groups)
    mgr = nodes[owner].lm_manager
    assert mgr.group_spawn("grp", role="prefill") is not None
    roles = {meta["role"]: r for r, meta
             in mgr._groups["grp"]["replicas"].items()}
    where = {role: mgr._pools[r]["node"] for role, r in roles.items()}
    assert where["prefill"] != where["decode"], where
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, VOCAB, size=n)]
               for n in (8, 7, 6)]
    ids = [control(owner, "lm_submit", name="grp", prompt=p,
                   max_new=5)["id"] for p in prompts]
    got = wait_done(control, owner, "grp", ids)
    assert [got[i] for i in ids] == [jax_tokens(jm, params, p, 5)
                                     for p in prompts]
    pre = nodes[where["prefill"]].control._lm_loops[roles["prefill"]]
    dec = nodes[where["decode"]].control._lm_loops[roles["decode"]]
    pst, dst = pre.server.stats(), dec.server.stats()
    # the manager's pump may replay a ship (the legs are idempotent: a
    # replayed adopt grafts nothing new), so every prompt was shipped at
    # least once
    assert pst["kv_handoff_requests"] >= len(prompts), pst
    assert pst["kv_handoff_fallbacks"] == 0
    assert dst["kv_handoff_bytes"] > 0 and dst["tokens_generated"] > 0
    assert pst["tokens_generated"] == 0, "the prefill replica never decodes"
    control(owner, "lm_stop", name="grp")


def test_placed_train_job_resumes_on_a_survivor(trio):
    """A cluster-placed training job's node dies mid-run: the master
    restarts it on a survivor with ``resume=True`` and it continues from
    its last store checkpoint to the full step budget."""
    net, nodes, control = trio
    save_corpus(nodes["n0"].store, "corpus/kill",
                np.random.default_rng(2).integers(0, 32, size=4000)
                .astype(np.int32))
    out = control("n0", "train_start", placement="auto", name="crashlm",
                  corpus="corpus/kill",
                  model={"vocab": 32, "dim": 16, "depth": 1,
                         "num_heads": 2},
                  steps=1500, batch_size=4, seq_len=16, checkpoint_every=3)
    victim = out["node"]
    assert victim != "n0", out
    deadline, st = time.time() + 120.0, {}
    while time.time() < deadline:
        st = control("n0", "train_status", name="crashlm")
        if st.get("checkpoint_version") is not None and st["step"] >= 4:
            break
        time.sleep(0.02)
    assert st.get("checkpoint_version") is not None and not st["done"], st
    net.kill(victim)
    while time.time() < deadline:
        st = control("n0", "train_status", name="crashlm")
        if st.get("done"):
            break
        assert not st.get("error"), st
        time.sleep(0.1)
    assert st.get("done"), f"resumed job never finished: {st}"
    assert st["node"] not in (None, victim), st
    assert st["start_step"] >= 3, f"restarted from scratch: {st}"
    assert st["step"] == 1500, st

