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
- every verb of a module not ported yet answers with an error naming
  ROADMAP.md.

Small models, f32: ResNet-18 at 64² images, batch 8; the LM at dim 32,
depth 2, vocab 61, KV blocks of 2.
"""
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
from idunno_tpu_torch.engine.generate import lm_store_name, save_lm
from idunno_tpu_torch.models.convert import (lm_state_dict_from_flax,
                                             state_dict_from_flax)
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.serve.node import Node
from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload
from idunno_tpu_torch.utils.types import MessageType

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
    ("train_start", {"corpus": "c", "model": {}, "steps": 1}),
    ("train_status", {}),
    ("train_stop", {}),
    ("prefix_publish", {}),
    ("prefix_probe", {}),
    ("prefix_fetch", {}),
    ("kv_handoff", {"op": "probe"}),
    ("profile", {"seconds": 0.1}),
    ("lm_serve", {"cluster_prefix": True, "kv_block_size": 2}),
    ("lm_serve", {"n_model": 2}),
    ("lm_serve", {"placement": "auto", "n_model": 2}),
    ("lm_serve", {"kv_block_size": 2,
                  "autoscale": {"prefill_len_threshold": 4}}),
]


@pytest.mark.parametrize("verb,extra", UNPORTED,
                         ids=[f"{v}-{'-'.join(e)}" for v, e in UNPORTED])
def test_unported_verbs_name_roadmap(cluster, verb, extra):
    nodes, control = cluster
    kw = dict({"name": "chat", "prompt_len": 8, "max_len": 24}, **extra)
    err = control("n0", verb, ok=False, **kw)["error"]
    assert "ValueError" in err and "ROADMAP.md" in err, err


def test_shell_drives_the_port_node(cluster, lm, tmp_path):
    """The copied shell over a port node: membership, the store, the
    distributed log grep, and an LM pool whose greedy tokens equal JAX
    ``generate``; a verb that waits for a later slice names ROADMAP.md."""
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
    assert "ROADMAP.md" in sh.dispatch("train job corpus 3")


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
