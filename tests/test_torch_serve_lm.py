"""Parity of the port's continuous-batching LM server with the JAX
package, on the CPU.

The tentpole check: a paged radix-cache ``DecodeServer`` of the port
(``kv_block_size=2``, ``paged_kernel="auto"``, which is the plain paged
attention on the CPU) against the JAX package's
``DecodeServer(paged_kernel="pallas")`` (the Pallas kernel in interpret
mode) on the shared-prefix workload of ``utils/lm_bench.py``: the greedy
streams must match token for token and the radix hits must be equal.
Int8 weights (``quantize="int8"``) and the JAX package's default-size
model (head_dim 32) are held to the JAX server with its plain paged
attention (``paged_kernel="xla"``) the same way. The rest holds the
port's server to the port's own ``generate``, and the serving loop,
gateway and block pool to their contracts. Small model: dim 32, depth 2,
vocab 61, f32.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.engine.serve_lm import DecodeServer as JaxDecodeServer
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu_torch.engine.generate import generate
from idunno_tpu_torch.engine.kv_blocks import KVBlockPool, concat_kv_prefix
from idunno_tpu_torch.engine.serve_lm import DecodeServer
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.ops.quantize import dequantize_tree, qtensors
from idunno_tpu_torch.serve.admission import AdmissionShed
from idunno_tpu_torch.serve.gateway import AdmissionGateway
from idunno_tpu_torch.serve.lm_pool import LMServingLoop
from idunno_tpu_torch.utils.lm_bench import (lm_bench_config,
                                             prefix_bench_workload,
                                             serving_max_new)
from tests.torch_workers import share_cores  # noqa: F401

VOCAB, BS = 61, 2
CFG = {"prompt_len": 8, "vocab": VOCAB, "slots": 2}


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def workload():
    return prefix_bench_workload(CFG, BS)


def pool_kw(buckets, **kw):
    return dict(slots=2, prompt_len=8, max_len=24, prompt_buckets=buckets,
                kv_block_size=BS, kv_cache_blocks=(2 + 1) * 4,
                decode_steps=2, **kw)


def expected(tm, prompt, max_new):
    out = generate(tm, torch.tensor([prompt]), len(prompt), max_new)
    return out[0].tolist()


def test_paged_server_matches_jax_server(lm, workload):
    """Greedy streams token for token and radix hits equal, against the
    JAX package's server running its Pallas paged kernel (interpret)."""
    jm, params, tm = lm
    prompts, shared, buckets = workload
    assert shared == 6 and buckets == (2, 4, 8) and len(prompts) == 6
    jsrv = JaxDecodeServer(jm, params, paged_kernel="pallas",
                           **pool_kw(buckets))
    jids = [jsrv.submit(p, max_new=6) for p in prompts]
    want = {c.id: c.tokens for c in jsrv.run_until_drained()}
    srv = DecodeServer(tm, paged_kernel="auto", device="cpu",
                       **pool_kw(buckets))
    assert srv.paged_kernel == "plain"
    ids = [srv.submit(p, max_new=6) for p in prompts]
    got = {c.id: c.tokens for c in srv.run_until_drained()}
    assert ids == jids
    assert got == want
    hits = srv.prefix_cache_stats()["hits"]
    assert hits == jsrv.prefix_cache_stats()["hits"] and hits > 0
    st = srv.stats()
    assert st["completed"] == len(prompts)
    assert st["kv_gather_bytes_saved"] > 0


@pytest.mark.parametrize("mode", ["gathered", "paged", "off"])
def test_server_streams_equal_generate(lm, workload, mode):
    """Every radix mode (gathered hits, paged hits, cache off) serves the
    greedy stream `generate` computes."""
    _, _, tm = lm
    prompts, _, buckets = workload
    kw = pool_kw(buckets)
    if mode == "paged":
        kw["paged_kernel"] = "plain"
    if mode == "off":
        kw.pop("kv_block_size")
        kw.pop("kv_cache_blocks")
    srv = DecodeServer(tm, device="cpu", **kw)
    ids = [srv.submit(p, max_new=5) for p in prompts[:4]]
    done = {c.id: c for c in srv.run_until_drained()}
    for rid, p in zip(ids, prompts[:4]):
        assert done[rid].tokens == expected(tm, p, 5), f"{mode}: row {rid}"
        assert done[rid].prompt_len == len(p)
    if mode != "off":
        assert srv.prefix_cache_stats()["hits"] == 3


def serve_both_xla(jm, params, tm, prompts, buckets, **kw):
    """Greedy streams and radix hits of the JAX ``paged_kernel="xla"``
    server and the port's ``"auto"`` server on ``prompts`` (6 new
    tokens each)."""
    jsrv = JaxDecodeServer(jm, params, paged_kernel="xla",
                           **pool_kw(buckets, **kw))
    jids = [jsrv.submit(p, max_new=6) for p in prompts]
    jdone = {c.id: c.tokens for c in jsrv.run_until_drained()}
    srv = DecodeServer(tm, paged_kernel="auto", device="cpu",
                       **pool_kw(buckets, **kw))
    ids = [srv.submit(p, max_new=6) for p in prompts]
    done = {c.id: c.tokens for c in srv.run_until_drained()}
    assert ids == jids
    hits = srv.prefix_cache_stats()["hits"]
    assert hits == jsrv.prefix_cache_stats()["hits"] and hits > 0
    return [jdone[i] for i in jids], [done[i] for i in ids], srv


def test_int8_weights_match_jax_int8_server(lm, workload):
    """``quantize="int8"`` on both servers: equal greedy streams and radix
    hits; the port's server holds an int8 copy of the weights (per block
    six kernels and the q/k/v biases, the embedding, the head) and the
    caller's model keeps its dense ones."""
    jm, params, tm = lm
    prompts, _, buckets = workload
    want, got, srv = serve_both_xla(jm, params, tm, prompts, buckets,
                                    quantize="int8")
    assert got == want
    assert srv.stats()["config"]["quantize"] == "int8"
    assert len(qtensors(srv.model)) == 2 * (6 + 3) + 2
    assert not qtensors(tm)
    dense = tm.state_dict()
    assert not all(bool((dense[k] == v).all())
                   for k, v in dequantize_tree(srv.model).items())


def test_default_size_paged_server_matches_jax():
    """The JAX package's default ``TransformerLM`` (dim 128, 4 heads, so
    head_dim 32, which K3 is built for on the card; vocab 1024) at depth
    2, f32: equal streams and radix hits."""
    jm = JaxLM(depth=2)
    params = jax.jit(jm.init)(jax.random.PRNGKey(11),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(depth=2)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    assert tm.dim // tm.num_heads == 32
    prompts, _, buckets = prefix_bench_workload(
        {"prompt_len": 8, "vocab": tm.vocab, "slots": 2}, BS)
    want, got, _ = serve_both_xla(jm, params, tm.eval(), prompts, buckets)
    assert got == want


def test_static_prefix_and_chunked_prefill_token_exact(lm):
    _, _, tm = lm
    prefix = [5, 9, 11]
    srv = DecodeServer(tm, device="cpu", slots=2, prompt_len=8, max_len=24,
                       prefix=prefix, prefill_chunk=3, kv_block_size=BS,
                       paged_kernel="plain", kv_cache_blocks=12)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 4, 8], [7, 7, 7]]
    ids = [srv.submit(p, max_new=4) for p in prompts]
    done = {c.id: c for c in srv.run_until_drained()}
    for rid, p in zip(ids, prompts):
        assert done[rid].tokens == expected(tm, prefix + p, 4)
    assert srv.stats()["prefill_chunks"] > len(prompts)


def test_eos_stop_penalties_logprobs(lm):
    _, _, tm = lm
    srv = DecodeServer(tm, device="cpu", slots=2, prompt_len=8, max_len=24,
                       track_logprobs=True, penalties=True)
    p = [3, 1, 4, 1, 5]
    free = expected(tm, p, 8)
    gen = free[len(p):]
    rid = srv.submit(p, max_new=8, stop=[[gen[2]]])
    pen = srv.submit(p, max_new=8, presence_penalty=0.5)
    done = {c.id: c for c in srv.run_until_drained()}
    assert done[rid].tokens == free[:len(p) + gen.index(gen[2]) + 1]
    assert len(done[rid].logprobs) == len(done[rid].tokens) - len(p)
    assert all(lp <= 0.0 for lp in done[rid].logprobs)
    want = generate(tm, torch.tensor([p]), len(p), 8,
                    presence_penalty=0.5)[0].tolist()
    assert done[pen].tokens == want
    eos = DecodeServer(tm, device="cpu", slots=1, prompt_len=8, max_len=24,
                       eos_id=gen[1])
    e = eos.submit(p, max_new=8)
    assert {c.id: c for c in eos.run_until_drained()}[e].tokens == \
        free[:len(p) + 2]


def test_sampled_streams_seeded_and_cancel(lm):
    _, _, tm = lm
    srv = DecodeServer(tm, device="cpu", slots=2, prompt_len=8, max_len=24)
    kw = dict(max_new=6, temperature=0.9, top_p=0.9, top_k=10)
    a = srv.submit([1, 2, 3], seed=11, **kw)
    b = srv.submit([1, 2, 3], seed=11, **kw)
    done = {c.id: c.tokens for c in srv.run_until_drained()}
    assert done[a] == done[b] and all(0 <= t < VOCAB for t in done[a])
    q = srv.submit([1, 2], max_new=3)
    assert srv.cancel(q) == "queued"
    live = srv.submit([4, 5], max_new=12)
    srv.step()
    assert srv.cancel(live) == "live"
    done = {c.id: c for c in srv.run_until_drained()}
    assert done[q].cancelled and done[live].cancelled
    assert srv.cancel(live) == "unknown"


def test_warmup_resets_accounting(lm):
    _, _, tm = lm
    srv = DecodeServer(tm, device="cpu", slots=2, prompt_len=8, max_len=24,
                       kv_block_size=BS, paged_kernel="auto")
    assert srv.warmup() > 0
    st = srv.stats()
    assert st["admitted"] == 0 and st["dispatches"] == 0
    assert srv.submit([1, 2, 3], max_new=2) == 0


def test_unported_options_raise_naming_the_roadmap(lm):
    """Tensor parallelism is ported: ``n_model=2`` builds a TP pool on the
    CPU's virtual mesh that serves the greedy stream of ``generate``, and
    a ``mesh`` that is not a ``parallel/mesh.py:Mesh`` raises typed."""
    _, _, tm = lm
    base = dict(slots=2, prompt_len=8, max_len=24, device="cpu")
    tp = DecodeServer(tm, **base, n_model=2)
    assert tp.n_model == 2 and tp.mesh.virtual
    rid = tp.submit([5, 11, 17], max_new=6)
    assert tp.run_until_drained()[0].tokens == expected(tm, [5, 11, 17], 6)
    assert rid == 0
    with pytest.raises(TypeError, match="Mesh"):
        DecodeServer(tm, **base, mesh=object())
    # the cluster KV tier is ported: its legs refuse, typed, a pool that
    # lacks what they need (a cluster cache; a KV block tier)
    srv = DecodeServer(tm, kv_block_size=BS, **base)
    for verb in ("prefix_probe", "prefix_warm", "prefix_publish"):
        with pytest.raises(ValueError, match="no cluster prefix cache"):
            getattr(srv, verb)([1, 2])
    plain = DecodeServer(tm, **base)
    for verb in ("handoff_probe", "handoff_export"):
        with pytest.raises(ValueError, match="no KV block tier"):
            getattr(plain, verb)([1, 2])
    with pytest.raises(ValueError, match="no KV block tier"):
        plain.handoff_adopt([1, 2], [])
    with pytest.raises(ValueError, match="no KV block tier"):
        plain.handoff_fallback()
    with pytest.raises(ValueError):
        DecodeServer(tm, paged_kernel="pallas", kv_block_size=BS, **base)


def test_default_device_raises_without_a_card(lm, monkeypatch):
    _, _, tm = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer(tm, slots=1, prompt_len=8, max_len=16)


def test_serving_loop_answers_two_threads(lm, workload):
    _, _, tm = lm
    prompts, _, buckets = workload
    srv = DecodeServer(tm, device="cpu", paged_kernel="auto",
                       **pool_kw(buckets))
    loop = LMServingLoop(srv, name="test")
    ids: list[int] = []
    lock = threading.Lock()

    def client(ps):
        for p in ps:
            rid = loop.submit(p, max_new=4)
            with lock:
                ids.append(rid)

    try:
        threads = [threading.Thread(target=client, args=(prompts[i::2],))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        done = {}
        for _ in range(400):
            for c in loop.poll():
                done[c.id] = c
            if len(done) == len(prompts):
                break
            threading.Event().wait(0.02)
        assert sorted(done) == sorted(ids) == list(range(len(prompts)))
        assert loop.errors() == []
        for c in done.values():
            assert len(c.tokens) == len(prompts[0]) + 4
            assert c.tokens == expected(tm, c.tokens[:len(prompts[0])], 4)
        assert loop.stats()["prefix_cache"]["hits"] > 0
    finally:
        loop.stop()


def test_serving_loop_gateway_sheds_over_quota(lm):
    _, _, tm = lm
    srv = DecodeServer(tm, device="cpu", slots=1, prompt_len=8, max_len=16)
    gw = AdmissionGateway({"tenants": {"t": {"rate": 0, "burst": 1}}})
    loop = LMServingLoop(srv, name="gw", gateway=gw)
    try:
        loop.submit([1, 2], max_new=2, tenant="t")
        with pytest.raises(AdmissionShed, match="quota"):
            loop.submit([1, 2], max_new=2, tenant="t")
    finally:
        loop.stop()


def test_block_pool_refcounts_and_roundtrip(lm):
    _, _, tm = lm
    pool = KVBlockPool(tm, num_blocks=3, block_size=BS)
    bids = [pool.alloc() for _ in range(3)]
    assert sorted(bids) == [0, 1, 2] and pool.alloc() is None
    pool.incref(bids[0])
    with pytest.raises(ValueError, match="refcount"):
        pool.free(bids[0])
    pool.decref(bids[0])
    with pytest.raises(ValueError, match="below zero"):
        pool.decref(bids[0])
    pool.free(bids[0])
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(bids[0])
    row = {name: torch.randn(leaf.shape[0], 1, 6, *leaf.shape[3:])
           for name, leaf in pool.kv_pages().items()}
    pool.write_block(bids[1], row, 2)
    pool.write_block(bids[2], row, 4)
    got = pool.gather([bids[1], bids[2]])
    for name in row:
        assert torch.equal(got[name], row[name][:, :, 2:6])
    both = concat_kv_prefix(got, got)
    assert both["cached_k"].shape[2] == 8
    with pytest.raises(ValueError, match="outside row cache"):
        pool.write_block(bids[1], row, 5)
    raw = pool.read_block(bids[1])
    pool.write_raw_block(bids[2], raw)
    assert torch.equal(pool.gather([bids[2]])["cached_v"],
                       row["cached_v"][:, :, 2:4])
    with pytest.raises(TypeError, match="Mesh"):
        KVBlockPool(tm, 2, BS, mesh=object())


def test_lm_bench_config_is_full_width():
    cfg = lm_bench_config()
    assert (cfg["dim"], cfg["depth"], cfg["heads"], cfg["vocab"]) == \
        (1024, 12, 16, 32768)
    prompts, shared, buckets = prefix_bench_workload(cfg, 16)
    assert len(prompts) == 48 and shared == 48 and buckets == (16, 32, 64)
    assert serving_max_new(cfg) == 129
    from idunno_tpu.utils.lm_bench import \
        prefix_bench_workload as jax_workload
    assert (prompts, shared, buckets) == jax_workload(cfg, 16)
