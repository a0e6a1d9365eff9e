"""Tensor-parallel decode of the port against the JAX package, on the CPU.

The counterparts of ``tests/test_serve_lm.py``'s mesh and TP cases and of
``tests/test_prefix_cache.py``'s TP cases: a port ``DecodeServer`` at
``n_model`` 2 and 4 (a virtual mesh over the one CPU, the counterpart of
the JAX tests' eight forced host devices), a 4x2 (data, model) mesh with
GQA KV heads that divide and that replicate, the vocab-sharded sampling
tail in its five modes, the paged pool (plain paged attention per shard),
int8 weights and pages, the radix prefix cache, and the cluster prefix
cache and KV handoff between pools of different ``n_model``. Each stream
is held against the JAX package's ``generate`` on the same seeded weights
and against the port's ``n_model`` 1 pool. Small models: dim 32, depth 2,
4 heads, f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.engine.generate import generate as jax_generate
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu_torch.engine.serve_lm import DecodeServer
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.models.moe import MoETransformerLM
from idunno_tpu_torch.parallel.mesh import MeshShapeError, virtual_mesh
from idunno_tpu_torch.serve.cluster_prefix import ClusterPrefixCache
from idunno_tpu_torch.store.sdfs import StoreError

VOCAB, BS = 61, 2


def _pair(vocab=VOCAB, seed=0, **kw):
    jm = JaxLM(vocab=vocab, dim=32, depth=2, num_heads=4, **kw)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=vocab, dim=32, depth=2, num_heads=4, **kw)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def lm():
    return _pair()


@pytest.fixture(scope="module")
def lm64():
    """Vocab 64 divides n_model 2 and 4, so the unembed really is cut
    over the vocab (61 replicates it)."""
    return _pair(vocab=64, seed=1)


def expected(jm, params, prompt, max_new, **kw):
    out = jax_generate(jm, params, jnp.asarray([prompt], jnp.int32),
                       prompt_len=len(prompt), max_new=max_new, **kw)
    return [int(t) for t in np.asarray(out[0])]


def pool(tm, **kw):
    base = dict(slots=2, prompt_len=8, max_len=24, device="cpu")
    base.update(kw)
    return DecodeServer(tm, **base)


def drain(srv):
    return {c.id: c for c in srv.run_until_drained()}


def test_pool_shards_over_mesh(lm):
    """Slots split over the mesh's data axis (a 4x1 mesh): each row
    decodes on its own data group, token for token as ``generate``."""
    jm, params, tm = lm
    mesh = virtual_mesh(4, 1, "cpu")
    srv = pool(tm, slots=4, mesh=mesh)
    assert srv.n_model == 1 and srv._dec.n_data == 4
    rng = np.random.default_rng(5)
    reqs = [([int(t) for t in rng.integers(0, VOCAB, size=k)], m)
            for k, m in [(3, 9), (8, 4), (5, 12), (2, 7), (6, 6),
                         (1, 10), (4, 5), (7, 8)]]
    ids = {srv.submit(p, m): (p, m) for p, m in reqs[:4]}
    for _ in range(2):
        srv.step()
    for p, m in reqs[4:]:                  # admitted into freed slots
        ids[srv.submit(p, m)] = (p, m)
    done = drain(srv)
    assert set(done) == set(ids)
    for rid, (p, m) in ids.items():
        assert done[rid].tokens == expected(jm, params, p, m), rid
    with pytest.raises(ValueError, match="divide"):
        pool(tm, slots=5, mesh=mesh)


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_decode_token_exact(lm, n_model):
    """The Megatron split changes where the math runs, not what it
    computes: greedy rows equal ``generate``, and a seeded sampled row
    equals the port's n_model 1 pool."""
    jm, params, tm = lm
    srv = pool(tm, n_model=n_model)
    assert srv.n_model == n_model and srv.mesh.virtual
    rng = np.random.default_rng(13)
    reqs = [([int(t) for t in rng.integers(0, VOCAB, size=k)], m)
            for k, m in [(3, 9), (8, 4), (5, 12), (2, 7)]]
    ids = {srv.submit(p, m): (p, m) for p, m in reqs}
    sp = [4, 17, 2]
    sid = srv.submit(sp, max_new=8, temperature=0.8, top_p=0.9, seed=21)
    done = drain(srv)
    for rid, (p, m) in ids.items():
        assert done[rid].tokens == expected(jm, params, p, m), rid
    ref = pool(tm)
    rid = ref.submit(sp, max_new=8, temperature=0.8, top_p=0.9, seed=21)
    assert done[sid].tokens == drain(ref)[rid].tokens
    cfg = srv.stats()["config"]
    assert cfg["n_model"] == n_model
    assert cfg["tp_collective_bytes"] == 2 * 2 * 2 * 32 * 4
    assert cfg["sampling_collective_bytes"] == 0      # vocab 61 replicates


def test_tp_decode_2d_mesh_with_gqa():
    """A 4x2 (data, model) mesh: slots over data, heads over model; KV
    heads that divide n_model shard, one KV head (MQA) replicates."""
    mesh = virtual_mesh(4, 2, "cpu")
    for kvh in (2, 1):
        jm, params, tm = _pair(seed=3, num_kv_heads=kvh)
        srv = pool(tm, slots=4, mesh=mesh)
        assert srv.n_model == 2 and srv._dec.kv_shard == (kvh == 2)
        prompts = {srv.submit([1 + kvh, 5, 9], max_new=6): [1 + kvh, 5, 9],
                   srv.submit([7, 2], max_new=8): [7, 2],
                   srv.submit([3, 3, 8, 1, 6], max_new=5): [3, 3, 8, 1, 6]}
        done = drain(srv)
        ref = pool(tm, slots=4)
        rids = {ref.submit(p, max_new=len(done[i].tokens) - len(p)): i
                for i, p in prompts.items()}
        ref_done = drain(ref)
        for rid, p in prompts.items():
            got = done[rid].tokens
            assert got == expected(jm, params, p, len(got) - len(p)), kvh
        for r, i in rids.items():
            assert ref_done[r].tokens == done[i].tokens, kvh


def _five_modes(srv):
    rows = {
        "greedy": srv.submit([5, 11, 17], max_new=8),
        "sampled": srv.submit([4, 17, 2], max_new=8, temperature=0.8,
                              seed=21),
        "filtered": srv.submit([9, 1], max_new=8, temperature=0.9,
                               top_k=7, top_p=0.85, seed=5),
        "penalized": srv.submit([3, 7, 31, 8], max_new=8,
                                presence_penalty=0.6,
                                frequency_penalty=0.4),
        "logprobs": srv.submit([2, 40, 13], max_new=6),
    }
    done = drain(srv)
    return {k: done[rid] for k, rid in rows.items()}


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_sharded_tail_five_modes_token_exact(lm64, n_model):
    """With the unembed cut over the vocab, the tail resolves every pick
    from per-shard statistics: greedy, seeded-sampled, filtered, penalized
    and log-probability rows equal the n_model 1 pool's, the deterministic
    ones ``generate``'s, and the log-probabilities agree within float
    reduction-order noise."""
    jm, params, tm = lm64
    kw = dict(slots=3, max_len=32, penalties=True, track_logprobs=True)
    srv = pool(tm, n_model=n_model, **kw)
    assert srv._dec.vocab_shard
    got, ref = _five_modes(srv), _five_modes(pool(tm, **kw))
    for mode in got:
        assert got[mode].tokens == ref[mode].tokens, mode
        np.testing.assert_allclose(got[mode].logprobs, ref[mode].logprobs,
                                   atol=1e-5, err_msg=mode)
    assert got["greedy"].tokens == expected(jm, params, [5, 11, 17], 8)
    assert got["penalized"].tokens == expected(
        jm, params, [3, 7, 31, 8], 8, presence_penalty=0.6,
        frequency_penalty=0.4)
    assert srv.stats()["config"]["sampling_collective_bytes"] == 4 * 3 * 4


def test_tp_rejects_bad_shapes(lm):
    """Q heads must divide n_model (typed), an explicit mesh wins over a
    conflicting n_model, routed and speculative pools refuse naming
    ROADMAP.md, and a card pool needs distinct cards."""
    _, _, tm = lm
    with pytest.raises(MeshShapeError):       # 4 heads over 3 shards
        pool(tm, n_model=3)
    with pytest.raises(ValueError, match="conflicts"):
        pool(tm, slots=4, mesh=virtual_mesh(4, 2, "cpu"), n_model=4)
    routed = MoETransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4,
                              n_experts=2)
    with pytest.raises(ValueError, match="scanned.*ROADMAP"):
        pool(routed, n_model=2)
    with pytest.raises(ValueError, match="ROADMAP"):
        pool(tm, n_model=2, draft=(tm, None))
    with pytest.raises(ValueError, match="n_model"):
        pool(tm, n_model=0)


@pytest.mark.parametrize("pages", ["native", "int8"])
def test_paged_tp_hit_depths_token_exact(pages):
    """The paged pool under TP: head-sharded block stores, every radix
    hit depth read in place shard by shard (the plain paged attention on
    the CPU, K3 per shard on a card), greedy equal to ``generate`` and a
    seeded sampled stream equal to the n_model 1 pool at each depth."""
    jm, params, tm = _pair(kv_cache_dtype=pages)
    kw = dict(kv_block_size=BS, kv_cache_blocks=16, paged_kernel="auto")
    srv = pool(tm, n_model=2, **kw)
    ref = pool(tm, **kw)
    stores = srv._block_pool.kv_pages()["cached_k"]
    assert len(stores) == 2
    assert all(s.shape[3] == 2 for s in stores.values())   # 4 KV heads / 2
    base = [int(t) for t in np.random.default_rng(3).integers(0, VOCAB, 8)]
    prompts = [base, base[:3] + [base[3] ^ 1] + base[4:],
               base[:6] + [59, 58], base]
    for prompt in prompts:
        rid = srv.submit(prompt, max_new=6)
        assert drain(srv)[rid].tokens == expected(jm, params, prompt, 6)
        sid = srv.submit(prompt, max_new=6, temperature=0.8, top_p=0.9,
                         seed=42)
        fid = ref.submit(prompt, max_new=6, temperature=0.8, top_p=0.9,
                         seed=42)
        ref.submit(prompt, max_new=6)          # keep hit depths aligned
        assert drain(srv)[sid].tokens == drain(ref)[fid].tokens
    assert srv.prefix_cache_stats()["hits"] >= 3


def test_tp_int8_prefix_and_chunked_pools(lm):
    """int8 weights, a static prefix, a gathered radix pool and chunked
    prefill, each under TP, serve the n_model 1 pool's streams."""
    _, _, tm = lm
    prompts = [[5, 11, 17, 3], [5, 11, 17, 3, 9, 2, 8], [40, 2]]
    for kw in (dict(quantize="int8"), dict(prefix=[20, 21, 22]),
               dict(kv_block_size=BS, kv_cache_blocks=16),
               dict(prefill_chunk=2, prompt_buckets=(2, 4, 8))):
        streams = []
        for n_model in (1, 2):
            srv = pool(tm, n_model=n_model, **kw)
            ids = [srv.submit(p, max_new=6) for p in prompts]
            done = drain(srv)
            streams.append([done[i].tokens for i in ids])
        assert streams[0] == streams[1], kw


# -- the cluster prefix cache and the KV handoff under TP -------------------

class FakeRing:
    """In-memory stand-in for the store's client surface
    (`tests/test_torch_cluster_prefix.py`'s): monotone versions, typed
    StoreError misses."""

    def __init__(self):
        self.blobs: dict[str, tuple[bytes, int]] = {}

    def put_bytes(self, name, blob):
        v = self.blobs.get(name, (b"", 0))[1] + 1
        self.blobs[name] = (bytes(blob), v)
        return v

    def get_bytes(self, name, version=None):
        if name not in self.blobs:
            raise StoreError(f"{name}: not found")
        return self.blobs[name]

    def stat(self, name):
        if name not in self.blobs:
            raise StoreError(f"{name}: not found")
        return self.blobs[name][1], ("n0",)

    def delete(self, name):
        self.blobs.pop(name, None)


CP = dict(kv_block_size=BS, kv_cache_blocks=16, paged_kernel="auto")
HIT_PROMPTS = [[4, 9, 14, 19, 24, 29, 34, 39], [4, 9, 14, 1, 24, 29, 2, 3],
               [4, 9, 14, 19, 24, 29, 58, 57]]


def _cached(tm, ring, n_model):
    srv = pool(tm, n_model=n_model, **CP)
    srv.cluster_prefix = ClusterPrefixCache(ring, "ns-tp", BS,
                                            publish_min_hits=0)
    return srv


@pytest.mark.parametrize("pub_n,sub_n", [(1, 2), (2, 1), (2, 4)])
def test_cluster_tp_remote_hit_token_exact(lm, pub_n, sub_n):
    """Published blocks are whole blocks whatever the publisher's
    n_model, so a consumer of another n_model grafts them (head-sharded
    where it shards) and serves ``generate``'s streams from remote hits."""
    jm, params, tm = lm
    ring = FakeRing()
    pub, sub = _cached(tm, ring, pub_n), _cached(tm, ring, sub_n)
    for p in HIT_PROMPTS:
        rid = pub.submit(p, max_new=6)
        assert drain(pub)[rid].tokens == expected(jm, params, p, 6)
    for p in HIT_PROMPTS:
        rid = sub.submit(p, max_new=6)
        assert drain(sub)[rid].tokens == expected(jm, params, p, 6)
    assert sub.prefix_cache_stats()["prefix_remote_hits"] >= 1


def test_published_blocks_are_whole_across_n_model(lm):
    """The same prompt published by an n_model 1 and an n_model 2 pool
    writes blobs of the same names and sizes (whole blocks, every KV
    head), whose contents agree within the float noise of the row
    shards' reduction order."""
    from idunno_tpu_torch.store.kv_chain import decode_block

    _, _, tm = lm
    rings = []
    for n_model in (1, 2):
        ring = FakeRing()
        srv = _cached(tm, ring, n_model)
        srv.submit(HIT_PROMPTS[0], max_new=2)
        drain(srv)
        rings.append({k: b for k, (b, _) in ring.blobs.items()})
    assert rings[0] and set(rings[0]) == set(rings[1])
    for name, blob in rings[0].items():
        assert len(blob) == len(rings[1][name])
        _, one = decode_block(blob)
        _, two = decode_block(rings[1][name])
        for leaf in one:
            np.testing.assert_allclose(np.asarray(two[leaf]),
                                       np.asarray(one[leaf]), atol=1e-5)


@pytest.mark.parametrize("pre_n,dec_n", [(2, 2), (1, 2), (4, 1)])
def test_handoff_tp_token_exact(lm, pre_n, dec_n):
    """KV handoff from a prefill pool to a decode pool of the same or
    another n_model: exported blobs come off one block pool and graft
    into the other, and the decode pool serves ``generate``'s streams."""
    jm, params, tm = lm
    pre, dec = pool(tm, n_model=pre_n, **CP), pool(tm, n_model=dec_n, **CP)
    for p in HIT_PROMPTS:
        d0 = dec.handoff_probe(p)["depth"]
        exp = pre.handoff_export(p, from_depth=d0)
        dec.handoff_adopt(p, exp["blobs"], start_depth=d0)
        rid = dec.submit(p, max_new=6)
        assert drain(dec)[rid].tokens == expected(jm, params, p, 6)
    assert dec.prefix_cache_stats()["hits"] >= 3
    blocks = pre._block_pool.read_block(pre._radix.lookup(
        HIT_PROMPTS[0])[0].block)
    assert blocks["cached_k"].shape[2] == 4        # whole blocks: 4 heads
    assert torch.equal(blocks["cached_k"],
                       dec._block_pool.read_block(dec._radix.lookup(
                           HIT_PROMPTS[0])[0].block)["cached_k"])
