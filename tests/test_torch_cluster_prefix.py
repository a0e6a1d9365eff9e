"""The port's cluster KV tier on the CPU: the cluster prefix cache
(``serve/cluster_prefix.py`` over ``store/kv_chain.py``) and the KV
handoff legs of ``DecodeServer``, held against the JAX package's server
on carried weights — the counterparts of ``tests/test_prefix_cache.py``'s
cluster and handoff tests and of ``tests/test_serve_lm.py``'s mid-serve
handoff.

- a cold consumer pool extends its empty or shorter local hit with a
  publisher's chain from the store at every hit depth and gives the JAX
  server's greedy streams token for token (native and int8 pages; the
  plain paged attention and the contiguous, gathered path);
- a remote hit, a warm (``prefix_warm``) and an adopted handoff each turn
  the next admission into a suffix-only prefill (``prefill_tokens``);
- eviction is a tombstone a forced republish outranks; a store that fails
  every call degrades to local hits, never to a failed request;
- int8 weights with a static pool prefix;
- ``pool_namespace`` separates what changes KV content and nothing else;
- the handoff matrix, delta-only ships, validation, the fallback counter
  and a handoff landing mid-serve;
- the port's and the JAX server's ``handoff_export`` of one prompt: equal
  meta and depth-stacked leaf shapes, arrays within EXPORT_ATOL.

Small model, f32: dim 64, depth 2, 4 heads, vocab 61, KV blocks of 2.
Streams are compared exactly; only the exported KV has a tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.engine.serve_lm import DecodeServer as JaxDecodeServer
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.store.kv_chain import decode_block as jax_decode_block
from idunno_tpu_torch.engine.generate import load_lm, save_lm
from idunno_tpu_torch.engine.serve_lm import DecodeServer
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.serve.cluster_prefix import (ClusterPrefixCache,
                                                   pool_namespace)
from idunno_tpu_torch.store.kv_chain import decode_block
from idunno_tpu_torch.store.sdfs import StoreError
from tests.torch_workers import share_cores  # noqa: F401

VOCAB, BS, DIM = 61, 2, 64
# f32 K/V of the port's and the JAX server's exports of one prompt
EXPORT_ATOL = 1e-5
PREFIX = [20, 21, 22]


class FakeRing:
    """In-memory stand-in for the store's client surface with the two
    semantics the cache leans on: monotone versions that bump PAST a
    tombstone on republish, and typed StoreError misses."""

    def __init__(self):
        self.blobs: dict[str, tuple[bytes, int]] = {}
        self.tombs: dict[str, int] = {}

    def put_bytes(self, name, blob):
        v = max(self.blobs.get(name, (b"", 0))[1],
                self.tombs.get(name, 0)) + 1
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
        if name in self.blobs:
            self.tombs[name] = self.blobs.pop(name)[1]


def hit_depth_prompts(rng):
    """(prompt, expected local hit) pairs driven in order through one
    pool: empty tree, divergence in block 2, three shared blocks, and an
    identical resubmit (capped one block short)."""
    base = [int(t) for t in rng.integers(0, VOCAB, size=8)]
    return [(base, 0), (base[:3] + [base[3] ^ 1] + base[4:], 2),
            (base[:6] + [59, 58], 6), (base, 6)]


PROMPTS = [p for p, _ in hit_depth_prompts(np.random.default_rng(3))]
LONG = [4, 9, 14, 19, 24, 29, 34, 39]


@pytest.fixture(scope="module")
def params():
    jm = JaxLM(vocab=VOCAB, dim=DIM, depth=2, num_heads=4)
    return jax.jit(jm.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]


def port_lm(params, **kw):
    tm = TransformerLM(vocab=VOCAB, dim=DIM, depth=2, num_heads=4, **kw)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return tm.eval()


def spec(**kw):
    out = dict(slots=2, prompt_len=8, max_len=24, kv_block_size=BS,
               kv_cache_blocks=16)
    out.update(kw)
    return out


_JAX_STREAMS: dict = {}


def jax_streams(params, prompts, max_new, pages="native", **kw):
    """The JAX server's greedy streams of ``prompts``, one request at a
    time (its plain paged attention), memoised per configuration."""
    key = (tuple(map(tuple, prompts)), max_new, pages,
           tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _JAX_STREAMS:
        jm = JaxLM(vocab=VOCAB, dim=DIM, depth=2, num_heads=4,
                   kv_cache_dtype=pages)
        srv = JaxDecodeServer(jm, params, paged_kernel="xla", **spec(**kw))
        out = []
        for p in prompts:
            rid = srv.submit(p, max_new=max_new)
            out.append({c.id: c for c in srv.run_until_drained()}[rid]
                       .tokens)
        _JAX_STREAMS[key] = out
    return _JAX_STREAMS[key]


def cluster_pair(tm, ring, ns="ns-test", **kw):
    """Publisher + cold consumer sharing one ring and namespace, the
    cache attached as `serve/control.py` attaches it after warmup."""
    out = []
    for _ in range(2):
        srv = DecodeServer(tm, device="cpu", **spec(**kw))
        srv.cluster_prefix = ClusterPrefixCache(ring, ns, BS,
                                                publish_min_hits=0)
        out.append(srv)
    return out


def drive(srv, prompts, max_new):
    streams = []
    for p in prompts:
        rid = srv.submit(p, max_new=max_new)
        streams.append({c.id: c for c in srv.run_until_drained()}[rid]
                       .tokens)
    return streams


@pytest.mark.parametrize("kernel", [None, "plain"],
                         ids=["contiguous", "paged_plain"])
@pytest.mark.parametrize("pages", ["native", "int8"])
def test_remote_hit_token_exact(params, pages, kernel):
    """A cold consumer extends its (empty or shorter) local hit with the
    publisher's chain at every hit depth and serves the JAX server's
    streams; rows 0 (local none) and 1 (local shorter) remote-hit."""
    tm = port_lm(params, kv_cache_dtype=pages)
    kw = {"paged_kernel": kernel} if kernel else {}
    pub, sub = cluster_pair(tm, FakeRing(), **kw)
    want = jax_streams(params, PROMPTS, 6, pages)
    assert drive(pub, PROMPTS, 6) == want
    assert pub.cluster_prefix.published_blocks >= 4
    assert drive(sub, PROMPTS, 6) == want
    st = sub.prefix_cache_stats()
    assert st["prefix_remote_hits"] == 2
    assert st["prefix_fetch_bytes"] > 0 and st["hits"] >= 3


def test_remote_hit_prefills_only_suffix(params):
    tm = port_lm(params)
    pub, sub = cluster_pair(tm, FakeRing(), prompt_buckets=(2, 4, 8),
                            paged_kernel="plain")
    drive(pub, [LONG], 2)
    assert drive(sub, [LONG], 2) == jax_streams(params, [LONG], 2)
    assert sub.stats()["prefill_tokens"] == 2, \
        "a remote 6-token hit must drop the cold 8-bucket to the 2-bucket"
    assert sub.prefix_cache_stats()["prefix_remote_hits"] == 1


def test_warm_then_first_request_suffix_only(params):
    tm = port_lm(params)
    pub, sub = cluster_pair(tm, FakeRing(), prompt_buckets=(2, 4, 8))
    pub.cluster_prefix.note(LONG, "acme")   # serve/lm_pool.py notes it
    drive(pub, [LONG], 2)
    out = sub.prefix_warm(tenant="acme")
    assert out["fetched_blocks"] == 4
    st = sub.prefix_cache_stats()
    assert st["prefix_warm_blocks"] == 4 and st["prefix_remote_hits"] == 0
    assert drive(sub, [LONG], 2) == jax_streams(params, [LONG], 2)
    assert sub.stats()["prefill_tokens"] == 2
    probe = sub.prefix_probe(LONG)
    assert probe["remote_blocks"] == 4 and probe["local_blocks"] >= 3
    assert probe["namespace"] == "ns-test"


def test_evict_tombstone_and_force_republish(params):
    tm = port_lm(params)
    ring = FakeRing()
    pub, sub = cluster_pair(tm, ring)
    drive(pub, [LONG], 2)
    names = pub.cluster_prefix.names(LONG)
    v0 = {n: ring.stat(n)[0] for n in names}
    assert ClusterPrefixCache(ring, "ns-test", BS).evict(LONG) == 4
    for n in names:
        with pytest.raises(StoreError):
            ring.stat(n)
    assert ClusterPrefixCache(ring, "ns-test", BS).probe(LONG) == 0
    assert pub.prefix_publish(tokens=LONG)["published_blocks"] == 4
    for n in names:
        assert ring.stat(n)[0] > v0[n], "a republish must outrank the tomb"
    assert drive(sub, [LONG], 2) == jax_streams(params, [LONG], 2)
    assert sub.prefix_cache_stats()["prefix_remote_hits"] == 1


def test_miss_degrades_never_fails(params):
    class BrokenRing:
        def put_bytes(self, *a):
            raise OSError("ring down")
        get_bytes = stat = delete = put_bytes

    tm = port_lm(params)
    srv = DecodeServer(tm, device="cpu", **spec(paged_kernel="plain"))
    srv.cluster_prefix = ClusterPrefixCache(BrokenRing(), "ns", BS,
                                            publish_min_hits=0)
    assert drive(srv, PROMPTS, 6) == jax_streams(params, PROMPTS, 6)
    st = srv.prefix_cache_stats()
    assert st["prefix_remote_hits"] == 0 and st["hits"] >= 3
    assert srv.cluster_prefix.errors > 0


def test_int8_weights_static_prefix_remote_hit(params):
    """int8 weights and a pool-level static prefix: chains sit at the
    absolute positions after the prefix, and the consumer still gives the
    JAX int8 server's streams."""
    tm = port_lm(params)
    kw = dict(quantize="int8", prefix=PREFIX, max_len=32)
    pub, sub = cluster_pair(tm, FakeRing(), paged_kernel="plain", **kw)
    want = jax_streams(params, PROMPTS, 5, **kw)
    assert drive(pub, PROMPTS, 5) == want
    assert drive(sub, PROMPTS, 5) == want
    assert sub.prefix_cache_stats()["prefix_remote_hits"] == 2


def test_pool_namespace_separates_what_changes_kv(params):
    class Store:
        def put_bytes(self, name, blob):
            self.blob = blob
            return 1

        def get_bytes(self, name, version=None):
            return self.blob, 1

    store = Store()
    save_lm(store, "lm", port_lm(params))
    a, b = (load_lm(store, "lm", device="cpu") for _ in range(2))
    base = pool_namespace(a, None, "none", BS, extra="lm")
    assert pool_namespace(b, None, "none", BS, extra="lm") == base
    other = TransformerLM(vocab=VOCAB, dim=DIM, depth=2, num_heads=4)
    torch.manual_seed(7)
    for t in other.parameters():
        torch.nn.init.normal_(t)
    int8_pages = load_lm(store, "lm", device="cpu")
    int8_pages.kv_cache_dtype = "int8"
    for blk in int8_pages.blocks:
        blk.attn.kv_cache_dtype = "int8"
    srv_int8 = DecodeServer(a, device="cpu", quantize="int8", **spec())
    differ = [
        pool_namespace(other, None, "none", BS, extra="lm"),
        pool_namespace(srv_int8.model, None, "int8", BS, extra="lm"),
        pool_namespace(int8_pages, None, "none", BS, extra="lm"),
        pool_namespace(a, PREFIX, "none", BS, extra="lm"),
        pool_namespace(a, None, "none", 4, extra="lm"),
    ]
    assert base not in differ and len(set(differ)) == len(differ)
    # a training-mode flag is not KV content
    a.train()
    assert pool_namespace(a, None, "none", BS, extra="lm") == base


# -- KV handoff, prefill replica → decode replica ---------------------------


def handoff_pair(tm, **kw):
    return (DecodeServer(tm, device="cpu", **spec(**kw)),
            DecodeServer(tm, device="cpu", **spec(**kw)))


def ship(pre, dec, prompt):
    """One probe → export → adopt round trip, the manager's ship leg."""
    d0 = dec.handoff_probe(prompt)["depth"]
    exp = pre.handoff_export(prompt, from_depth=d0)
    return dec.handoff_adopt(prompt, exp["blobs"], start_depth=d0), exp


@pytest.mark.parametrize("kernel", [None, "plain"],
                         ids=["contiguous", "paged_plain"])
@pytest.mark.parametrize("pages", ["native", "int8"])
def test_handoff_token_exact_matrix(params, pages, kernel):
    """A prompt prefilled on one pool and shipped block by block to
    another decodes the JAX server's stream at every local hit depth;
    a held chain ships nothing (delta-only)."""
    tm = port_lm(params, kv_cache_dtype=pages)
    kw = {"paged_kernel": kernel} if kernel else {}
    pre, dec = handoff_pair(tm, **kw)
    want = jax_streams(params, PROMPTS, 6, pages)
    shipped = 0
    for i, prompt in enumerate(PROMPTS):
        adopt, exp = ship(pre, dec, prompt)
        shipped += exp["bytes"]
        if i < 2:
            assert exp["blocks"] > 0 and adopt["wrote"] > 0, i
        else:
            assert exp["blocks"] == 0 and exp["bytes"] == 0, i
        assert adopt["depth"] >= (len(prompt) - 1) // BS
        assert drive(dec, [prompt], 6) == [want[i]], f"row {i}"
    assert dec.stats()["kv_handoff_bytes"] == shipped
    assert pre.stats()["kv_handoff_requests"] == 2
    assert pre.stats()["tokens_generated"] == 0


def test_handoff_zero_reprefill_for_shipped_blocks(params):
    tm = port_lm(params)
    pre, dec = handoff_pair(tm, prompt_buckets=(2, 4, 8),
                            paged_kernel="plain")
    adopt, exp = ship(pre, dec, LONG)
    assert adopt["wrote"] == 3 and adopt["depth"] == 3
    again = dec.handoff_adopt(LONG, exp["blobs"], start_depth=exp["depth"])
    assert again["wrote"] == 0 and again["depth"] == 3
    assert drive(dec, [LONG], 2) == jax_streams(params, [LONG], 2)
    assert dec.stats()["prefill_tokens"] == 2
    assert pre.stats()["kv_handoff_requests"] == 1
    assert pre.stats()["prefill_tokens"] > 0


def test_handoff_validation_and_fallback_counter(params):
    tm = port_lm(params)
    plain = DecodeServer(tm, device="cpu", slots=2, prompt_len=8, max_len=24)
    with pytest.raises(ValueError, match="KV block tier"):
        plain.handoff_probe([1, 2, 3])
    with pytest.raises(ValueError, match="cluster prefix cache"):
        plain.prefix_probe([1, 2, 3])
    pre, dec = handoff_pair(tm)
    exp = pre.handoff_export(LONG)
    with pytest.raises(ValueError, match="full blocks"):
        dec.handoff_adopt(LONG, exp["blobs"], start_depth=4)
    with pytest.raises(ValueError, match="token mismatch"):
        dec.handoff_adopt([9] * 8, exp["blobs"], start_depth=0)
    assert dec.handoff_fallback()["fallbacks"] == 1
    assert dec.stats()["kv_handoff_fallbacks"] == 1


def test_handoff_lands_mid_serve_all_streams_exact(params):
    """A long prompt's chain grafts between steps of a pool whose rows
    are mid-flight; every stream (prior rows, the handed-off prompt, a
    later arrival) equals the JAX server's."""
    tm = port_lm(params)
    rng = np.random.default_rng(11)
    pre, dec = handoff_pair(tm, paged_kernel="plain")
    ids = {}
    for n, m in [(3, 6), (5, 4)]:
        p = [int(t) for t in rng.integers(0, VOCAB, size=n)]
        ids[dec.submit(p, max_new=m)] = (p, m)
    for _ in range(2):
        dec.step()
    long_p = [int(t) for t in rng.integers(0, VOCAB, size=8)]
    adopt, exp = ship(pre, dec, long_p)
    assert adopt["depth"] == 3 and exp["bytes"] > 0
    ids[dec.submit(long_p, max_new=6)] = (long_p, 6)
    late = [int(t) for t in rng.integers(0, VOCAB, size=4)]
    ids[dec.submit(late, max_new=5)] = (late, 5)
    done = {c.id: c.tokens for c in dec.run_until_drained()}
    assert set(done) == set(ids)
    for rid, (p, m) in ids.items():
        assert done[rid] == jax_streams(params, [p], m)[0], rid
    assert pre.stats()["kv_handoff_requests"] == 1
    assert dec.stats()["kv_handoff_bytes"] == exp["bytes"]
    assert dec.stats()["kv_handoff_fallbacks"] == 0


@pytest.mark.parametrize("kernel", [None, "plain"],
                         ids=["contiguous", "paged_plain"])
def test_handoff_export_matches_jax_export(params, kernel):
    """One prompt's export from the port's pool and from the JAX pool:
    the same number of blobs, equal meta, one leaf per K/V name with
    equal (depth-stacked) shapes, K/V within EXPORT_ATOL. The JAX blob
    keys its leaves by tree path (``['attn']['cached_k']``), the port's by
    leaf name."""
    tm = port_lm(params)
    jm = JaxLM(vocab=VOCAB, dim=DIM, depth=2, num_heads=4)
    kw = {"paged_kernel": kernel} if kernel else {}
    jkw = {"paged_kernel": "xla"} if kernel else {}
    jsrv = JaxDecodeServer(jm, params, **spec(**jkw))
    srv = DecodeServer(tm, device="cpu", **spec(**kw))
    # a two-block local hit first, so the export's fill runs the
    # hit-prefill branch (paged: the suffix attends the hit through the
    # block table)
    for s in (jsrv, srv):
        s.submit(LONG[:5], max_new=2)
        s.run_until_drained()
    jexp = jsrv.handoff_export(LONG)
    exp = srv.handoff_export(LONG)
    assert exp["blocks"] == jexp["blocks"] == 3
    for blob, jblob in zip(exp["blobs"], jexp["blobs"]):
        meta, got = decode_block(blob)
        jmeta, jgot = jax_decode_block(jblob)
        assert meta == jmeta
        assert len(got) == len(jgot)
        for name, t in got.items():
            keys = [k for k in jgot if k.endswith(f"['{name}']")]
            assert len(keys) == 1, (name, list(jgot))
            want = np.asarray(jgot[keys[0]])
            assert tuple(t.shape) == want.shape, name
            np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                       atol=EXPORT_ATOL, err_msg=name)
