"""Speculative pools under tensor parallelism: the port against the JAX
package, on the CPU.

A port ``DecodeServer(n_model=2|4, draft=(draft, None))`` on a virtual
mesh of the one CPU, on a contiguous and a paged pool (the plain paged
attention per model shard here, K3 per shard on a card), against the JAX
package's paged ``DecodeServer(n_model=2, draft=(draft, params))`` on the
conftest's eight host devices (one JAX pool a draft for the module), on
weights carried across (``models/convert.py``),
with a draft that shards (4 heads: its own ``ShardedLM``) and one that does
not (dim 24, 3 heads, over 2 shards: a ``ShardedLM`` over the data groups'
lead devices, one whole replica a group). Greedy
streams equal the JAX package's and their log-probabilities agree within
1e-4. Sampled rows draw from ``torch.Generator``\\ s, whose bits are not
``jax.random``'s, so a seeded sampled stream is held to the port's own
n_model 1 pool. Speculation is lossless: a draft cut or joined wrongly
still yields the greedy stream, with fewer tokens accepted. So the
proposals and the accepted count of every round (recorded at the pool's
commit, ``chip_smoke.py:record_rounds``) are held to the n_model 1 pool's too. Then a (data, model) mesh, a static prefix, a
routed draft, the stats, and the refusals the JAX package keeps. Small
models: dim 32, depth 2, vocab 64, 4 heads; draft dim 16, depth 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.engine.serve_lm import DecodeServer as JaxDecodeServer
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from chip_smoke import record_rounds
from idunno_tpu_torch.engine.serve_lm import DecodeServer
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.moe import MoETransformerLM
from idunno_tpu_torch.models.transformer import ShardedLM, TransformerLM
from idunno_tpu_torch.parallel.mesh import virtual_mesh
from tests.torch_workers import share_cores  # noqa: F401

VOCAB, GAMMA, BS = 64, 3, 2
TARGET = dict(vocab=VOCAB, dim=32, depth=2, num_heads=4)
DRAFTS = {"sharded": dict(vocab=VOCAB, dim=16, depth=1, num_heads=4),
          "replicated": dict(vocab=VOCAB, dim=24, depth=1, num_heads=3)}
PAGED = dict(kv_block_size=BS, kv_cache_blocks=32)
GREEDY = [([5, 11, 17, 3, 9], 10), ([5, 11, 17, 3, 40, 2], 8),
          ([7, 1], 12)]
SAMPLED = ([4, 17, 2], 10, dict(temperature=0.8, top_p=0.9, seed=21))


def _carry(seed: int, **kw):
    jm = JaxLM(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(**kw)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def target():
    return _carry(0, **TARGET)


@pytest.fixture(scope="module")
def drafts():
    return {name: _carry(1 + i, **kw)
            for i, (name, kw) in enumerate(DRAFTS.items())}


@pytest.fixture(scope="module")
def jax_served(target, drafts):
    """One JAX pool a draft for the module: the JAX package's speculative
    pool at n_model 2 on a paged pool, its greedy completions by request.
    A lossless greedy stream and its log-probabilities do not depend on
    the pool's layout, so every case of a draft is held to this pool."""
    jm, params, _ = target
    out = {}
    for name, (jdm, dparams, _) in drafts.items():
        jsrv = JaxDecodeServer(jm, params, slots=2, prompt_len=8,
                               max_len=40, draft=(jdm, dparams),
                               draft_len=GAMMA, n_model=2,
                               track_logprobs=True, paged_kernel="xla",
                               **PAGED)
        jids = [jsrv.submit(p, max_new=n) for p, n in GREEDY]
        done = {c.id: c for c in jsrv.run_until_drained()}
        out[name] = [done[j] for j in jids]
    return out


def port_pool(tm, dm, n_model=1, paged=False, **kw):
    base = dict(slots=2, prompt_len=8, max_len=40, draft=(dm, None),
                draft_len=GAMMA, n_model=n_model, track_logprobs=True,
                device="cpu")
    if paged:
        base.update(PAGED, paged_kernel="auto")
    base.update(kw)
    srv = DecodeServer(tm, **base)
    srv.rounds = []
    return srv


def serve(srv, reqs) -> list:
    with record_rounds(srv, srv.rounds):
        ids = [srv.submit(p, max_new=n, **kw) for p, n, kw in reqs]
        done = {c.id: c for c in srv.run_until_drained()}
    return [done[i] for i in ids]


def same_rounds(a: list, b: list) -> bool:
    """Equal proposals and accepted counts on the live rows of every
    round of two pools' logs (`record_rounds`)."""
    return len(a) == len(b) and all(
        torch.equal(pa[act], pb[act]) and torch.equal(aa[act], ab[act])
        and torch.equal(act, bct)
        for (pa, aa, act), (pb, ab, bct) in zip(a, b))


CASES = [(2, False, "sharded"), (4, True, "sharded"),
         (2, False, "replicated"), (2, True, "replicated")]


@pytest.mark.parametrize("n_model,paged,draft", CASES,
                         ids=[f"n{n}-{'paged' if p else 'contiguous'}-{d}"
                              for n, p, d in CASES])
def test_tp_speculative_pool_matches_jax(target, drafts, jax_served,
                                         n_model, paged, draft):
    """Greedy streams equal the JAX package's TP speculative pool's with
    the same draft (log-probabilities within 1e-4); the seeded sampled
    stream, every round's proposals and accepted counts, and the streams
    equal the port's n_model 1 speculative pool's; the draft decodes
    through the decoder the JAX placement gives it."""
    _, _, tm = target
    _, _, dm = drafts[draft]
    reqs = [(p, n, {}) for p, n in GREEDY]
    srv = port_pool(tm, dm, n_model, paged)
    want_shards = n_model if draft == "sharded" else 1
    assert isinstance(srv._draft_dec, ShardedLM) and srv.n_model == n_model
    assert srv._draft_dec.n_model == want_shards
    got = serve(srv, reqs)
    for c, want in zip(got, jax_served[draft]):
        assert c.tokens == want.tokens
        np.testing.assert_allclose(c.logprobs, want.logprobs,
                                   atol=1e-4, rtol=0)
    if paged:
        assert srv.prefix_cache_stats()["hits"] > 0
    one = port_pool(tm, dm, 1, paged)
    ref = serve(one, reqs)
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    assert same_rounds(srv.rounds, one.rounds)
    log_tp, log_one = len(srv.rounds), len(one.rounds)
    s_tp, s_one = serve(srv, [SAMPLED]), serve(one, [SAMPLED])
    assert s_tp[0].tokens == s_one[0].tokens
    assert same_rounds(srv.rounds[log_tp:], one.rounds[log_one:])
    np.testing.assert_allclose(s_tp[0].logprobs, s_one[0].logprobs,
                               atol=1e-4, rtol=0)


def test_reversed_draft_shards_keep_the_stream_not_the_rounds(target,
                                                               drafts):
    """The gate the stream cannot give: a sharded draft whose vocab parts
    are joined in reverse shard order proposes other tokens, so the rounds
    differ from n_model 1's while the greedy stream (lossless) does not."""
    _, _, tm = target
    _, _, dm = drafts["sharded"]
    reqs = [(p, n, {}) for p, n in GREEDY]
    one = port_pool(tm, dm, 1)
    ref = serve(one, reqs)
    bad = port_pool(tm, dm, 2)
    inner = bad._draft_dec.decode_apply

    def reversed_parts(*args, **kw):
        out = inner(*args, **kw)
        out.parts.reverse()
        return out

    bad._draft_dec.decode_apply = reversed_parts
    got = serve(bad, reqs)
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    assert not same_rounds(bad.rounds, one.rounds)


def test_tp_speculative_pool_over_a_data_and_model_mesh(target, drafts):
    """A 2 x 2 (data, model) mesh: slots over the data groups, each row's
    draft and target on its group's devices (the sharded draft's cache a
    `ShardedCache`, the other draft one whole replica a group), with a
    static prefix both models prefill once: the n_model 1 pool's streams
    and rounds."""
    _, _, tm = target
    reqs = [(p, n, {}) for p, n in GREEDY] + [([9, 9, 2], 9, {})]
    for name in ("sharded", "replicated"):
        dm = drafts[name][2]
        kw = dict(slots=4, prefix=[20, 21, 22])
        srv = port_pool(tm, dm, mesh=virtual_mesh(2, 2, "cpu"), **kw)
        assert srv._draft_dec.n_data == 2
        one = port_pool(tm, dm, **kw)
        got, ref = serve(srv, reqs), serve(one, reqs)
        assert [c.tokens for c in got] == [c.tokens for c in ref], name
        assert same_rounds(srv.rounds, one.rounds), name
        cfg = srv.stats()["config"]
        assert cfg["speculative_draft_len"] == GAMMA and cfg["n_model"] == 2
        assert srv.stats()["dispatches"] < srv.stats()["tokens_generated"]


def test_routed_draft_and_the_refusals_kept(target):
    """A routed draft does not shard: it runs as one replica on the lead
    for the whole batch (the rows route together, as the JAX package
    routes them), serving the n_model 1 pool's streams. The JAX package's
    refusals stay: a routed target (speculative or under TP:
    ``tests/test_torch_tp_decode.py``), a draft of another vocab, a
    non-causal draft, ``draft_len`` 0, penalties on a speculative pool."""
    _, _, tm = target
    moe = MoETransformerLM(vocab=VOCAB, dim=16, depth=1, num_heads=2,
                           n_experts=2)
    init_like_flax(moe, torch.Generator().manual_seed(3))
    reqs = [(p, n, {}) for p, n in GREEDY]
    srv = port_pool(tm, moe.eval(), 2)
    assert srv._draft_dec is srv._draft_model
    assert [c.tokens for c in serve(srv, reqs)] == [
        c.tokens for c in serve(port_pool(tm, moe, 1), reqs)]
    routed = MoETransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4,
                              n_experts=2)
    with pytest.raises(ValueError, match="dense target"):
        port_pool(routed, tm, 2)
    small = TransformerLM(vocab=VOCAB - 1, dim=16, depth=1, num_heads=4)
    with pytest.raises(ValueError, match="draft vocab"):
        port_pool(tm, small, 2)
    noncausal = TransformerLM(vocab=VOCAB, dim=16, depth=1, num_heads=4,
                              causal=False)
    with pytest.raises(ValueError, match="causal"):
        port_pool(tm, noncausal, 2)
    with pytest.raises(ValueError, match="draft_len"):
        port_pool(tm, tm, 2, draft_len=0)
    with pytest.raises(ValueError, match="penalties"):
        port_pool(tm, tm, 2, penalties=True)
