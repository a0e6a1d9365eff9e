"""Speculative decoding in the port's ``DecodeServer`` against the JAX
package, on the CPU.

The commit math first: `greedy_commit` and the greedy lane of
`spec_commit` are bit-equal to the JAX functions, and the sampled lane
keeps the target distribution exactly (a chi-square test over the first
committed token with a skewed draft, unfiltered, nucleus and top-k, as
``tests/test_serve_lm.py`` holds the JAX lane; the port draws from
``torch.Generator``s, so its bits cannot match ``jax.random``'s). Then the
pool: with ``draft == target`` its greedy streams equal the JAX package's
``DecodeServer(draft=..., draft_len=3)`` and the port's own plain pool, on
dense, paged (the radix cache, K3 through its plain version against the
JAX ``paged_kernel="xla"`` server) and int8 pools; a weak draft, fused
rounds, EOS, stops, logprobs, the static prefix and chunked prefill keep
the streams exact; and every refusal raises. Small model: dim 32, depth
2, vocab 61, f32; the weak draft dim 16, depth 1, 2 heads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from idunno_tpu.engine.serve_lm import DecodeServer as JaxDecodeServer
from idunno_tpu.engine.serve_lm import greedy_commit as jax_greedy_commit
from idunno_tpu.engine.serve_lm import spec_commit as jax_spec_commit
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.ops.sampling import filtered_probs as jax_filtered_probs
from idunno_tpu.ops.sampling import nucleus_probs as jax_nucleus_probs
from idunno_tpu.ops.sampling import safe_log as jax_safe_log
from idunno_tpu_torch.engine.generate import generate
from idunno_tpu_torch.engine.serve_lm import (DecodeServer, greedy_commit,
                                              resolve_decode_graph,
                                              spec_commit)
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.ops.sampling import (draw_sampled, filtered_probs,
                                           nucleus_probs, safe_log)
from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload
from tests.torch_workers import share_cores  # noqa: F401

VOCAB, BS, GAMMA = 61, 2, 3


def _carry(jm, seed, **kw):
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, **kw)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return params, tm.eval()


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    params, tm = _carry(jm, 0, dim=32, depth=2, num_heads=4)
    return jm, params, tm


@pytest.fixture(scope="module")
def weak():
    jm = JaxLM(vocab=VOCAB, dim=16, depth=1, num_heads=2)
    return _carry(jm, 99, dim=16, depth=1, num_heads=2)[1]


@pytest.fixture(scope="module")
def workload():
    return prefix_bench_workload({"prompt_len": 8, "vocab": VOCAB,
                                  "slots": 2}, BS)


def expected(tm, prompt, max_new):
    return generate(tm, torch.tensor([prompt]), len(prompt),
                    max_new)[0].tolist()


def spec_pool(tm, draft, **kw):
    base = dict(slots=2, prompt_len=8, max_len=40, draft=(draft, None),
                draft_len=GAMMA, device="cpu")
    base.update(kw)
    return DecodeServer(tm, **base)


def serve(srv, reqs):
    """Submit ``(prompt, max_new, kwargs)`` requests; their completions in
    order."""
    ids = [srv.submit(p, max_new=n, **kw) for p, n, kw in reqs]
    done = {c.id: c for c in srv.run_until_drained()}
    return [done[i] for i in ids]


# -- the commit math ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_commit_bit_equal_to_jax(seed):
    """`greedy_commit` and the greedy lane of `spec_commit` give the JAX
    functions' candidates and accepted counts on seeded proposals and
    target argmaxes (every accepted count from 0 to γ occurs)."""
    rng = np.random.default_rng(seed)
    s, gamma, v = 64, 4, 4
    props = rng.integers(0, v, (s, gamma)).astype(np.int32)
    tpred = rng.integers(0, v, (s, gamma + 1)).astype(np.int32)
    # row i agrees with the target's argmaxes on its first i % (γ+1)
    # positions and misses the next, so every accepted count occurs
    for i in range(s):
        k = i % (gamma + 1)
        props[i, :k] = tpred[i, :k]
        if k < gamma:
            props[i, k] = (tpred[i, k] + 1) % v
    want_c, want_a = jax_greedy_commit(jnp.asarray(props), jnp.asarray(tpred))
    got_c, got_a = greedy_commit(torch.from_numpy(props).long(),
                                 torch.from_numpy(tpred).long())
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_a.numpy(), np.asarray(want_a))
    assert set(got_a.tolist()) == set(range(gamma + 1))

    qd = rng.dirichlet(np.ones(v), (s, gamma)).astype(np.float32)
    pd = rng.dirichlet(np.ones(v), (s, gamma + 1)).astype(np.float32)
    u = rng.random((s, gamma)).astype(np.float32)
    sampled = np.zeros(s, bool)
    jc, ja = jax_spec_commit(jnp.asarray(props), jnp.asarray(qd),
                             jnp.asarray(pd), jnp.asarray(tpred),
                             jnp.asarray(sampled), jnp.asarray(u),
                             jax.random.split(jax.random.PRNGKey(seed), s))
    tc, ta = spec_commit(torch.from_numpy(props).long(), torch.from_numpy(qd),
                         torch.from_numpy(pd), torch.from_numpy(tpred).long(),
                         torch.from_numpy(sampled), torch.from_numpy(u),
                         [None] * s)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ta.numpy(), np.asarray(ja))


P_RAW = np.log(np.array([0.05, 0.45, 0.10, 0.25, 0.15], np.float32))
Q_RAW = np.log(np.array([0.50, 0.05, 0.20, 0.05, 0.20], np.float32))


@pytest.mark.parametrize("filt", ["none", "nucleus", "top_k"])
def test_spec_commit_keeps_the_target_distribution(filt):
    """The first committed token of a sampled row is distributed exactly
    as the (filtered) target distribution p, whatever the draft q: 20,000
    rows of one `spec_commit` call, proposals drawn from a q very unlike
    p; a chi-square test over p's support (p-value > 1e-3) and no token
    outside it. q and p are filtered by the port's functions, which agree
    with the JAX package's."""
    gamma, trials = 3, 20_000
    p_t, q_t = torch.from_numpy(P_RAW)[None], torch.from_numpy(Q_RAW)[None]
    if filt == "none":
        pf, qf = torch.softmax(p_t, -1), torch.softmax(q_t, -1)
    elif filt == "nucleus":
        top_p = torch.tensor([0.75])
        pf, qf = nucleus_probs(p_t, top_p), nucleus_probs(q_t, top_p)
        want = jax_nucleus_probs(jnp.asarray(P_RAW)[None], jnp.asarray([0.75]))
        np.testing.assert_allclose(pf.numpy(), np.asarray(want), atol=1e-6)
    else:
        top_p, top_k = torch.tensor([0.9]), torch.tensor([3])
        pf = filtered_probs(p_t, top_p, top_k)
        qf = filtered_probs(q_t, top_p, top_k)
        want = jax_filtered_probs(jnp.asarray(P_RAW)[None],
                                  jnp.asarray([0.9]), jnp.asarray([3]))
        np.testing.assert_allclose(pf.numpy(), np.asarray(want), atol=1e-6)
    pf, qf = pf[0], qf[0]
    if filt != "none":
        assert int((pf == 0).sum()) >= 2          # the filter really cut
    rng = np.random.default_rng({"none": 0, "nucleus": 1, "top_k": 2}[filt])
    v = pf.shape[0]
    qn = qf.double().numpy()
    props = torch.from_numpy(rng.choice(v, (trials, gamma), p=qn / qn.sum()))
    qd = qf.expand(trials, gamma, v)
    pd = pf.expand(trials, gamma + 1, v)
    tpred = pd.argmax(-1)
    u = torch.from_numpy(rng.random((trials, gamma)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    cand, _ = spec_commit(props, qd, pd, tpred,
                          torch.ones(trials, dtype=torch.bool), u,
                          [gen] * trials)
    counts = np.bincount(cand[:, 0].numpy(), minlength=v)
    p = pf.double().numpy()
    assert counts[p == 0].sum() == 0
    support = p > 0
    chi2, pval = sps.chisquare(counts[support], trials * p[support]
                               / p[support].sum())
    assert pval > 1e-3, (counts, p, chi2)


def test_sampling_helpers_match_jax():
    """`safe_log` is exact -inf off the support; `nucleus_probs` keeps the
    smallest mass-reaching prefix; `draw_sampled` never draws a zero-
    probability token and follows each row's own generator."""
    probs = np.array([[0.5, 0.3, 0.15, 0.05], [0.0, 0.7, 0.0, 0.3]],
                     np.float32)
    got = safe_log(torch.from_numpy(probs)).numpy()
    want = np.asarray(jax_safe_log(jnp.asarray(probs)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-6)
    out = nucleus_probs(torch.log(torch.from_numpy(probs[:1])),
                        torch.tensor([0.6]))[0].numpy()
    np.testing.assert_allclose(out, [0.625, 0.375, 0.0, 0.0], atol=1e-6)
    gens = [torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)]
    rows = torch.from_numpy(np.repeat(probs[1:], 2, axis=0))
    draws = torch.stack([draw_sampled(rows, gens) for _ in range(200)])
    assert set(draws.flatten().tolist()) <= {1, 3}
    again = [torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)]
    assert torch.equal(draws[0], draw_sampled(rows, again))


# -- the speculative pool -------------------------------------------------


def test_spec_streams_equal_jax_spec_pool_and_plain_pool(lm):
    """draft == target: the greedy streams equal the JAX package's
    speculative pool on the same weights and the port's plain pool, and a
    round commits draft_len + 1 tokens, so dispatches fall well below the
    tokens generated."""
    jm, params, tm = lm
    reqs = [([3, 1, 4], 12, {}), ([5, 9, 2, 6], 10, {}), ([7], 9, {}),
            ([2, 7, 1, 8, 2, 8], 11, {})]
    jsrv = JaxDecodeServer(jm, params, slots=2, prompt_len=8, max_len=40,
                           draft=(jm, params), draft_len=GAMMA)
    jids = [jsrv.submit(p, max_new=n) for p, n, _ in reqs]
    jdone = {c.id: c.tokens for c in jsrv.run_until_drained()}
    srv = spec_pool(tm, tm)
    got = [c.tokens for c in serve(srv, reqs)]
    plain = DecodeServer(tm, slots=2, prompt_len=8, max_len=40, device="cpu")
    assert got == [jdone[i] for i in jids]
    assert got == [c.tokens for c in serve(plain, reqs)]
    st = srv.stats()
    assert st["dispatches"] * 2 < st["tokens_generated"]
    assert st["config"]["speculative_draft_len"] == GAMMA
    assert plain.stats()["config"]["speculative_draft_len"] is None
    assert srv.graph_stats() == {"replayed": 0, "eager": st["dispatches"],
                                 "mode": "eager", "graph_pool_bytes": 0,
                                 "launches_per_replay": {}}


def test_weak_draft_and_fused_rounds_stay_exact(lm, weak):
    """A weak draft (dim 16, depth 1, 2 heads) still gives the target's
    greedy streams; ``decode_steps=3`` rounds a dispatch give the
    one-round streams (greedy and a seeded nucleus row) in fewer
    dispatches, for the weak draft and for draft == target."""
    _, _, tm = lm
    reqs = [([3, 1, 4], 12, {}),
            ([3, 1, 4], 12, dict(temperature=0.9, top_p=0.8, seed=7))]
    for draft in (weak, tm):
        one = spec_pool(tm, draft, decode_steps=1)
        fused = spec_pool(tm, draft, decode_steps=3)
        a, b = serve(one, reqs), serve(fused, reqs)
        assert a[0].tokens == b[0].tokens == expected(tm, [3, 1, 4], 12)
        assert a[1].tokens == b[1].tokens
        assert fused.stats()["dispatches"] < one.stats()["dispatches"]


def test_eos_stop_and_logprobs_on_a_spec_pool(lm, weak):
    """EOS retires a speculative row where it retires a plain one, a stop
    sequence truncates it the same way (the scan covers a dispatch's
    rounds), and the tracked logprobs agree with the plain pool's."""
    _, _, tm = lm
    p = [3, 1, 4, 1, 5]
    free = expected(tm, p, 12)
    gen = free[len(p):]
    for eos in (gen[1], gen[6]):
        got = serve(spec_pool(tm, weak, eos_id=eos), [(p, 12, {})])[0]
        want = serve(DecodeServer(tm, slots=2, prompt_len=8, max_len=40,
                                  eos_id=eos, device="cpu"), [(p, 12, {})])[0]
        assert got.tokens == want.tokens == free[:len(p) + gen.index(eos) + 1]
    reqs = [(p, 12, dict(stop=[gen[4:6]])), (p, 12, {})]
    spec = serve(spec_pool(tm, tm, track_logprobs=True, decode_steps=2), reqs)
    plain = serve(DecodeServer(tm, slots=2, prompt_len=8, max_len=40,
                               track_logprobs=True, device="cpu"), reqs)
    assert spec[0].tokens == plain[0].tokens == free[:len(p) + 6]
    assert spec[1].tokens == free
    np.testing.assert_allclose(spec[1].logprobs, plain[1].logprobs,
                               rtol=1e-4, atol=1e-5)


def test_prefix_and_chunked_prefill_on_a_spec_pool(lm, weak):
    """The draft's own prefix cache and its prompt prefill at admission:
    a static prefix and chunked prefill keep the greedy streams exact."""
    _, _, tm = lm
    prefix = [5, 9, 11]
    srv = spec_pool(tm, weak, prefix=prefix, prefill_chunk=3,
                    kv_block_size=BS, paged_kernel="plain",
                    kv_cache_blocks=12)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 4, 8], [7, 7, 7]]
    done = serve(srv, [(q, 6, {}) for q in prompts])
    for c, q in zip(done, prompts):
        assert c.tokens == expected(tm, prefix + q, 6)
    assert srv.stats()["prefill_chunks"] > len(prompts)


def pool_kw(buckets, **kw):
    return dict(slots=2, prompt_len=8, max_len=24, prompt_buckets=buckets,
                kv_block_size=BS, kv_cache_blocks=(2 + 1) * 4,
                decode_steps=2, **kw)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_paged_spec_pool_matches_jax(lm, workload, quantize):
    """A paged radix-cache speculative pool (K3 through its plain
    version; draft == target, as the JAX bench's draft carries the
    target's weights here) against the JAX speculative pool with
    ``paged_kernel="xla"``, dense and int8 target weights: equal greedy
    streams and radix hits, and equal to the port's plain paged pool."""
    jm, params, tm = lm
    prompts, _, buckets = workload
    kw = pool_kw(buckets, draft_len=GAMMA, quantize=quantize)
    jsrv = JaxDecodeServer(jm, params, paged_kernel="xla",
                           draft=(jm, params), **kw)
    jids = [jsrv.submit(p, max_new=6) for p in prompts]
    jdone = {c.id: c.tokens for c in jsrv.run_until_drained()}
    srv = DecodeServer(tm, paged_kernel="auto", draft=(tm, None),
                       device="cpu", **kw)
    got = serve(srv, [(p, 6, {}) for p in prompts])
    assert [c.tokens for c in got] == [jdone[i] for i in jids]
    hits = srv.prefix_cache_stats()["hits"]
    assert hits == jsrv.prefix_cache_stats()["hits"] and hits > 0
    plain = DecodeServer(tm, paged_kernel="auto", device="cpu",
                         **pool_kw(buckets, quantize=quantize))
    assert [c.tokens for c in got] == [
        c.tokens for c in serve(plain, [(p, 6, {}) for p in prompts])]


def test_sampled_spec_requests_complete(lm, weak):
    """Sampled, top-k and top-p requests on a speculative pool complete
    with in-vocab tokens, reproducibly from their seeds, while a
    co-resident greedy row stays on the target's greedy stream."""
    _, _, tm = lm
    reqs = [([3, 1, 4], 10, dict(temperature=0.9, seed=123)),
            ([3, 1, 4], 10, dict(temperature=0.7, top_k=5, seed=5)),
            ([2, 7], 10, dict(temperature=1.1, top_p=0.7, seed=9)),
            ([3, 1, 4], 10, {})]
    a = serve(spec_pool(tm, weak, slots=3), reqs)
    b = serve(spec_pool(tm, weak, slots=3), reqs)
    for c, (p, n, _) in zip(a, reqs):
        assert len(c.tokens) == len(p) + n
        assert all(0 <= t < VOCAB for t in c.tokens)
    assert [c.tokens for c in a] == [c.tokens for c in b]
    assert a[3].tokens == expected(tm, [3, 1, 4], 10)


def test_spec_refusals_raise(lm, weak):
    """The JAX package's refusals: draft_len < 1, a non-causal draft, a
    vocab mismatch, a routed-FFN target, penalties, params in the tuple,
    and the draft_len + 1 headroom in `validate`; a speculative pool under
    tensor parallelism keeps every one of them (and otherwise serves:
    ``tests/test_torch_tp_spec.py``), and a ``mesh`` that is not a
    ``parallel/mesh.py:Mesh`` raises typed."""
    _, _, tm = lm
    bidir = TransformerLM(vocab=VOCAB, dim=16, depth=1, num_heads=2,
                          causal=False)
    other = TransformerLM(vocab=VOCAB + 1, dim=16, depth=1, num_heads=2)
    routed = TransformerLM(vocab=VOCAB, dim=16, depth=1, num_heads=2)
    routed.ffn_factory = object()
    cases = [(dict(draft=(weak, None), draft_len=0), "draft_len"),
             (dict(draft=(bidir, None)), "causal"),
             (dict(draft=(other, None)), "vocab"),
             (dict(draft=(weak, {"w": 1})), "module"),
             (dict(draft=(weak, None), penalties=True), "penalties")]
    base = dict(slots=2, prompt_len=8, max_len=24, device="cpu")
    for extra, match in cases:
        with pytest.raises(ValueError, match=match):
            DecodeServer(tm, **base, **extra)
    with pytest.raises(ValueError, match="dense target"):
        DecodeServer(routed, draft=(weak, None), **base)
    from idunno_tpu_torch.parallel.mesh import virtual_mesh
    for extra in (dict(n_model=2), dict(mesh=virtual_mesh(1, 2, "cpu"))):
        for case, match in cases:
            with pytest.raises(ValueError, match=match):
                DecodeServer(tm, **base, **extra, **case)
        assert DecodeServer(tm, draft=(weak, None), **base,
                            **extra).n_model == 2
    with pytest.raises(TypeError, match="Mesh"):
        DecodeServer(tm, draft=(weak, None), **base, mesh=object())
    srv = DecodeServer(tm, draft=(weak, None), draft_len=GAMMA, **base)
    srv.validate([1, 2, 3], max_new=24 - 3 - GAMMA - 1)
    with pytest.raises(ValueError, match="speculative headroom"):
        srv.validate([1, 2, 3], max_new=24 - 3 - GAMMA)
    assert srv.warmup() > 0


def test_decode_graph_resolves_and_refuses_the_cpu(lm):
    """``decode_graph``: ``auto`` is ``eager`` on the CPU and ``graph`` on
    a CUDA device; ``graph`` on the CPU raises, as does an unknown mode;
    an eager pool counts its dispatches as eager."""
    _, _, tm = lm
    assert resolve_decode_graph("auto", torch.device("cpu")) == "eager"
    assert resolve_decode_graph("auto", torch.device("cuda")) == "graph"
    assert resolve_decode_graph("eager", torch.device("cuda")) == "eager"
    base = dict(slots=2, prompt_len=8, max_len=24, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        DecodeServer(tm, decode_graph="graph", **base)
    with pytest.raises(ValueError, match="auto\\|graph\\|eager"):
        DecodeServer(tm, decode_graph="cuda", **base)
    srv = DecodeServer(tm, **base)
    assert srv.decode_graph == "eager"
    done = serve(srv, [([3, 1, 4], 5, {})])
    assert done[0].tokens == expected(tm, [3, 1, 4], 5)
    g = srv.graph_stats()
    assert g["eager"] == srv.stats()["dispatches"] > 0 and g["replayed"] == 0
