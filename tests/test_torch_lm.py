"""Parity of the port's TransformerLM, generation and sampling with the
JAX package, on the CPU.

Small models (dim 32, depth 2, vocab 61) in f32. The JAX parameters come
from the JAX package's own init and are carried into the port by
``lm_state_dict_from_flax``; inputs are seeded numpy arrays. Greedy
streams must match token for token; the sampling keep mask must match
exactly on identical logits; sampled streams cannot match (torch and
``jax.random`` give different bits), so the sampler is held to its
distribution with a chi-square test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.engine.generate import generate as jax_generate
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.models.transformer import rope as jax_rope
from idunno_tpu.ops import sampling as jax_sampling
from idunno_tpu_torch.engine.generate import (generate, init_cache,
                                              stepwise_logits)
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.transformer import (TransformerLM, decode_apply,
                                                 make_attn_fn, rope)
from idunno_tpu_torch.ops import sampling
from tests.torch_workers import share_cores  # noqa: F401

VOCAB, DIM, DEPTH, HEADS = 61, 32, 2, 4


def carried(num_kv_heads=None, kv_cache_dtype="native", seed=0):
    """(jax model, jax params, port model with the same weights)."""
    jm = JaxLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
               num_kv_heads=num_kv_heads, kv_cache_dtype=kv_cache_dtype)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                       num_kv_heads=num_kv_heads,
                       kv_cache_dtype=kv_cache_dtype)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def mha():
    return carried()


@pytest.fixture(scope="module")
def gqa():
    return carried(num_kv_heads=2, seed=1)


def tokens(seed, b=3, t=11):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t))


@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_forward_logits_match_jax(kind, mha, gqa):
    """Weight carry + full forward: logits within 1e-4 of the largest
    |logit| (f32 both sides; matmul order differs)."""
    jm, params, tm = mha if kind == "mha" else gqa
    toks = tokens(1)
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 11, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_forward_through_auto_attention_on_cpu(mha):
    _, _, tm = mha
    toks = torch.from_numpy(tokens(2))
    with torch.no_grad():
        ref = tm(toks)
        tm.set_attn_fn(make_attn_fn("auto"))
        try:
            got = tm(toks)
        finally:
            tm.set_attn_fn(make_attn_fn("full"))
    assert torch.equal(got, ref)


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 5)).astype(np.float32)
    for p in (None, pos[0], pos):
        want = np.asarray(jax_rope(jnp.asarray(x), positions=None if p is None
                                   else jnp.asarray(p)))
        got = rope(torch.from_numpy(x), positions=None if p is None
                   else torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["mha", "gqa", "int8"])
def test_generate_greedy_token_exact_vs_jax(kind, mha, gqa):
    if kind == "int8":
        jm, params, tm = carried(num_kv_heads=2, kv_cache_dtype="int8",
                                 seed=2)
    else:
        jm, params, tm = mha if kind == "mha" else gqa
    prompt = tokens(4, t=7)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 7, 12))
    got = generate(tm, torch.from_numpy(prompt), 7, 12).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_ragged_and_penalized_token_exact_vs_jax(mha):
    jm, params, tm = mha
    prompt = tokens(5, t=6)
    lens = np.array([6, 3, 1])
    kw = dict(presence_penalty=0.7, frequency_penalty=0.3)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 6, 10,
                                   prompt_lens=jnp.asarray(lens), **kw))
    got = generate(tm, torch.from_numpy(prompt), 6, 10,
                   prompt_lens=torch.from_numpy(lens), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_stepwise_logits_equal_forward(gqa):
    _, _, tm = gqa
    toks = torch.from_numpy(tokens(6, t=9))
    with torch.no_grad():
        full = tm(toks)
    step = stepwise_logits(tm, toks)
    torch.testing.assert_close(step, full, rtol=0,
                               atol=1e-5 * float(full.abs().max()))


def test_decode_overflow_poisons_row_and_keeps_cache(mha):
    """A per-row cursor past the cache end gives NaN logits for that row
    only and leaves its cache untouched: misuse is loud."""
    _, _, tm = mha
    cache = init_cache(tm, 2, 4)
    toks = torch.tensor([[3], [5]])
    with torch.no_grad():
        decode_apply(tm, cache, toks, torch.tensor([0, 0]))
        before = cache["cached_k"][:, 1].clone()
        out = decode_apply(tm, cache, toks, torch.tensor([1, 4]))
    assert bool(torch.isfinite(out[0]).all())
    assert bool(torch.isnan(out[1]).all())
    assert torch.equal(cache["cached_k"][:, 1], before)


def test_seeded_init_is_flax_shaped():
    tm = TransformerLM(vocab=VOCAB, dim=DIM, depth=1, num_heads=HEADS)
    init_like_flax(tm, torch.Generator().manual_seed(0))
    tm.requires_grad_(False)
    assert float(tm.blocks[0].attn.q.bias.abs().max()) == 0.0
    assert torch.equal(tm.ln_f.weight, torch.ones(DIM))
    std = float(tm.embed.weight.std())
    assert abs(std - DIM ** -0.5) < 0.2 * DIM ** -0.5


# -- sampling ---------------------------------------------------------------

def sampling_logits(seed, rows=6):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((rows, VOCAB))).astype(np.float32)
    x[0, :5] = x[0, 5]            # ties at the top
    return x


@pytest.mark.parametrize("top_p,top_k", [(0.9, 0), (1.0, 5), (0.5, 10),
                                         (0.05, 0), (1.0, 0)])
def test_keep_mask_exactly_equal_to_jax(top_p, top_k):
    x = sampling_logits(int(top_p * 100) + top_k)
    rows = x.shape[0]
    tp = np.full((rows,), top_p, np.float32)
    tk = np.full((rows,), top_k, np.int32)
    want = np.asarray(jax_sampling.sample_keep_mask(
        jnp.asarray(x), jnp.asarray(tp), jnp.asarray(tk)))
    got = sampling.sample_keep_mask(torch.from_numpy(x), torch.from_numpy(tp),
                                    torch.from_numpy(tk).long()).numpy()
    np.testing.assert_array_equal(got, want)
    # the same survivor set as the sort-based filtered distribution
    probs = sampling.filtered_probs(torch.from_numpy(x), torch.from_numpy(tp),
                                    torch.from_numpy(tk).long())
    np.testing.assert_array_equal(probs.numpy() > 0, got)
    want_p = np.asarray(jax_sampling.filtered_probs(
        jnp.asarray(x), jnp.asarray(tp), jnp.asarray(tk)))
    np.testing.assert_allclose(probs.numpy(), want_p, rtol=0, atol=1e-6)


def test_sampler_distribution_chi_square():
    """Gumbel-max draws from the masked-scaled logits follow
    ``filtered_probs``: a chi-square test at p = 0.001 over 20,000 draws
    (bins with expected count < 5 merged; p-value from the regularized
    upper incomplete gamma function, chi2.sf(x, k) = Q(k/2, x/2))."""
    x = torch.from_numpy(sampling_logits(11, rows=1)[0] / 2.0)
    tp, tk = torch.tensor([0.9]), torch.tensor([20])
    masked = sampling.masked_sample_logits(x[None], tp, tk)[0]
    probs = sampling.filtered_probs(x[None], tp, tk)[0].double().numpy()
    gen = torch.Generator().manual_seed(1234)
    n = 20_000
    draws = sampling.categorical(masked.expand(n, VOCAB), gen).numpy()
    counts = np.bincount(draws, minlength=VOCAB)
    assert counts[probs == 0].sum() == 0, "drew a filtered-out token"
    expected = probs * n
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    keep = exp > 0
    obs, exp = obs[keep], exp[keep] * obs[keep].sum() / exp[keep].sum()
    stat = float(((obs - exp) ** 2 / exp).sum())
    dof = len(obs) - 1
    pvalue = float(torch.special.gammaincc(torch.tensor(dof / 2.0,
                                                        dtype=torch.float64),
                                           torch.tensor(stat / 2.0,
                                                        dtype=torch.float64)))
    assert pvalue > 1e-3, (stat, dof)


def test_sampled_generate_reproducible_per_seed(mha):
    _, _, tm = mha
    prompt = torch.from_numpy(tokens(7, t=4))
    kw = dict(temperature=0.8, top_p=0.9, top_k=20)
    a = generate(tm, prompt, 4, 8, rng=3, **kw)
    b = generate(tm, prompt, 4, 8, rng=3, **kw)
    c = generate(tm, prompt, 4, 8, rng=4, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :4], prompt)


@pytest.mark.parametrize("kv_cache_dtype,want", [("native", torch.bfloat16),
                                                 ("int8", torch.int8)])
def test_cache_dtype_follows_the_model(kv_cache_dtype, want):
    """The KV cache (and so the block pool's pages) takes the dtype the
    parameters hold after ``.to(...)``, as the JAX cache takes k's."""
    tm = TransformerLM(vocab=VOCAB, dim=DIM, depth=1, num_heads=HEADS,
                       kv_cache_dtype=kv_cache_dtype).to(torch.bfloat16)
    assert tm.dtype == torch.bfloat16
    cache = init_cache(tm, 2, 5)
    assert cache["cached_k"].dtype == want
    assert cache["cached_k"].shape == (1, 2, 5, HEADS, DIM // HEADS)
    with torch.no_grad():
        out = decode_apply(tm, cache, torch.tensor([[1], [2]]),
                           torch.tensor([0, 3]))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
