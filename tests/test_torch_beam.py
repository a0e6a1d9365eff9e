"""The port's ``beam_search`` against the JAX package's, on the CPU.

The same flax weights (carried by ``models/convert.py``) and the same
seeded prompts go through ``idunno_tpu.engine.generate.beam_search`` and
``idunno_tpu_torch.engine.generate.beam_search``: the best beams' sequences
are equal and their total log-probs agree within 1e-5 (f32). Width 1 is
greedy ``generate``, and a wider beam never scores below greedy. Small
model: dim 32, depth 2, vocab 61, f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.engine.generate import beam_search as jax_beam_search
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu_torch.engine.generate import (beam_search, gather_beams,
                                              generate, stepwise_logits)
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from tests.torch_workers import share_cores  # noqa: F401

VOCAB = 61


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm.eval()


def prompts(b: int, plen: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, VOCAB, (b, plen),
                                                dtype=np.int64)


@pytest.mark.parametrize("b,plen,max_new,width", [
    (2, 5, 8, 4), (3, 1, 6, 3), (1, 7, 10, 2)])
def test_beam_search_matches_jax(lm, b, plen, max_new, width):
    """Equal best sequences and total log-probs within 1e-5, for a prompt
    of one token (no prefill step) and longer ones."""
    jm, params, tm = lm
    p = prompts(b, plen, seed=b * 10 + width)
    want_seq, want_score = jax_beam_search(
        jm, params, jnp.asarray(p, jnp.int32), plen, max_new,
        beam_width=width)
    seq, score = beam_search(tm, torch.from_numpy(p), plen, max_new,
                             beam_width=width)
    assert seq.shape == (b, plen + max_new) and score.shape == (b,)
    assert np.array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score),
                               rtol=0, atol=1e-5)


def test_width_one_is_greedy_and_wider_scores_no_lower(lm):
    """Width 1 gives `generate`'s greedy sequence and its summed
    log-prob; width 4 reaches at least that score, and its score is the
    sum of its own sequence's token log-probs."""
    _, _, tm = lm
    p = torch.from_numpy(prompts(3, 4, seed=3))
    greedy = generate(tm, p, 4, 8)
    seq1, score1 = beam_search(tm, p, 4, 8, beam_width=1)
    assert torch.equal(seq1, greedy)

    def total_logprob(seq):
        logp = torch.log_softmax(stepwise_logits(tm, seq), dim=-1)
        picked = torch.gather(logp[:, 3:-1], 2, seq[:, 4:, None])[..., 0]
        return picked.sum(dim=1)

    torch.testing.assert_close(score1, total_logprob(seq1), rtol=0,
                               atol=1e-4)
    seq4, score4 = beam_search(tm, p, 4, 8, beam_width=4)
    assert bool((score4 >= score1 - 1e-6).all())
    torch.testing.assert_close(score4, total_logprob(seq4), rtol=0,
                               atol=1e-4)


def test_gather_beams_follows_parents():
    """`gather_beams` re-gathers rows (and dict leaves along a given axis)
    by parent beam within each batch row, and refuses a mismatched
    prompt width in `beam_search`."""
    x = torch.arange(6)[:, None] * 10 + torch.arange(3)[None, :]   # [B*W, 3]
    parent = torch.tensor([[2, 2, 0], [1, 0, 0]])                 # B=2, W=3
    assert gather_beams(x, parent)[:, 0].tolist() == [20, 20, 0, 40, 30, 30]
    tree = {"k": x.T[None]}                                       # beams on axis 2
    got = gather_beams(tree, parent, axis=2)["k"]
    assert torch.equal(got[0].T, gather_beams(x, parent))
    with pytest.raises(ValueError, match="prompt_len"):
        beam_search(TransformerLM(vocab=VOCAB, dim=32, depth=1, num_heads=4),
                    torch.zeros((1, 3), dtype=torch.int64), 4, 2)
