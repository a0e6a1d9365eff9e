"""The port's ``DecodeServer`` over a routed LM (switch MoE) and the
training job's ``remat``/``ffn_every``, against the JAX package on the CPU.

The serving half of ``tests/test_torch_moe.py``, kept in its own file for
the suite's time rule (each file runs on one worker): the JAX package's
``DecodeServer`` over ``idunno_tpu/models/moe.py:MoETransformerLM`` with its
own initial weights, carried into the port by ``models/convert.py``, against
the port's pool on the same prompts. Small sizes, f32: dim 32, depth 2,
4 experts, vocab 61.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.engine.serve_lm import DecodeServer as JaxDecodeServer
from idunno_tpu.models.moe import MoETransformerLM as JaxMoELM
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu_torch.engine.generate import generate, load_lm
from idunno_tpu_torch.engine.serve_lm import DecodeServer
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.moe import MoETransformerLM
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload
from tests.torch_workers import share_cores  # noqa: F401

VOCAB = 64


class MemStore:
    """The store surface the training job and ``load_lm`` use."""

    def __init__(self):
        self.blobs: dict[str, list[bytes]] = {}

    def put_bytes(self, name, blob):
        self.blobs.setdefault(name, []).append(bytes(blob))
        return len(self.blobs[name])

    def get_bytes(self, name, version=None):
        vs = self.blobs[name]
        v = len(vs) if version is None else version
        return vs[v - 1], v


# -- DecodeServer -----------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """A routed LM (depth 2, every block routed) in both packages, with
    the JAX package's weights."""
    jm = JaxMoELM(vocab=61, dim=32, depth=2, num_heads=4, n_experts=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(11),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = MoETransformerLM(vocab=61, dim=32, depth=2, num_heads=4,
                          n_experts=4)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


POOLS = {
    "contiguous": {},
    "gathered": dict(kv_block_size=2, kv_cache_blocks=12),
    "int8": dict(quantize="int8"),
}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_routed_pool_streams_equal_jax_server(served, pool):
    """Greedy streams token for token against the JAX server on the same
    weights: the contiguous cache, a gathered block pool (radix hits
    gathered into the slot cache; the hits equal too) and int8 weights.
    Two slots: capacity is max(1, int(2·2/4)) = 1 a decode step, so rows
    (idle ones too) compete for experts as in the JAX server."""
    jm, params, tm = served
    prompts, _, buckets = prefix_bench_workload(
        {"prompt_len": 8, "vocab": 61, "slots": 2}, 2)
    kw = dict(slots=2, prompt_len=8, max_len=24, decode_steps=2,
              **POOLS[pool])
    if pool == "gathered":          # tail buckets: radix hits shorten them
        kw["prompt_buckets"] = buckets
    jsrv = JaxDecodeServer(jm, params, **kw)
    jids = [jsrv.submit(p, max_new=6) for p in prompts]
    want = {c.id: c.tokens for c in jsrv.run_until_drained()}
    srv = DecodeServer(tm, device="cpu", **kw)
    ids = [srv.submit(p, max_new=6) for p in prompts]
    got = {c.id: c.tokens for c in srv.run_until_drained()}
    assert [got[i] for i in ids] == [want[j] for j in jids]
    assert len(set(map(tuple, got.values()))) > 1
    if pool == "gathered":
        assert (srv.prefix_cache_stats()["hits"]
                == jsrv.prefix_cache_stats()["hits"] > 0)


def test_routed_pool_matches_generate(served):
    """A lone request in a one-slot pool routes exactly as ``generate``'s
    batch-1 decode: the same stream."""
    _, _, tm = served
    prompt = [5, 9, 2, 7]
    srv = DecodeServer(tm, slots=1, prompt_len=8, max_len=24, device="cpu")
    srv.submit(prompt, max_new=8)
    got = srv.run_until_drained()[0].tokens
    want = generate(tm, torch.tensor([prompt]), len(prompt), 8)[0].tolist()
    assert got == want


def test_routed_pool_refusals_equal_jax(served):
    """``paged_kernel`` on a routed pool, and a routed speculative target,
    raise the JAX server's ValueErrors."""
    jm, params, tm = served
    kw = dict(slots=2, prompt_len=8, max_len=24, kv_block_size=2)
    with pytest.raises(ValueError) as jerr:
        JaxDecodeServer(jm, params, paged_kernel="xla", **kw)
    with pytest.raises(ValueError) as err:
        DecodeServer(tm, paged_kernel="auto", device="cpu", **kw)
    assert str(err.value) == str(jerr.value)
    # the JAX server refuses before it reads the draft's params
    jdraft = JaxLM(vocab=61, dim=16, depth=1, num_heads=2)
    with pytest.raises(ValueError) as jerr:
        JaxDecodeServer(jm, params, slots=2, prompt_len=8, max_len=24,
                        draft=(jdraft, None))
    draft = TransformerLM(vocab=61, dim=16, depth=1, num_heads=2)
    with pytest.raises(ValueError) as err:
        DecodeServer(tm, slots=2, prompt_len=8, max_len=24,
                     draft=(draft, None), device="cpu")
    assert str(err.value) == str(jerr.value)
    assert "dense target" in str(err.value)


# -- the training job -----------------------------------------------------------

def test_train_job_takes_remat_and_ffn_every():
    """A job's ``model_config`` with ``remat=True`` and ``ffn_every=2`` is
    accepted, as the JAX job's ``TransformerLM(**model_config)`` takes it:
    the job trains and publishes an LM that stores both."""
    from idunno_tpu_torch.engine.data_lm import save_corpus
    from idunno_tpu_torch.engine.train_job import LMTrainJob

    store = MemStore()
    save_corpus(store, "c", np.random.default_rng(0).integers(
        0, VOCAB, 2000).astype(np.int32))
    job = LMTrainJob(store, "rj", corpus="c", steps=2, batch_size=2,
                     seq_len=16, checkpoint_every=2, device="cpu",
                     model_config={"vocab": VOCAB, "dim": 32, "depth": 2,
                                   "num_heads": 4, "remat": True,
                                   "ffn_every": 2})
    job.join(timeout=120)
    st = job.status()
    assert st["error"] is None and st["done"], st
    back = load_lm(store, "rj", device="cpu")
    assert back.remat is True and back.ffn_every == 2
