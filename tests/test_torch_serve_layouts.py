"""The port's paged ``DecodeServer`` against the JAX package's across model
layouts, on the CPU.

Each case builds the JAX ``TransformerLM`` from a seed, carries its
weights into the port (``lm_state_dict_from_flax``) and serves the
shared-prefix workload of ``utils/lm_bench.py`` (block size 2, 6 new
tokens, f32) on both servers: the greedy streams must be equal token for
token and the radix hits equal. The JAX server runs ``paged_kernel="xla"``
(its plain paged attention; ``tests/test_torch_serve_lm.py`` holds the
port to its Pallas kernel in interpret mode), the port's ``"auto"``, the
plain paged attention on the CPU.

the layout matrix: GQA (2 kv-heads) with native pages, GQA, MQA and MHA
with int8 pages. ``tests/test_torch_serve_lm.py`` holds int8 weights and
the default-size (head_dim 32) model to the JAX server the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idunno_tpu.engine.serve_lm import DecodeServer as JaxDecodeServer
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu_torch.engine.serve_lm import DecodeServer
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.utils.lm_bench import prefix_bench_workload
from tests.torch_workers import share_cores  # noqa: F401

BS, MAX_NEW = 2, 6


def carried_lm(seed: int, **kw):
    """(JAX module, its params, the port's model with those weights)."""
    jm = JaxLM(depth=2, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(depth=2, **kw)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm.eval()


def serve_both(lm, vocab: int, **server_kw):
    """Serve the shared-prefix workload on the JAX and the port's paged
    servers; returns (JAX streams, port streams, JAX hits, port hits, the
    port's server)."""
    jm, params, tm = lm
    prompts, _, buckets = prefix_bench_workload(
        {"prompt_len": 8, "vocab": vocab, "slots": 2}, BS)
    kw = dict(slots=2, prompt_len=8, max_len=24, prompt_buckets=buckets,
              kv_block_size=BS, kv_cache_blocks=(2 + 1) * 4, decode_steps=2,
              **server_kw)
    jsrv = JaxDecodeServer(jm, params, paged_kernel="xla", **kw)
    jids = [jsrv.submit(p, max_new=MAX_NEW) for p in prompts]
    jdone = {c.id: c.tokens for c in jsrv.run_until_drained()}
    srv = DecodeServer(tm, paged_kernel="auto", device="cpu", **kw)
    ids = [srv.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {c.id: c.tokens for c in srv.run_until_drained()}
    assert ids == jids
    return ([jdone[i] for i in jids], [done[i] for i in ids],
            jsrv.prefix_cache_stats()["hits"],
            srv.prefix_cache_stats()["hits"], srv)


@pytest.mark.parametrize("kv_heads,cache", [
    (2, "native"), (2, "int8"), (1, "int8"), (None, "int8")],
    ids=["gqa-native", "gqa-int8", "mqa-int8", "mha-int8"])
def test_layouts_match_jax_server(kv_heads, cache):
    lm = carried_lm(seed=7, vocab=61, dim=32, num_heads=4,
                    num_kv_heads=kv_heads, kv_cache_dtype=cache)
    want, got, jhits, hits, _ = serve_both(lm, 61)
    assert got == want
    assert hits == jhits and hits > 0
