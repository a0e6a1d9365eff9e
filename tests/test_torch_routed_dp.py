"""A routed pool over a data-only mesh: the port against the JAX package,
on the CPU.

The JAX package's ``DecodeServer`` over a routed LM
(``idunno_tpu/models/moe.py:MoETransformerLM``) on a (2, 1) mesh of the
conftest's host devices serves data-parallel and routes the whole batch
together (GSPMD's global view of the step). The port's pool over
``virtual_mesh(2, 1, "cpu")`` decodes the same way: one replica on the
mesh's lead device for the whole batch. Greedy streams must equal the JAX
pool's token for token on the same weights (``models/convert.py``), on a
contiguous cache and on a gathered block pool (a routed pool takes no
``paged_kernel``, as in the JAX package). Sampled rows draw from
``torch.Generator``\\ s, whose bits are not ``jax.random``'s, so a seeded
sampled stream is held to the port's pool without a mesh. Small sizes,
f32: dim 32, depth 2, 4 experts on every block, vocab 61.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idunno_tpu.engine.serve_lm import DecodeServer as JaxDecodeServer
from idunno_tpu.models.moe import MoETransformerLM as JaxMoELM
from idunno_tpu.parallel.mesh import make_mesh as jax_make_mesh
from idunno_tpu_torch.engine.serve_lm import DecodeServer
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.moe import MoETransformerLM
from idunno_tpu_torch.parallel.mesh import MeshShapeError, make_mesh, \
    virtual_mesh
from tests.torch_workers import share_cores  # noqa: F401

VOCAB = 61
POOLS = {"contiguous": {},
         "gathered": dict(kv_block_size=2, kv_cache_blocks=24)}
KW = dict(slots=4, prompt_len=8, max_len=24, decode_steps=2)
PROMPTS = [[5, 9, 2, 7, 3], [5, 9, 2, 7, 40, 1], [11, 4], [5, 9, 2, 7, 3],
           [30, 31, 32, 33, 34, 35, 36]]
SAMPLED = dict(temperature=0.8, top_p=0.9, seed=21)


@pytest.fixture(scope="module")
def served():
    jm = JaxMoELM(vocab=VOCAB, dim=32, depth=2, num_heads=4, n_experts=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = MoETransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4,
                          n_experts=4)
    tm.load_state_dict(lm_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm.eval()


def serve(srv, reqs) -> list:
    ids = [srv.submit(p, max_new=8, **kw) for p, kw in reqs]
    done = {c.id: c for c in srv.run_until_drained()}
    return [done[i] for i in ids]


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_routed_pool_over_a_data_mesh_matches_jax(served, pool):
    """Greedy streams equal the JAX pool's over a two-device data mesh,
    token for token (radix hits equal too on the gathered pool); the pool
    decodes through the bare model on the mesh's lead device, one cache
    for every slot; a seeded sampled request equals the port's pool
    without a mesh."""
    jm, params, tm = served
    kw = dict(KW, **POOLS[pool])
    jsrv = JaxDecodeServer(jm, params, mesh=jax_make_mesh(2, 1), **kw)
    assert jsrv.n_model == 1
    jids = [jsrv.submit(p, max_new=8) for p in PROMPTS]
    jdone = {c.id: c.tokens for c in jsrv.run_until_drained()}
    srv = DecodeServer(tm, mesh=virtual_mesh(2, 1, "cpu"), device="cpu",
                       **kw)
    assert srv._dec is srv.model and srv.n_model == 1
    assert {srv._group(s) for s in range(KW["slots"])} == {0}
    got = serve(srv, [(p, {}) for p in PROMPTS])
    assert [c.tokens for c in got] == [jdone[j] for j in jids]
    assert len({tuple(c.tokens) for c in got}) > 1
    if pool == "gathered":
        assert srv._block_pool.mesh is None
        assert (srv.prefix_cache_stats()["hits"]
                == jsrv.prefix_cache_stats()["hits"] > 0)
    one = DecodeServer(tm, device="cpu", **kw)
    reqs = [(PROMPTS[0], SAMPLED), (PROMPTS[2], {})]
    assert ([c.tokens for c in serve(srv, reqs)]
            == [c.tokens for c in serve(one, reqs)])


def test_routed_pool_over_distinct_devices_runs_eager(served):
    """Over a mesh whose cells are distinct devices (two CPU devices, the
    same memory) the pool still decodes on the lead and runs eagerly, as
    every mesh of distinct devices does; ``decode_graph='graph'`` there
    raises."""
    import torch
    _, _, tm = served
    mesh = make_mesh(2, 1, devices=[torch.device("cpu", 0),
                                    torch.device("cpu", 1)])
    srv = DecodeServer(tm, mesh=mesh, **KW)
    assert srv.decode_graph == "eager" and srv.device == mesh.lead
    one = DecodeServer(tm, device="cpu", **KW)
    reqs = [(p, {}) for p in PROMPTS[:3]]
    assert ([c.tokens for c in serve(srv, reqs)]
            == [c.tokens for c in serve(one, reqs)])
    with pytest.raises(ValueError, match="eager"):
        DecodeServer(tm, mesh=mesh, decode_graph="graph", **KW)


def test_mesh_along_names_every_kind_it_refuses():
    """``Mesh.along`` refuses a mesh across processes outside the process
    group it was made in for sequence, pipeline and expert parallelism
    alike, and says so, naming the missing group and where it comes
    from."""
    mesh = virtual_mesh(2, 2, "cpu")
    across = type(mesh)(devices=mesh.devices, virtual=True,
                        owners=((0, 0), (1, 1)), axes=mesh.axes)
    with pytest.raises(MeshShapeError) as err:
        across.along(mesh.axes[1])
    msg = str(err.value)
    for kind in ("sequence", "pipeline", "expert"):
        assert kind in msg
    assert "no torch.distributed process group" in msg
    assert "initialize_distributed" in msg
