"""The port's tensor-parallel sharding policy against the JAX package's, on
the CPU: the counterparts of ``tests/test_tp_sharding.py``.

The typed ``MeshShapeError`` (8- and 5-device shapes, here on virtual CPU
meshes), the Megatron split (`parallel/sharding.py:lm_tp_specs`), held
parameter by parameter against the JAX package's ``PartitionSpec`` of the
same parameter (the port's split dim mapped to the flax layout through
``models/convert.py``'s names and transposes), the cache specs, int8
weights, the placed shards against the JAX package's device shards, the
CNN specs and the collective-byte gauges. Small model: dim 32, depth 2,
vocab 61, f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.models.transformer import stack_block_params
from idunno_tpu.parallel.mesh import make_mesh as jax_make_mesh
from idunno_tpu.parallel.sharding import cnn_tp_specs as jax_cnn_tp_specs
from idunno_tpu.parallel.sharding import lm_tp_specs as jax_lm_tp_specs
from idunno_tpu.parallel.sharding import \
    sampling_collective_bytes as jax_sampling_bytes
from idunno_tpu.parallel.sharding import shard_lm_params as jax_shard_params
from idunno_tpu.parallel.sharding import tp_collective_bytes as jax_tp_bytes
from idunno_tpu_torch.engine.generate import init_cache
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.ops.quantize import quantize_tree
from idunno_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                            MeshShapeError,
                                            check_head_divisibility,
                                            make_mesh, virtual_mesh)
from idunno_tpu_torch.parallel.sharding import (QParam, cnn_tp_specs,
                                                lm_cache_specs, lm_tp_specs,
                                                module_params, param_shard,
                                                sampling_collective_bytes,
                                                shard_cnn_variables,
                                                shard_lm_params,
                                                tp_collective_bytes)

VOCAB = 61
CPU8 = ["cpu"] * 8
M = MODEL_AXIS


def _models(num_heads=4, num_kv_heads=None, vocab=VOCAB):
    jm = JaxLM(vocab=vocab, dim=32, depth=2, num_heads=num_heads,
               num_kv_heads=num_kv_heads)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    tm = TransformerLM(vocab=vocab, dim=32, depth=2, num_heads=num_heads,
                       num_kv_heads=num_kv_heads)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, stack_block_params(params, jm.depth), tm.eval()


# port parameter (module, kind) → (flax path under the stacked tree, the
# flax axis that the port's split dim becomes): q/k/v [H·hd, dim] are flax
# [L, dim, H, hd] (dim 0 → H, axis 2), their biases [L, H, hd] (axis 1),
# out [dim, H·hd] is [L, H, hd, dim] (dim 1 → H, axis 1), Dense [out, in]
# is [L, in, out] (dim 0 → axis 2, dim 1 → axis 1), the head is unstacked
_FLAX = {
    ("attn.q", "weight"): (("attn", "q", "kernel"), {0: 2}),
    ("attn.k", "weight"): (("attn", "k", "kernel"), {0: 2}),
    ("attn.v", "weight"): (("attn", "v", "kernel"), {0: 2}),
    ("attn.q", "bias"): (("attn", "q", "bias"), {0: 1}),
    ("attn.k", "bias"): (("attn", "k", "bias"), {0: 1}),
    ("attn.v", "bias"): (("attn", "v", "bias"), {0: 1}),
    ("attn.out", "weight"): (("attn", "out", "kernel"), {1: 1}),
    ("attn.out", "bias"): (("attn", "out", "bias"), {}),
    ("mlp_up", "weight"): (("mlp_up", "kernel"), {0: 2}),
    ("mlp_up", "bias"): (("mlp_up", "bias"), {0: 1}),
    ("mlp_down", "weight"): (("mlp_down", "kernel"), {1: 1}),
    ("mlp_down", "bias"): (("mlp_down", "bias"), {}),
    ("ln1", "weight"): (("ln1", "scale"), {}),
    ("ln1", "bias"): (("ln1", "bias"), {}),
    ("ln2", "weight"): (("ln2", "scale"), {}),
    ("ln2", "bias"): (("ln2", "bias"), {}),
}
_TOP = {
    "embed.weight": (("embed", "embedding"), {}),
    "head.weight": (("head", "kernel"), {0: 1}),
    "head.bias": (("head", "bias"), {0: 0}),
    "ln_f.weight": (("ln_f", "scale"), {}),
    "ln_f.bias": (("ln_f", "bias"), {}),
}


def _as_jax_spec(name: str, dim):
    """(flax path, the PartitionSpec the port's split means there)."""
    if name.startswith("blocks."):
        _, _, rest = name.split(".", 2)
        mod, kind = rest.rsplit(".", 1)
        path, axes = _FLAX[mod, kind]
        path = ("blocks",) + path
    else:
        path, axes = _TOP[name]
    if dim is None:
        return path, P()
    ax = axes[dim]
    return path, P(*([None] * ax + [M]))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _assert_specs_equal_jax(tm, jspecs, specs):
    assert set(specs) == set(module_params(tm))
    for name, dim in specs.items():
        path, want = _as_jax_spec(name, dim)
        assert _at(jspecs, path) == want, (name, dim, _at(jspecs, path))


# -- MeshShapeError ---------------------------------------------------------

def test_make_mesh_over_request_raises_typed():
    with pytest.raises(MeshShapeError) as ei:
        make_mesh(3, 4, devices=CPU8, virtual=True)
    e = ei.value
    assert isinstance(e, ValueError)        # typed, still a ValueError
    assert e.n_devices == 8 and e.n_model == 4
    assert "8" in e.constraint


def test_make_mesh_five_device_subset():
    # odd subset: pure-DP builds, any model extent > 1 cannot tile 5
    mesh = make_mesh(5, 1, devices=CPU8[:5], virtual=True)
    assert mesh.shape[DATA_AXIS] == 5 and mesh.shape[MODEL_AXIS] == 1
    with pytest.raises(MeshShapeError) as ei:
        make_mesh(2, 4, devices=CPU8[:5], virtual=True)
    assert ei.value.n_devices == 5 and ei.value.n_model == 4


def test_check_head_divisibility():
    check_head_divisibility(4, 2)           # divides: no raise
    check_head_divisibility(3, 1)           # n_model=1: anything goes
    with pytest.raises(MeshShapeError) as ei:
        check_head_divisibility(4, 8)
    e = ei.value
    assert e.n_model == 8 and "num_heads" in e.constraint


def test_a_shared_device_needs_a_virtual_mesh():
    """A mesh names a device twice only when asked to (``virtual=True``):
    otherwise the typed error names the distinct devices it has."""
    with pytest.raises(MeshShapeError) as ei:
        make_mesh(1, 2, devices=["cpu", "cpu"])
    assert ei.value.n_devices == 1 and "virtual" in str(ei.value)
    mesh = virtual_mesh(2, 2, "cpu")
    assert mesh.virtual and mesh.distinct() == [torch.device("cpu")]
    assert mesh.shape == {DATA_AXIS: 2, MODEL_AXIS: 2}


# -- LM param specs ---------------------------------------------------------

def test_lm_tp_specs_megatron_split():
    _, _, stacked, tm = _models(num_heads=4)
    specs = lm_tp_specs(tm, n_model=2)
    # column shards cut the output dim, row shards the contraction dim
    assert specs["blocks.0.attn.q.weight"] == 0
    assert specs["blocks.1.mlp_up.weight"] == 0
    assert specs["blocks.0.attn.out.weight"] == 1
    assert specs["blocks.0.mlp_down.weight"] == 1
    assert specs["blocks.0.attn.out.bias"] is None
    # vocab 61 does not divide 2: the head replicates, as in JAX
    assert specs["head.weight"] is None and specs["embed.weight"] is None
    _assert_specs_equal_jax(tm, jax_lm_tp_specs(stacked, n_model=2), specs)


def test_lm_tp_specs_gqa_divide_or_replicate():
    # kv_shard=False: K/V replicate while Q still shards
    _, _, stacked, tm = _models(num_heads=4, num_kv_heads=1)
    specs = lm_tp_specs(tm, n_model=2, kv_shard=False)
    assert specs["blocks.0.attn.q.weight"] == 0
    assert specs["blocks.0.attn.k.weight"] is None
    assert specs["blocks.0.attn.v.bias"] is None
    _assert_specs_equal_jax(
        tm, jax_lm_tp_specs(stacked, n_model=2, kv_shard=False), specs)


def test_lm_tp_specs_n_model_one_replicates_everything():
    _, _, stacked, tm = _models()
    specs = lm_tp_specs(tm, n_model=1)
    assert all(d is None for d in specs.values())
    _assert_specs_equal_jax(tm, jax_lm_tp_specs(stacked, n_model=1), specs)


def test_lm_tp_specs_vocab_head_shards_where_it_divides():
    _, _, stacked, tm = _models(vocab=64)
    specs = lm_tp_specs(tm, n_model=4)
    assert specs["head.weight"] == 0 and specs["head.bias"] == 0
    _assert_specs_equal_jax(tm, jax_lm_tp_specs(stacked, n_model=4), specs)


def test_lm_tp_specs_qtensor_sanitize():
    """int8 weights take their weight's split; the int8 values are cut
    like the weight and the scale only where it varies along the cut, so
    every shard dequantizes to the same cut of the dequantized weight."""
    _, _, _, tm = _models()
    q = quantize_tree(tm)
    params = module_params(q)
    specs = lm_tp_specs(q, n_model=2)
    assert isinstance(params["blocks.0.attn.q.weight"], QParam)
    assert specs["blocks.0.attn.q.weight"] == 0
    for name in ("blocks.0.attn.q.weight", "blocks.0.attn.q.bias",
                 "blocks.0.mlp_up.weight", "blocks.0.mlp_down.weight",
                 "blocks.1.attn.out.weight"):
        leaf = params[name]
        assert isinstance(leaf, QParam), name
        whole = leaf.dequantize()
        for s in range(2):
            part = param_shard(leaf, specs[name], s, 2)
            got = QParam(type(part.qt)(part.qt.q.contiguous(),
                                       part.qt.scale, part.qt.view),
                         part.dtype).dequantize()
            cut = param_shard(whole, specs[name], s, 2)
            assert torch.equal(got, cut), (name, s)
    # the q projection's scale is per head-dim index, shared across heads:
    # the head cut leaves it whole
    qp = param_shard(params["blocks.0.attn.q.weight"], 0, 1, 2)
    assert qp.qt.scale.shape == params["blocks.0.attn.q.weight"].qt.scale \
        .shape


# -- LM cache specs ---------------------------------------------------------

def test_lm_cache_specs_slot_axis_and_kv_heads():
    tm = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4,
                       kv_cache_dtype="int8")
    cache = init_cache(tm, 4, 8)             # [L, S, T, kvh, hd] + scales
    specs = lm_cache_specs(cache, n_model=2)
    # JAX: P(None, "data", None, "model") — data dim 1, model dim 3
    assert specs["cached_k"] == (1, 3) and specs["k_scale"] == (1, 3)
    specs_r = lm_cache_specs(cache, n_model=2, kv_shard=False)
    assert specs_r["cached_k"] == (1, None)


def test_lm_cache_specs_non_dividing_kv_heads_sanitize():
    cache = {"cached_k": torch.zeros((2, 4, 8, 3, 8))}      # kvh=3
    assert lm_cache_specs(cache, n_model=2)["cached_k"] == (1, None)


# -- end-to-end placement ---------------------------------------------------

def test_shard_lm_params_places_on_model_axis(eight_devices):
    """Each model shard holds the numbers the JAX package puts on that
    shard's devices (q's heads, mlp_down's rows), the replicated
    parameters whole; heads that cannot split raise the typed error."""
    jm, params, _, tm = _models(num_heads=4)
    mesh = virtual_mesh(4, 2, "cpu")
    shards = shard_lm_params(mesh, tm)
    assert len(shards) == 2
    jsharded = jax_shard_params(jax_make_mesh(4, 2, devices=eight_devices),
                                jm, params)
    hd = 8
    qk = jsharded["blocks"]["attn"]["q"]["kernel"]          # [L, dim, H, hd]
    assert M in tuple(qk.sharding.spec)
    for m, shard in enumerate(shards):
        w = shard["blocks.0.attn.q.weight"]                  # [2·hd, dim]
        assert tuple(w.shape) == (2 * hd, 32)
        got = w.reshape(2, hd, 32).permute(2, 0, 1).numpy()
        piece = next(s for s in qk.addressable_shards
                     if s.index[2] == slice(2 * m, 2 * m + 2, None))
        np.testing.assert_array_equal(got, np.asarray(piece.data)[0])
        down = shard["blocks.1.mlp_down.weight"]             # [dim, 64]
        jd = np.asarray(jsharded["blocks"]["mlp_down"]["kernel"])[1]
        np.testing.assert_array_equal(down.numpy().T,
                                      jd[64 * m:64 * (m + 1)])
        assert torch.equal(shard["embed.weight"], tm.embed.weight)
    tm3 = TransformerLM(vocab=VOCAB, dim=30, depth=2, num_heads=3)
    with pytest.raises(MeshShapeError):
        shard_lm_params(mesh, tm3)


# -- CNN specs --------------------------------------------------------------

def test_cnn_tp_specs_wide_shard_narrow_replicate():
    # the port's layouts: conv [cout, cin, kh, kw], Linear [out, in]
    state = {"stem.weight": torch.zeros((64, 3, 7, 7)),
             "stem.bias": torch.zeros((64,)),
             "fc.weight": torch.zeros((512, 256)),
             "fc.bias": torch.zeros((512,)),
             "odd.weight": torch.zeros((130, 16)),            # 130 % 4
             "bn.running_mean": torch.zeros((512,))}
    specs = cnn_tp_specs(state, n_model=4)
    assert specs["fc.weight"] == 0
    assert specs["stem.weight"] is None and specs["odd.weight"] is None
    assert specs["fc.bias"] is None and specs["bn.running_mean"] is None
    # the JAX package's rule on the flax layouts of the same tensors
    flax = {"stem": {"kernel": jnp.zeros((7, 7, 3, 64))},
            "fc": {"kernel": jnp.zeros((256, 512))},
            "odd": {"kernel": jnp.zeros((16, 130))}}
    js = jax_cnn_tp_specs(flax, n_model=4)
    assert js["fc"]["kernel"] == P(None, M)
    assert js["stem"]["kernel"] == P() and js["odd"]["kernel"] == P()
    placed = shard_cnn_variables(virtual_mesh(1, 4, "cpu"), state)
    assert tuple(placed[3]["fc.weight"].shape) == (128, 256)
    assert tuple(placed[3]["stem.weight"].shape) == (64, 3, 7, 7)


# -- gauges -----------------------------------------------------------------

def test_tp_collective_bytes():
    jm, _, _, tm = _models()
    assert tp_collective_bytes(tm, slots=4, n_model=1) == 0
    for n in (2, 4):
        assert tp_collective_bytes(tm, slots=4, n_model=n) == \
            jax_tp_bytes(jm, slots=4, n_model=n) == 2 * 2 * 4 * 32 * 4
    jm64, _, _, tm64 = _models(vocab=64)
    for n in (1, 2, 3):
        assert sampling_collective_bytes(tm64, 4, n) == \
            jax_sampling_bytes(jm64, 4, n)


def test_multi_host_init_names_the_roadmap():
    """Multi-host bring-up and a mesh across processes wait for data
    parallelism (step 3b): they raise naming ROADMAP.md."""
    from idunno_tpu_torch.parallel.mesh import (global_mesh,
                                                initialize_distributed,
                                                process_info)
    for call in (lambda: initialize_distributed("localhost:1234", 2, 0),
                 global_mesh, process_info):
        with pytest.raises(ValueError, match="ROADMAP.md.*3b"):
            call()


def test_local_mesh_spans_the_visible_cards():
    """``local_mesh`` is data-parallel over every visible card; a machine
    with no card has no device to build it on (typed, with the count)."""
    from idunno_tpu_torch.parallel.mesh import local_mesh
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        with pytest.raises(MeshShapeError) as ei:
            local_mesh()
        assert ei.value.n_devices == 0
        return
    mesh = local_mesh()
    assert mesh.shape == {DATA_AXIS: n, MODEL_AXIS: 1} and not mesh.virtual
