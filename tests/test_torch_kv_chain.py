"""The port's KVC1 chain codec (``store/kv_chain.py``) against the JAX
package's, and the port's block pool moving blocks in and out through it.

- ``encode_block`` writes the same bytes as the JAX codec for the same
  leaves and meta: f32, int8 and bf16 leaves (the JAX side's bf16 through
  ``ml_dtypes``, the port's as torch bf16 tensors), and from numpy arrays
  as well as torch tensors;
- ``decode_block`` gives back CPU tensors bit for bit, bf16 included, and
  refuses a token mismatch and a foreign magic;
- the names, hashes and tenant index names equal the JAX package's;
- a block of a bf16, an f32 and an int8-page ``KVBlockPool`` leaves the
  pool (``read_block``), goes through the codec and re-enters another
  pool (``write_raw_block``) bit for bit.

Everything is exact: no tolerance.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from idunno_tpu.store import kv_chain as jax_kv
from idunno_tpu_torch.engine.kv_blocks import KVBlockPool
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.store import kv_chain as kv
from tests.torch_workers import share_cores  # noqa: F401

META = {"tokens": [5, 7], "depth": 0, "namespace": "ns", "block_size": 2}


def leaves(seed: int = 0) -> dict[str, np.ndarray]:
    """numpy leaves as the JAX codec takes them (bf16 via ml_dtypes)."""
    rng = np.random.default_rng(seed)
    return {
        "cached_k": rng.standard_normal((2, 2, 3, 4)).astype(np.float32),
        "cached_v": rng.standard_normal((2, 2, 3, 4)).astype(
            ml_dtypes.bfloat16),
        "k_scale": rng.integers(-128, 128, (2, 2, 3)).astype(np.int8),
    }


def as_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("form", ["torch", "numpy"])
def test_encode_block_is_byte_equal_to_jax(form):
    ref = leaves()
    want = jax_kv.encode_block(META, ref)
    arrays = ({k: as_torch(v) for k, v in ref.items()} if form == "torch"
              else ref)
    assert kv.encode_block(META, arrays) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float16])
def test_decode_block_round_trips(dtype):
    t = (torch.randn(3, 2, 4) * 50).to(dtype)
    blob = kv.encode_block(META, {"x": t, "empty": torch.zeros(0, 4)})
    meta, got = kv.decode_block(blob, expect_tokens=[5, 7])
    assert meta == META
    assert got["x"].dtype == dtype and got["x"].device.type == "cpu"
    assert torch.equal(got["x"].view(torch.uint8), t.view(torch.uint8))
    assert got["empty"].shape == (0, 4)
    # the JAX codec reads the port's blob to the same bits
    _, jgot = jax_kv.decode_block(blob)
    assert np.asarray(jgot["x"]).tobytes() == t.view(torch.uint8).numpy() \
        .tobytes()


def test_decode_refuses_token_mismatch_and_foreign_blobs():
    blob = kv.encode_block(META, {"x": torch.ones(2)})
    with pytest.raises(ValueError, match="token mismatch"):
        kv.decode_block(blob, expect_tokens=[5, 8])
    with pytest.raises(ValueError, match="magic"):
        kv.decode_block(b"XXXX" + blob[4:])
    # the JAX package's blob decodes in the port (bf16 too)
    ref = leaves(1)
    _, got = kv.decode_block(jax_kv.encode_block(META, ref))
    for k, v in ref.items():
        assert torch.equal(got[k], as_torch(v)), k


def test_names_and_hashes_equal_jax():
    rng = np.random.default_rng(3)
    toks = [int(t) for t in rng.integers(0, 1000, size=37)]
    parts = {"config": {"dim": 64}, "params_fp": ["ab"], "prefix": [1, 2],
             "quantize": "", "block_size": 4, "extra": "lm"}
    ns = kv.namespace_key(parts)
    assert ns == jax_kv.namespace_key(parts)
    for bs in (2, 4, 16):
        assert kv.rolling_hashes(ns, toks, bs) == \
            jax_kv.rolling_hashes(ns, toks, bs)
        assert kv.chain_names(ns, toks, bs) == \
            jax_kv.chain_names(ns, toks, bs)
    assert kv.tenant_index_name(ns, "acme") == \
        jax_kv.tenant_index_name(ns, "acme")
    assert (kv.MAGIC, kv.BLOB_PREFIX, kv.TENANT_PREFIX) == \
        (jax_kv.MAGIC, jax_kv.BLOB_PREFIX, jax_kv.TENANT_PREFIX)


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8_pages"])
def test_block_pool_round_trip_is_bit_exact(kind):
    """read_block → encode_block → decode_block → write_raw_block moves a
    block between two pools bit for bit, in the pool's own dtype."""
    kw = {"kv_cache_dtype": "int8"} if kind == "int8_pages" else {}
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    lm = TransformerLM(vocab=61, dim=32, depth=2, num_heads=4,
                       dtype=dtype, **kw)
    src = KVBlockPool(lm, num_blocks=3, block_size=2, device="cpu")
    dst = KVBlockPool(lm, num_blocks=3, block_size=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for store in src.kv_pages().values():
        if store.dtype == torch.int8:
            store.copy_(torch.randint(-128, 128, store.shape, generator=gen))
        else:
            store.copy_(torch.randn(store.shape, generator=gen))
    names = set(src.kv_pages())
    assert names == ({"cached_k", "cached_v", "k_scale", "v_scale"}
                     if kind == "int8_pages" else {"cached_k", "cached_v"})
    a, b = src.alloc(), dst.alloc()
    raw = src.read_block(a)
    assert all(t.device.type == "cpu" for t in raw.values())
    _, got = kv.decode_block(kv.encode_block(META, raw))
    dst.write_raw_block(b, got)
    for name, store in dst.kv_pages().items():
        want = src.kv_pages()[name][:, a]
        assert store.dtype == want.dtype, name
        assert torch.equal(store[:, b].view(torch.uint8),
                           want.view(torch.uint8)), name
    # a wrong dtype or shape is refused before any store is touched
    bad = dict(got, cached_k=got["cached_k"].to(torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        dst.write_raw_block(b, bad)
    bad = dict(got, cached_k=got["cached_k"][:1])
    with pytest.raises(ValueError, match="shape"):
        dst.write_raw_block(b, bad)
