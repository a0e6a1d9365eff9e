"""The port's replicated store and what rides on it, on the CPU: LM blobs
(``save_lm``/``load_lm``), the checkpoint format (``engine/checkpoint.py``),
the engine's store-first weight load with ``publish_weights``, and
``store://`` datasets (``engine/data_store.py``), all through a two-node
in-process SDFS of the port (``InProcNetwork``, ``FileStoreService``).

Models are small: the LM at dim 32, depth 2, vocab 61; the CNNs at 64²
images and batch 8; f32 throughout. JAX weights reach the port through
``models/convert.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.config import EngineConfig as JaxEngineConfig
from idunno_tpu.engine.checkpoint import save_variables as jax_save_variables
from idunno_tpu.engine.generate import save_lm as jax_save_lm
from idunno_tpu.engine.inference import InferenceEngine as JaxEngine
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.parallel.mesh import local_mesh
from idunno_tpu_torch.comm.inproc import InProcNetwork
from idunno_tpu_torch.config import ClusterConfig, EngineConfig
from idunno_tpu_torch.engine import data as data_lib
from idunno_tpu_torch.engine.checkpoint import (FORMAT, MAGIC,
                                                checkpoint_holders,
                                                checkpoint_name, decode_state,
                                                encode_state,
                                                restore_variables,
                                                restore_version,
                                                save_variables)
from idunno_tpu_torch.engine.data_store import publish_images
from idunno_tpu_torch.engine.generate import lm_store_name, load_lm, save_lm
from idunno_tpu_torch.engine.inference import InferenceEngine
from idunno_tpu_torch.membership.service import MembershipService
from idunno_tpu_torch.models.convert import (lm_state_dict_from_flax,
                                             state_dict_from_flax)
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.store.sdfs import FileStoreService

from tests.test_membership import FakeClock, pump

VOCAB = 61
SMALL = dict(batch_size=8, image_size=64, resize_size=64)
# the port's forward against flax's in f32: a few ulps of the logits
LOGIT_ATOL = 1e-5
# records of the port's engine against the JAX engine's, f32 both sides
PROB_ATOL = 1e-4


@pytest.fixture
def stores(tmp_path):
    """Two port nodes' stores, each file replicated on both."""
    cfg = ClusterConfig(hosts=("n0", "n1"), coordinator="n0",
                        standby_coordinator="n1", introducer="n0",
                        replication_factor=2)
    net, clock = InProcNetwork(), FakeClock()
    members, out = {}, {}
    for h in cfg.hosts:
        t = net.transport(h)
        members[h] = MembershipService(h, cfg, t, clock=clock)
        out[h] = FileStoreService(h, cfg, t, members[h], str(tmp_path / h))
    for h in cfg.hosts:
        members[h].join()
        clock.advance(0.01)
    pump(members, clock)
    return out


@functools.lru_cache(maxsize=None)
def jax_lm(num_kv_heads=None, seed=0):
    jm = JaxLM(vocab=VOCAB, dim=32, depth=2, num_heads=4,
               num_kv_heads=num_kv_heads)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, params


def carried(params, **kw) -> TransformerLM:
    tm = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4, **kw)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return tm.eval()


def tokens(seed=3, b=2, t=9):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t))


class _BlobStore:
    """Captures what a JAX ``save_*`` would put into its store."""

    def put_bytes(self, name, blob):
        self.name, self.blob = name, blob
        return 1


# -- LM blobs ----------------------------------------------------------------


@pytest.mark.parametrize("num_kv_heads,kv_cache_dtype",
                         [(None, "native"), (2, "int8")])
def test_save_lm_load_lm_logits_match_jax(stores, num_kv_heads,
                                          kv_cache_dtype):
    """Saved on n0, loaded on n1: the architecture comes back with the
    weights, and the logits equal the JAX model's within LOGIT_ATOL."""
    jm, params = jax_lm(num_kv_heads)
    tm = carried(params, num_kv_heads=num_kv_heads,
                 kv_cache_dtype=kv_cache_dtype)
    assert save_lm(stores["n0"], "chat", tm) == 1
    assert sorted(stores["n1"].ls(lm_store_name("chat"))) == ["n0", "n1"]
    got = load_lm(stores["n1"], "chat", device="cpu")
    assert (got.num_kv_heads, got.kv_cache_dtype) == (num_kv_heads,
                                                      kv_cache_dtype)
    assert not got.training and not any(p.requires_grad
                                        for p in got.parameters())
    toks = tokens()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        out = got(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=LOGIT_ATOL)


def test_load_lm_versions_and_dtypes(stores):
    """A historical version pairs its architecture with its own weights;
    bf16 compute over f32 parameters round-trips both dtypes."""
    _, p0 = jax_lm(seed=0)
    _, p1 = jax_lm(seed=1)
    v1 = save_lm(stores["n0"], "chat", carried(p0))
    mixed = carried(p1, compute_dtype=torch.bfloat16)
    v2 = save_lm(stores["n1"], "chat", mixed)
    assert (v1, v2) == (1, 2)
    old = load_lm(stores["n1"], "chat", version=1, device="cpu")
    new = load_lm(stores["n0"], "chat", device="cpu")
    assert (old.dtype, old.compute_dtype) == (torch.float32, torch.float32)
    assert (new.dtype, new.compute_dtype) == (torch.float32, torch.bfloat16)
    for k, v in carried(p0).state_dict().items():
        assert torch.equal(old.state_dict()[k], v), k
    toks = torch.from_numpy(tokens())
    with torch.no_grad():
        assert torch.equal(new(toks), mixed(toks))


def test_save_lm_refuses_custom_attention(stores):
    from idunno_tpu_torch.models.transformer import make_attn_fn

    tm = carried(jax_lm()[1]).set_attn_fn(make_attn_fn("auto"))
    with pytest.raises(ValueError, match="full_attention"):
        save_lm(stores["n0"], "chat", tm)


def _foreign_blob(kind: str) -> bytes:
    jm, params = jax_lm()
    if kind == "flax_lm_blob":           # the JAX package's own LM blob
        cap = _BlobStore()
        jax_save_lm(cap, "chat", jm, params)
        return cap.blob
    if kind == "flax_checkpoint":        # the JAX package's ckpt/<model>
        cap = _BlobStore()
        jax_save_variables(cap, "resnet", {"params": params})
        return cap.blob
    good = encode_state(carried(params).state_dict(), {"lm": {}})
    start = len(MAGIC) + 4
    if kind == "corrupt_header":
        return good[:start] + b"\xff" + good[start + 1:]
    if kind == "wrong_format":
        head = b'{"format": "something/9"}'
        return MAGIC + len(head).to_bytes(4, "big") + head + good[start:]
    assert kind == "truncated"
    return good[:len(MAGIC) + 2]


@pytest.mark.parametrize("kind", ["flax_lm_blob", "flax_checkpoint",
                                  "corrupt_header", "wrong_format",
                                  "truncated"])
def test_foreign_or_broken_blob_raises(stores, kind):
    """A blob that is not the port's format raises a ValueError naming
    the format, from decode_state and from load_lm."""
    blob = _foreign_blob(kind)
    with pytest.raises(ValueError, match="format|header"):
        decode_state(blob)
    stores["n0"].put_bytes(lm_store_name("chat"), blob)
    with pytest.raises(ValueError, match="format|header"):
        load_lm(stores["n1"], "chat", device="cpu")
    if kind in ("wrong_format", "flax_lm_blob", "flax_checkpoint"):
        with pytest.raises(ValueError, match=FORMAT.split("/")[0]):
            decode_state(blob)


# -- checkpoints ---------------------------------------------------------------


def test_checkpoint_round_trip_and_restore_version(stores):
    a = carried(jax_lm(seed=0)[1])
    b = carried(jax_lm(seed=1)[1])
    assert save_variables(stores["n0"], "lm", a) == 1
    assert save_variables(stores["n1"], "lm", b.state_dict()) == 2
    assert sorted(checkpoint_holders(stores["n0"], "lm")) == ["n0", "n1"]
    assert checkpoint_name("lm") == "ckpt.pt/lm"
    fresh = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    got, version = restore_variables(stores["n1"], "lm", fresh)
    assert got is fresh and version == 2
    for k, v in b.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    old = restore_version(stores["n0"], "lm", fresh, version=1)
    for k, v in a.state_dict().items():
        assert torch.equal(old.state_dict()[k], v), k
    # strict: a template of another shape refuses the blob
    wider = TransformerLM(vocab=VOCAB, dim=64, depth=2, num_heads=4)
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_variables(stores["n0"], "lm", wider)


# -- the engine's store seam ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(JaxEngineConfig(compute_dtype="float32",
                                     preprocess="xla", **SMALL),
                     mesh=local_mesh(), seed=0, pretrained=False)


def port_engine(store, **kw) -> InferenceEngine:
    return InferenceEngine(EngineConfig(compute_dtype="float32",
                                        preprocess="plain", **SMALL, **kw),
                           device="cpu", store=store)


def test_published_weights_serve_with_store_provenance(stores, jax_engine):
    """n0 carries the JAX engine's weights and publishes them; n1's engine
    loads them from the store (provenance "store") and answers as the JAX
    engine does: the same top-1 categories, probabilities within
    PROB_ATOL."""
    name = "resnet"
    jax_engine.load(name)
    variables = jax.tree.map(np.asarray, jax_engine._models[name].variables)
    src = port_engine(stores["n0"])
    src.load(name, state_dict=state_dict_from_flax(name, variables))
    assert src.weights_provenance(name) == "random"
    with pytest.raises(ValueError, match="RANDOM"):
        src.publish_weights(name)
    assert src.publish_weights(name, allow_random=True) == 1
    dst = port_engine(stores["n1"])
    out = dst.infer(name, 0, 20)
    ref = jax_engine.infer(name, 0, 20)
    assert out.weights == dst.weights_provenance(name) == "store"
    assert [r[:2] for r in out.records] == [r[:2] for r in ref.records]
    np.testing.assert_allclose([r[2] for r in out.records],
                               [r[2] for r in ref.records],
                               rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("blob", ["other_model", "garbage"])
def test_unusable_store_weights_fall_back_to_seeded(stores, blob):
    """Weights the engine cannot use are skipped with a warning: the
    model serves its seeded weights, provenance "random"."""
    if blob == "garbage":
        stores["n0"].put_bytes(checkpoint_name("resnet"), b"\x00" * 64)
    else:                   # keys and shapes of another model
        save_variables(stores["n0"], "resnet", carried(jax_lm()[1]))
    eng = port_engine(stores["n1"])
    seeded = port_engine(None)
    out, ref = eng.infer("resnet", 0, 7), seeded.infer("resnet", 0, 7)
    assert out.weights == "random"
    assert out.records == ref.records


def test_int8_engine_refuses_to_publish(stores):
    eng = port_engine(stores["n0"], quantize="int8")
    with pytest.raises(ValueError, match="int8"):
        eng.publish_weights("resnet", allow_random=True)
    with pytest.raises(ValueError, match="no store"):
        port_engine(None).publish_weights("resnet", allow_random=True)


def test_store_dataset_query_matches_local_dataset(stores):
    """Images published into the store answer a ``store://`` query with
    the records of the same range from the local (synthetic) dataset."""
    _, images = data_lib.load_range(None, 0, 29, size=SMALL["resize_size"])
    meta = publish_images(stores["n0"], "tiny", images, shard_size=8)
    assert meta["n_shards"] == 4
    eng = port_engine(stores["n1"])
    local = eng.infer("resnet", 3, 25)
    staged = eng.infer("resnet", 3, 25, dataset_root="store://tiny")
    assert staged.records == local.records and len(local.records) == 23
    with pytest.raises(ValueError, match="store attached"):
        port_engine(None).infer("resnet", 0, 3, dataset_root="store://tiny")
