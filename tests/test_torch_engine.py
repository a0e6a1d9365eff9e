"""The PyTorch port's ``InferenceEngine`` against the JAX package's, on the
CPU at f32 compute, 64² images and batch 8.

The JAX engine initialises each model (ResNet-18, AlexNet, ViT-Ti/16) from
its seed; its variables are carried into the port's engine
(``load(name, state_dict=...)``), and both engines answer the same query
range from the same synthetic images, with dense weights and with int8
ones (``quantize="int8"``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu import native as jax_native
from idunno_tpu.config import EngineConfig as JaxEngineConfig
from idunno_tpu.engine import data as jax_data
from idunno_tpu.engine.inference import InferenceEngine as JaxEngine
from idunno_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from idunno_tpu.parallel.mesh import local_mesh
from idunno_tpu_torch import native
from idunno_tpu_torch.config import EngineConfig
from idunno_tpu_torch.engine import data as data_lib
from idunno_tpu_torch.engine.inference import InferenceEngine
from idunno_tpu_torch.models.convert import state_dict_from_flax
from idunno_tpu_torch.ops.quantize import dequantize_tree

SMALL = dict(batch_size=8, image_size=64, resize_size=64)
MODELS = ["resnet", "alexnet", "vit_tiny"]
# f32 on both sides: probabilities of ~1e-3 agree to a few f32 ulps of
# the logits, far below this; argmax must agree where the JAX top-2
# probability margin exceeds it
PROB_ATOL = 1e-6


@pytest.fixture(scope="module")
def engines():
    """The JAX engine (plain ``xla`` preprocess) and the port's engine
    (``plain``) carrying its weights."""
    jeng = JaxEngine(JaxEngineConfig(compute_dtype="float32",
                                     preprocess="xla", **SMALL),
                     mesh=local_mesh(), seed=0, pretrained=False)
    peng = InferenceEngine(EngineConfig(compute_dtype="float32",
                                        preprocess="plain", **SMALL),
                           device="cpu")
    for name in MODELS:
        jeng.load(name)
        variables = jax.tree.map(np.asarray, jeng._models[name].variables)
        peng.load(name, state_dict=state_dict_from_flax(name, variables))
    return jeng, peng


def jax_top2_margin(jeng, name: str, start: int, end: int) -> np.ndarray:
    """p(top-1) - p(top-2) of the JAX engine's own forward."""
    _, images = jax_data.load_range(None, start, end, size=SMALL["resize_size"])
    m = jeng._models[name]
    x = jax_preprocess(jnp.asarray(images), crop=SMALL["image_size"])
    logits = jax.jit(lambda v, x: m.module.apply(v, x, train=False))(
        m.variables, x)
    top2 = np.sort(np.asarray(jax.nn.softmax(logits, -1)), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("name", MODELS)
def test_infer_records_match_jax_engine(engines, name):
    jeng, peng = engines
    ref = jeng.infer(name, 0, 20)           # 21 images: a ragged last batch
    out = peng.infer(name, 0, 20)
    assert out.weights == ref.weights == "random"
    assert [r[0] for r in out.records] == [r[0] for r in ref.records]
    np.testing.assert_allclose([r[2] for r in out.records],
                               [r[2] for r in ref.records],
                               rtol=0, atol=PROB_ATOL)
    decided = jax_top2_margin(jeng, name, 0, 20) > PROB_ATOL
    assert decided.any()
    for r_out, r_ref, d in zip(out.records, ref.records, decided):
        if d:
            assert r_out[1] == r_ref[1], (r_out, r_ref)


# the port's other modes against its ``plain`` mode on the same weights,
# relative to the logits' scale: ``fold`` is the same function in f32
# (some tens of f32 ulps, as in tests/test_torch_models.py); ``kernel`` on
# the CPU runs the kernel's plain version, whose bf16 output rounds the
# model's input by up to 2^-9 relative
@pytest.mark.parametrize("mode,rel_tol", [("fold", 2e-5), ("kernel", 1e-2)])
@pytest.mark.parametrize("name", MODELS)
def test_other_modes_match_plain_mode(engines, name, mode, rel_tol):
    _, plain = engines
    other = InferenceEngine(EngineConfig(compute_dtype="float32",
                                         preprocess=mode, **SMALL),
                            device="cpu")
    other.load(name, state_dict=plain._models[name].state_dict())
    _, images = data_lib.load_range(None, 0, 7, size=SMALL["resize_size"])
    batch = torch.from_numpy(images)
    ref = plain.logits(name, batch).numpy()
    out = other.logits(name, batch).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel_tol * scale)


@pytest.mark.parametrize("name", MODELS)
def test_batch_and_staged_paths_agree_with_infer(engines, name):
    _, peng = engines
    res = peng.infer(name, 0, 11)
    _, images = data_lib.load_range(None, 0, 11, size=SMALL["resize_size"])
    idx_b, prob_b = peng.infer_batch(name, images)
    staged, n = peng.stage(images)
    assert tuple(staged.shape) == (2, 8, 64, 64, 3) and n == 12
    idx_s, prob_s = peng.infer_staged(name, staged, n)
    cats = [peng.categories[i] for i in idx_b]
    assert cats == [r[1] for r in res.records]
    np.testing.assert_array_equal(idx_b, idx_s)
    np.testing.assert_allclose(prob_b, [r[2] for r in res.records],
                               rtol=1e-6)
    np.testing.assert_allclose(prob_s, prob_b, rtol=1e-6)
    assert peng.infer_batch(name, images[:0])[0].shape == (0,)


def test_engine_surface(engines):
    _, peng = engines
    assert peng.loaded_models() == ["alexnet", "resnet", "vit_tiny"]
    assert peng.weights_provenance("resnet") == "random"
    assert peng.weights_provenance("resnet50") == "unknown"
    assert peng.warmup("alexnet") >= 0.0
    # a store:// dataset needs the engine's store (tests/test_torch_store.py
    # serves one through a node's store)
    with pytest.raises(ValueError, match="store attached"):
        peng.infer("alexnet", 0, 3, dataset_root="store://imagenet")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        InferenceEngine()
    with pytest.raises(RuntimeError):
        InferenceEngine(device="cuda")
    assert InferenceEngine(device="cpu").preprocess == "plain"


@pytest.mark.parametrize("kwargs,err", [
    (dict(preprocess="pallas"), ValueError),
    (dict(preprocess="xla"), ValueError),
    (dict(quantize="int4"), ValueError),
])
def test_config_rejects_unported_or_unknown_modes(kwargs, err):
    with pytest.raises(err):
        EngineConfig(**kwargs)


def test_stem_s2d_is_not_ported_yet(engines):
    """``stem_s2d=True`` serves the same top-1 (and probabilities within
    f32 reassociation) as the 7x7 stem on the same weights; the families
    without the option (AlexNet, ViT) ignore it."""
    _, plain = engines
    s2d = InferenceEngine(EngineConfig(compute_dtype="float32",
                                       preprocess="plain", stem_s2d=True,
                                       **SMALL), device="cpu")
    for name in MODELS:
        s2d.load(name, state_dict=plain._models[name].state_dict())
    assert type(s2d._models["resnet"].conv1).__name__ == "_S2DStem"
    for name in MODELS:
        ref, out = plain.infer(name, 0, 7), s2d.infer(name, 0, 7)
        assert [r[1] for r in out.records] == [r[1] for r in ref.records]
        np.testing.assert_allclose([r[2] for r in out.records],
                                   [r[2] for r in ref.records],
                                   rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("shape", [(64, 64), (50, 80), (90, 70)])
def test_staging_matches_jax_package(shape):
    rng = np.random.default_rng(shape[0])
    frames = [rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
              for _ in range(2)]
    np.testing.assert_array_equal(native.stage_batch(frames, 64),
                                  jax_native.stage_batch(frames, 64))


INT8_MODELS = ["resnet", "vit_tiny"]


@pytest.fixture(scope="module")
def int8_engines(engines):
    """The JAX int8 engine (same seed as the dense one), and the port's
    int8 engine carrying the dense engines' weights."""
    jint8 = JaxEngine(JaxEngineConfig(compute_dtype="float32",
                                      preprocess="xla", quantize="int8",
                                      **SMALL),
                      mesh=local_mesh(), seed=0, pretrained=False)
    port = InferenceEngine(EngineConfig(compute_dtype="float32",
                                        preprocess="plain", quantize="int8",
                                        **SMALL), device="cpu")
    for name in INT8_MODELS:
        port.load(name, state_dict=engines[1]._models[name].state_dict())
    return jint8, port


@pytest.mark.parametrize("name", INT8_MODELS)
def test_int8_engine_matches_jax_int8_engine(int8_engines, name):
    """Probabilities within the f32 tolerance above, top-1 equal where
    the top-2 margin exceeds it."""
    jeng, peng = int8_engines
    ref = jeng.infer(name, 0, 7)
    out = peng.infer(name, 0, 7)
    assert [r[0] for r in out.records] == [r[0] for r in ref.records]
    np.testing.assert_allclose([r[2] for r in out.records],
                               [r[2] for r in ref.records],
                               rtol=0, atol=PROB_ATOL)
    _, images = data_lib.load_range(None, 0, 7, size=SMALL["resize_size"])
    probs = torch.softmax(peng.logits(name, torch.from_numpy(images)), -1)
    top2 = probs.sort(dim=-1).values[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > PROB_ATOL
    assert bool(decided.any())
    for r_out, r_ref, d in zip(out.records, ref.records, decided):
        if d:
            assert r_out[1] == r_ref[1], (r_out, r_ref)


@pytest.mark.parametrize("name", INT8_MODELS)
def test_int8_engine_equals_dense_engine_on_dequantized_weights(
        int8_engines, name):
    _, peng = int8_engines
    dense = InferenceEngine(EngineConfig(compute_dtype="float32",
                                         preprocess="plain", **SMALL),
                            device="cpu")
    dense.load(name, state_dict=dequantize_tree(peng._models[name]))
    _, images = data_lib.load_range(None, 0, 7, size=SMALL["resize_size"])
    batch = torch.from_numpy(images)
    np.testing.assert_array_equal(peng.logits(name, batch).numpy(),
                                  dense.logits(name, batch).numpy())
