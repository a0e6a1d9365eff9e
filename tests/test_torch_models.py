"""Parity of the PyTorch port's ResNet and AlexNet with the JAX package.

Both sides compute in f32 on the CPU. The JAX variables are filled from a
numpy seed (every leaf, BatchNorm statistics included, so no zero-init
hides a path), carried into the port by ``state_dict_from_flax``, and the
same numpy images go through both models: plain on normalized input, and
with ``fold_preprocess`` on raw cropped 0..255 input. The weight carry is
checked as a round trip through the JAX package's own converters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.models import create_model as jax_create_model
from idunno_tpu.models.convert import (convert_alexnet, convert_resnet18,
                                       convert_resnet50)
from idunno_tpu_torch.models import available_models, create_model
from idunno_tpu_torch.models.convert import state_dict_from_flax
from tests.torch_workers import share_cores  # noqa: F401

SIDE = 64     # small images, as tests/test_cluster_e2e.py uses


def random_variables(name: str, seed: int, side: int = SIDE) -> dict:
    """The JAX model's variable tree, every leaf drawn from a numpy seed:
    kernels at variance 1/fan_in, BatchNorm scale and var in [0.5, 1.5]."""
    module = jax_create_model(name, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = path[-1].key
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def normalized_images(seed: int, batch: int = 4, side: int = SIDE) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, side, side, 3)).astype(np.float32)


def raw_images(seed: int, batch: int = 4, side: int = SIDE) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, side, side, 3)).astype(np.float32)


def jax_logits(name, variables, x_nhwc, **kwargs) -> np.ndarray:
    module = jax_create_model(name, dtype=jnp.float32, **kwargs)
    return np.asarray(module.apply(variables, jnp.asarray(x_nhwc), train=False))


def port_logits(name, state_dict, x_nhwc, **kwargs) -> np.ndarray:
    model = create_model(name, **kwargs).eval()
    model.load_state_dict(state_dict)
    with torch.no_grad():
        x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
        return model(x).numpy()


def assert_logits_close(out: np.ndarray, ref: np.ndarray) -> None:
    # f32 on both sides; convolutions sum in another order (oneDNN vs
    # XLA:CPU), which moves each logit by some tens of f32 ulps (1.2e-7)
    # of the logits' own scale
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5 * scale)


@pytest.fixture(scope="module")
def carried():
    out = {}
    for name in ("resnet", "alexnet"):
        variables = random_variables(name, seed=len(name))
        out[name] = (variables, state_dict_from_flax(name, variables))
    return out


@pytest.mark.parametrize("name", ["resnet", "alexnet"])
def test_logits_match_jax(carried, name):
    variables, sd = carried[name]
    x = normalized_images(1)
    ref = jax_logits(name, variables, x)
    out = port_logits(name, sd, x)
    assert out.shape == (4, 1000) and out.dtype == np.float32
    assert_logits_close(out, ref)


@pytest.mark.parametrize("name", ["resnet", "alexnet"])
def test_folded_logits_match_jax(carried, name):
    variables, sd = carried[name]
    x = raw_images(2)
    ref = jax_logits(name, variables, x, fold_preprocess=True)
    out = port_logits(name, sd, x, fold_preprocess=True)
    assert_logits_close(out, ref)


@pytest.mark.parametrize("name", ["resnet", "alexnet"])
def test_fold_equals_normalize_then_plain(carried, name):
    """The folded stem on raw input equals the plain model on the
    normalized input: the identity the fold rests on."""
    _, sd = carried[name]
    raw = raw_images(3)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    folded = port_logits(name, sd, raw, fold_preprocess=True)
    plain = port_logits(name, sd, (raw / 255.0 - mean) / std)
    assert_logits_close(folded, plain)


def test_alexnet_adaptive_pool_is_not_identity_at_64():
    """At 64² the feature map is 1x1, so the 1→6 pool replicates it: the
    case where the pool matters, and where fc0's row order is tested."""
    model = create_model("alexnet").eval()
    with torch.no_grad():
        feats = model.features(torch.zeros(1, 3, SIDE, SIDE))
    assert feats.shape[-2:] == (1, 1)


@pytest.mark.parametrize("name,convert", [
    ("resnet", convert_resnet18), ("resnet50", convert_resnet50),
    ("alexnet", convert_alexnet)])
def test_weight_carry_round_trips_exactly(name, convert, carried):
    variables = (carried[name][0] if name in carried
                 else random_variables(name, seed=5))
    sd = state_dict_from_flax(name, variables)
    # the port's module takes the carried state_dict as it is (strict)
    create_model(name).load_state_dict(sd)
    back = convert(sd)
    flat_ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_registry_and_unported_options():
    """The registry lists the JAX package's names, ViTs included; a name
    it does not hold raises, and so do the two stem recasts together."""
    assert available_models() == ["alexnet", "resnet", "resnet18",
                                  "resnet34", "resnet50", "vit", "vit_tiny"]
    with pytest.raises(ValueError):
        create_model("vit_l16")
    with pytest.raises(ValueError, match="pick one"):
        create_model("resnet", stem_s2d=True, fold_preprocess=True)
    with pytest.raises(ValueError):
        state_dict_from_flax("vit_l16", {})


# space-to-depth stem: the same function as the 7x7 stem, summed in
# another order, so within f32 reassociation of the logits' scale
S2D_TOL = 1e-4


@pytest.mark.parametrize("seed", [1, 2])
def test_s2d_stem_matches_jax_s2d_and_port_7x7(carried, seed):
    variables, sd = carried["resnet"]
    x = normalized_images(seed)
    ref = jax_logits("resnet", variables, x, stem_s2d=True)
    out = port_logits("resnet", sd, x, stem_s2d=True)
    plain = port_logits("resnet", sd, x)
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=S2D_TOL * scale)
    np.testing.assert_allclose(out, plain, rtol=0, atol=S2D_TOL * scale)


def test_s2d_stem_keeps_the_parameter_and_needs_even_sides():
    model = create_model("resnet", stem_s2d=True)
    assert type(model.conv1).__name__ == "_S2DStem"
    assert model.conv1.weight.shape == (64, 3, 7, 7)
    assert set(model.state_dict()) == set(create_model("resnet").state_dict())
    with pytest.raises(ValueError, match="even"):
        model.eval()(torch.zeros(1, 3, 33, 33))


def test_seeded_init_is_deterministic_and_zeroes_last_bn():
    a, b = create_model("resnet"), create_model("resnet")
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    assert torch.count_nonzero(a.layer1[0].bn2.weight) == 0
    w = a.conv1.weight.detach()
    # lecun_normal: std sqrt(1/fan_in), truncated at two std
    bound = 2 * (1 / w[0].numel()) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= bound
