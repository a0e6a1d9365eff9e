"""Parity of the port's ViT (``idunno_tpu_torch/models/vit.py``) with the
JAX package's, on the CPU in f32.

ViT-Ti/16 (``vit_tiny``: dim 192, depth 4, 3 heads) at 32² and 64² (T = 5
and 17 tokens with ``cls``): the JAX variables are drawn from a numpy
seed, carried into the port (``state_dict_from_flax("vit_tiny", ...)``),
and the same numpy images go through both models: with ``full``
attention, with ``flash`` (on the CPU the flash kernels' plain version,
the function K2 computes on a card), and with ``fold_preprocess`` on raw
0..255 input. Logits agree within 1e-4 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.models import create_model as jax_create_model
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.convert import state_dict_from_flax
from idunno_tpu_torch.models.transformer import make_attn_fn
from tests.torch_workers import share_cores  # noqa: F401

SIDES = [32, 64]
TOL = 1e-4


def variables_for(side: int) -> dict:
    """vit_tiny's JAX variables at ``side``², every leaf from a numpy seed
    (``cls`` too, which flax initialises to zero)."""
    module = jax_create_model("vit_tiny", dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)), train=False))
    rng = np.random.default_rng(side)

    def fill(path, s):
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if path[-1].key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def carried():
    return {side: variables_for(side) for side in SIDES}


def images(seed: int, side: int, raw: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if raw:
        return rng.integers(0, 256, (3, side, side, 3)).astype(np.float32)
    return rng.standard_normal((3, side, side, 3)).astype(np.float32)


def both_logits(variables, side: int, x: np.ndarray, attn: str = "full",
                **kw) -> tuple[np.ndarray, np.ndarray]:
    jmodel = jax_create_model("vit_tiny", dtype=jnp.float32, **kw)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = create_model("vit_tiny", image_size=side,
                         attn_fn=make_attn_fn(attn), **kw).eval()
    model.load_state_dict(state_dict_from_flax("vit_tiny", variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    return out, ref


@pytest.mark.parametrize("attn", ["full", "flash"])
@pytest.mark.parametrize("side", SIDES)
def test_vit_logits_match_jax(carried, side, attn):
    out, ref = both_logits(carried[side], side, images(side, side, False),
                           attn)
    assert out.shape == (3, 1000) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("side", SIDES)
def test_vit_folded_logits_match_jax(carried, side):
    out, ref = both_logits(carried[side], side, images(side + 1, side, True),
                           fold_preprocess=True)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))


def test_vit_shapes_and_refusals():
    model = create_model("vit_tiny", image_size=64)
    assert model.pos_embed.shape == (1, 17, 192)
    assert create_model("vit").pos_embed.shape == (1, 197, 384)
    with pytest.raises(ValueError, match="not divisible"):
        create_model("vit_tiny", image_size=65)
    with pytest.raises(ValueError, match="built for 64"):
        model(torch.zeros(1, 3, 32, 32))
    model.init_weights(torch.Generator().manual_seed(0))
    assert float(model.cls.detach().abs().max()) == 0.0
    assert 0.0 < float(model.pos_embed.detach().std()) < 0.03
