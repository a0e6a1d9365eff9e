"""The port's weight-only int8 (``idunno_tpu_torch/ops/quantize.py``)
against the JAX package's (``idunno_tpu/ops/quantize.py``), on the CPU.

The JAX variables are drawn from a numpy seed, carried into the port by
the weight converters, and quantized on both sides. ``q`` and ``scale``
must be bit-equal for every weight of the LM (q/k/v/out and their
biases, MLP, embedding, head), ResNet-18 (convs, fc) and ViT (patch
embedding, ``cls``, ``pos_embed``, blocks), in f32 and in bf16: the
port's per-channel grouping is laid out in the port's own tensor layout,
so the JAX side's ``q`` and its broadcast ``scale`` go through the same
converters before the comparison. ``tests/test_torch_engine.py`` holds
the int8 ``InferenceEngine`` to the JAX int8 engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.models import create_model as jax_create_model
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.ops import quantize as jq
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.convert import (lm_state_dict_from_flax,
                                             state_dict_from_flax)
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.ops.quantize import (dequantize_tree, qtensors,
                                           quantize_leaf, quantize_tree,
                                           quantized_bytes)
from tests.torch_workers import share_cores  # noqa: F401

LM = dict(vocab=61, dim=32, depth=2, num_heads=4)


def _is_q(leaf) -> bool:
    return isinstance(leaf, jq.QTensor)


def filled(module, x, seed: int, bf16: bool, **apply_kw) -> dict:
    """The JAX module's variables, every leaf from a numpy seed (norm
    scales and variances in [0.5, 1.5]); bf16-valued when ``bf16``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                **apply_kw))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        v = torch.from_numpy(v.astype(np.float32))
        return (v.bfloat16() if bf16 else v).float().numpy()

    return jax.tree_util.tree_map_with_path(fill, shapes)


def lm_case(seed, bf16):
    variables = filled(JaxLM(**LM), jnp.zeros((1, 8), jnp.int32), seed, bf16)
    model = TransformerLM(**LM)
    return (variables["params"], model,
            lambda tree: lm_state_dict_from_flax(tree))


def resnet_case(seed, bf16):
    variables = filled(jax_create_model("resnet18", dtype=jnp.float32),
                       jnp.zeros((1, 32, 32, 3)), seed, bf16, train=False)
    return (variables, create_model("resnet18"),
            lambda tree: state_dict_from_flax("resnet18", tree))


def vit_case(seed, bf16):
    variables = filled(jax_create_model("vit_tiny", dtype=jnp.float32),
                       jnp.zeros((1, 32, 32, 3)), seed, bf16, train=False)
    return (variables["params"], create_model("vit_tiny", image_size=32),
            lambda tree: state_dict_from_flax("vit_tiny", tree))


CASES = {"lm": lm_case, "resnet18": resnet_case, "vit_tiny": vit_case}


def quantized_pair(case: str, bf16: bool):
    """(JAX quantized tree, the port's quantized model, converter)."""
    tree, model, convert = CASES[case](seed=len(case), bf16=bf16)
    model.load_state_dict(convert(tree))
    if bf16:
        model = model.to(torch.bfloat16)
        tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    return jq.quantize_tree(tree), quantize_tree(model), convert


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_q_and_scale_bit_equal_to_jax(case, bf16):
    jtree, model, convert = quantized_pair(case, bf16)

    def as_port(part):
        """A JAX tree of ``q`` (or ``scale`` broadcast to the weight's
        shape) at each quantized leaf, carried into the port's layout."""
        def leaf(x):
            if not _is_q(x):
                return np.zeros(np.shape(x), np.float32)
            v = x.q if part == "q" else jnp.broadcast_to(x.scale, x.q.shape)
            return np.asarray(v, np.float32)
        return convert(jax.tree.map(leaf, jtree, is_leaf=_is_q))

    want_q, want_scale = as_port("q"), as_port("scale")
    got = qtensors(model)
    n_jax = sum(map(_is_q, jax.tree.leaves(jtree, is_leaf=_is_q)))
    assert len(got) == n_jax > 0
    for path, qt in got.items():
        assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
        np.testing.assert_array_equal(qt.q.float().numpy(),
                                      want_q[path].numpy(), err_msg=path)
        full = (torch.ones(qt.view) * qt.scale).reshape(qt.shape)
        np.testing.assert_array_equal(full.numpy(), want_scale[path].numpy(),
                                      err_msg=path)
    assert quantized_bytes(model) == jq.quantized_bytes(jtree)


def test_qkv_grouping_is_per_head_dim_and_cls_per_element():
    """The groupings the flax layouts imply: q/k/v share one scale per
    head-dim index across heads, the embedding one per column, ViT's
    ``cls`` one per element, and the output projection one per row."""
    _, lm, _ = quantized_pair("lm", False)
    qts = qtensors(lm)
    hd = LM["dim"] // LM["num_heads"]
    assert qts["blocks.0.attn.q.weight"].scale.shape == (1, hd, 1)
    assert qts["blocks.0.attn.q.bias"].scale.shape == (1, hd)
    assert qts["blocks.0.attn.out.weight"].scale.shape == (LM["dim"], 1)
    assert qts["embed.weight"].scale.shape == (1, LM["dim"])
    _, vit, _ = quantized_pair("vit_tiny", False)
    qts = qtensors(vit)
    assert qts["cls"].scale.shape == (1, 1, 192)
    assert bool((qts["cls"].q.abs() == 127).all())
    assert qts["pos_embed"].scale.shape == (1, 1, 192)
    assert qts["embed.weight"].scale.shape == (192, 1, 1, 1)


def test_roundtrip_error_bounded_per_channel():
    """As tests/test_quantize.py: within half a step of each channel."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 3.0, (9, 64, 32)).astype(np.float32))
    qt = quantize_leaf(w)
    assert qt.q.dtype == torch.int8 and qt.scale.shape == (1, 1, 32)
    bound = (qt.scale / 2 + 1e-7).expand(w.shape)
    assert bool(((qt.dequantize() - w).abs() < bound).all())


def test_dequantized_model_is_within_half_a_step():
    tree, model, convert = lm_case(seed=5, bf16=False)
    model.load_state_dict(convert(tree))
    dense = {k: v.clone() for k, v in model.state_dict().items()}
    quantize_tree(model)
    for path, qt in qtensors(model).items():
        step = (torch.ones(qt.view) * qt.scale).reshape(qt.shape)
        assert bool(((qt.dequantize() - dense[path]).abs()
                     <= step / 2 + 1e-7).all()), path


def test_zero_channel_and_selection_rules():
    model = TransformerLM(**LM)
    with torch.no_grad():
        model.blocks[0].mlp_up.weight[3].zero_()
    quantize_tree(model, should_quantize=lambda path, leaf: (
        leaf.dim() >= 2 and not path.startswith("embed")))
    qts = qtensors(model)
    up = qts["blocks.0.mlp_up.weight"]
    assert float(up.scale[3]) == 1.0 and bool((up.q[3] == 0).all())
    assert "embed.weight" not in qts and "head.weight" in qts
    params = dict(model.named_parameters())
    # ndim ≤ 1 leaves (norm scales, the non-q/k/v biases) and the excluded
    # embedding stay dense parameters; the int8 tensors are buffers
    assert {"blocks.0.ln1.weight", "blocks.0.mlp_up.bias",
            "blocks.0.attn.out.bias", "embed.weight"} <= set(params)
    assert "blocks.0.attn.q.bias" not in params
    assert all(p.is_floating_point() for p in params.values())
    back = dequantize_tree(model)
    fresh = TransformerLM(**LM)
    fresh.load_state_dict(back)         # strict: the dense model's keys
    assert back["blocks.0.mlp_up.weight"].dtype == torch.float32
