"""Ulysses sequence parallelism of the port against the JAX package's, on
the CPU (virtual meshes): the counterpart of ``tests/test_ulysses.py``.

- ``ulysses_attention`` over 8 and 4 groups, causal and not: outputs and
  q/k/v gradients against JAX ``ulysses_attention`` (its ``jax.vjp``)
  within 1e-5 (f32);
- the head guard: JAX's "use ring_attention instead";
- the output keeps the inputs' shape and device;
- flash as the local attention (K2, K4/K5 through ``FlashAttention``;
  their plain versions here) against JAX ``full_attention`` within 1e-5,
  gradients too;
- ``make_attn_fn("ulysses", mesh=)`` takes ``auto`` as its local
  attention; a ``TransformerLM`` attending by Ulysses against the JAX
  model's one-device forward on carried weights (1e-5 of the largest
  logit; JAX's own test holds 2e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.parallel.mesh import make_mesh as jax_make_mesh
from idunno_tpu.parallel.ring_attention import full_attention as jax_full
from idunno_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import (TransformerLM,
                                                 auto_attention, make_attn_fn)
from idunno_tpu_torch.ops.flash_attention import flash_attention
from idunno_tpu_torch.parallel.mesh import virtual_mesh
from idunno_tpu_torch.parallel.ulysses import ulysses_attention
from tests.test_torch_ring_attention import (jax_out_and_grads,
                                             port_out_and_grads, qkv)
from tests.torch_workers import share_cores  # noqa: F401


@pytest.mark.parametrize("p", [8, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_ulysses(eight_devices, p, causal):
    arrays = qkv(10 * p + causal, h=8)
    do = np.random.default_rng(98).standard_normal(
        arrays[0].shape).astype(np.float32)
    jmesh = jax_make_mesh(p, 1, devices=eight_devices[:p])
    want, want_g = jax_out_and_grads(
        lambda q, k, v: jax_ulysses(q, k, v, jmesh, causal=causal), arrays,
        do)
    mesh = virtual_mesh(p, 1, "cpu")
    got, got_g = port_out_and_grads(
        lambda q, k, v: ulysses_attention(q, k, v, mesh, causal=causal),
        arrays, do)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)


def test_ulysses_head_guard_and_shapes():
    """4 heads over 8 groups raise JAX's words; the output keeps the
    inputs' shape and device (JAX ``test_ulysses_keeps_sequence_
    sharding``)."""
    mesh = virtual_mesh(8, 1, "cpu")
    q, k, v = map(torch.from_numpy, qkv(1, h=4))
    with pytest.raises(ValueError, match="use ring_attention instead"):
        ulysses_attention(q, k, v, mesh)
    q, k, v = map(torch.from_numpy, qkv(2, t=128, h=8))
    out = ulysses_attention(q, k, v, mesh, causal=True)
    assert out.shape == (2, 128, 8, 16) and out.device == q.device


def test_ulysses_with_flash_local_attention():
    """Flash as each group's attention (JAX ``test_ulysses_with_flash_
    local_attention``) against JAX ``full_attention``: outputs and
    gradients within 1e-5."""
    arrays = qkv(3, h=8)
    do = np.random.default_rng(97).standard_normal(
        arrays[0].shape).astype(np.float32)
    want, want_g = jax_out_and_grads(
        lambda q, k, v: jax_full(q, k, v, causal=True), arrays, do)
    mesh = virtual_mesh(8, 1, "cpu")
    got, got_g = port_out_and_grads(
        lambda q, k, v: ulysses_attention(q, k, v, mesh, causal=True,
                                          local_attn=flash_attention),
        arrays, do)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)


def test_ulysses_lm_matches_jax_one_device_forward():
    """JAX ``test_transformer_with_ulysses_matches_local``'s model (dim 64,
    8 heads, depth 1, tokens [2, 64]) attending by Ulysses over 8 groups,
    ``make_attn_fn``'s default local attention (``auto``: full here)."""
    mesh = virtual_mesh(8, 1, "cpu")
    fn = make_attn_fn("ulysses", mesh=mesh)
    assert fn.keywords["local_attn"] is auto_attention
    jm = JaxLM(vocab=64, dim=64, depth=1, num_heads=8)
    toks = np.random.default_rng(0).integers(0, 64, (2, 64))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.asarray(toks))["params"]
    tm = TransformerLM(vocab=64, dim=64, depth=1, num_heads=8, attn_fn=fn)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
