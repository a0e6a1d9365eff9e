"""Ring attention and the sequence-parallel LM step of the port against
the JAX package's, on the CPU (virtual meshes; the kernels' plain
versions): the counterparts of ``tests/test_ring_attention.py`` and of
``tests/test_train_lm.py::test_lm_sequence_parallel_training``.

- ``ring_attention`` over 8 and 4 groups, causal and not: outputs and
  q/k/v gradients against JAX ``ring_attention`` (its ``jax.vjp``)
  within 1e-5 (f32, the merges in another order);
- the ring's live pairs: p(p+1)/2 K2 calls a causal call, p² otherwise;
- ``make_attn_fn("ring", mesh=)``; other kinds with a mesh raise JAX's
  "ignores mesh";
- a ``TransformerLM`` attending by ring against the JAX model's one-device
  forward on carried weights (1e-5 of the largest logit);
- ``jit_lm_train_step(sequence_parallel=True)`` against JAX's on
  ``make_mesh(8, 1)`` from carried weights: losses (rtol 1e-5) and
  parameters (1e-4 of each tensor's largest; 4.9e-5 seen: Adam divides
  by the root of tiny second moments) after three Adam steps; the typed
  refusal of an
  axis the model does not attend over, and of a mesh across processes
  outside the process group it was made in.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idunno_tpu.engine import train as jax_train
from idunno_tpu.engine import train_lm as jax_train_lm
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.parallel.mesh import make_mesh as jax_make_mesh
from idunno_tpu.parallel.ring_attention import ring_attention as jax_ring
from idunno_tpu_torch.engine.train import TrainState, adam
from idunno_tpu_torch.engine.train_lm import (SequenceAxisError,
                                              jit_lm_train_step)
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM, make_attn_fn
from idunno_tpu_torch.parallel.mesh import Mesh, MeshShapeError, virtual_mesh
from idunno_tpu_torch.parallel.ring_attention import (full_attention,
                                                      ring_attention,
                                                      ring_pairs)
from tests.torch_workers import share_cores  # noqa: F401


def qkv(seed, b=2, t=64, h=4, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def jax_out_and_grads(fn, arrays, do):
    @jax.jit
    def both(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    out, grads = both(*map(jnp.asarray, arrays), jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_out_and_grads(fn, arrays, do):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = fn(q, k, v)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


@pytest.mark.parametrize("p,t", [(8, 64), (4, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring(eight_devices, p, t, causal):
    """Outputs and q/k/v gradients within 1e-5 of the JAX ring's (JAX
    ``test_ring_matches_full_attention`` at p 8, ``odd_mesh`` at p 4)."""
    arrays = qkv(p + causal, t=t)
    do = np.random.default_rng(99).standard_normal(
        arrays[0].shape).astype(np.float32)
    jmesh = jax_make_mesh(p, 1, devices=eight_devices[:p])
    want, want_g = jax_out_and_grads(
        lambda q, k, v: jax_ring(q, k, v, jmesh, causal=causal), arrays, do)
    mesh = virtual_mesh(p, 1, "cpu")
    got, got_g = port_out_and_grads(
        lambda q, k, v: ring_attention(q, k, v, mesh, causal=causal),
        arrays, do)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)


def test_ring_pairs_and_shapes():
    """A causal ring runs p(p+1)/2 block pairs (the diagonal ones masked),
    a non-causal one p²; the output has the inputs' shape and device (JAX
    ``test_ring_attention_jits_with_sharded_inputs``), and a sequence the
    axis does not divide raises."""
    for p in (1, 4, 8):
        pairs = list(ring_pairs(p, True))
        assert len(pairs) == p * (p + 1) // 2
        assert sum(diag for *_, diag in pairs) == p
        assert all(src <= my for _, my, src, _ in pairs)
        assert len(list(ring_pairs(p, False))) == p * p
    q, k, v = map(torch.from_numpy, qkv(2, t=128))
    out = ring_attention(q, k, v, virtual_mesh(8, 1, "cpu"), causal=True)
    assert out.shape == (2, 128, 4, 16) and out.device == q.device
    torch.testing.assert_close(out, full_attention(q, k, v, causal=True),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q[:, :100], k[:, :100], v[:, :100],
                       virtual_mesh(8, 1, "cpu"))


def test_make_attn_fn_ring_and_mesh_rules():
    mesh = virtual_mesh(4, 1, "cpu")
    fn = make_attn_fn("ring", mesh=mesh)
    assert fn.func is ring_attention
    assert fn.keywords == {"mesh": mesh, "seq_axis": "data"}
    assert fn.seq_mesh is mesh and fn.seq_axis == "data"
    for kind in ("full", "flash", "auto"):
        with pytest.raises(ValueError, match="ignores mesh"):
            make_attn_fn(kind, mesh=mesh)


def _lm_pair(seq, seed=0, **kw):
    jm = JaxLM(vocab=64, dim=32, depth=1, num_heads=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, seq), jnp.int32))["params"]
    tm = TransformerLM(vocab=64, dim=32, depth=1, num_heads=4, **kw)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm


def test_ring_lm_matches_jax_one_device_forward():
    """The port's LM attending by ring over 8 groups against the JAX
    model's one-device forward (full attention), causal, f32."""
    mesh = virtual_mesh(8, 1, "cpu")
    jm, params, tm = _lm_pair(64, attn_fn=make_attn_fn("ring", mesh=mesh))
    toks = np.random.default_rng(3).integers(0, 64, (2, 64))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_sequence_parallel_step_matches_jax(eight_devices):
    """JAX ``test_lm_sequence_parallel_training``'s case (vocab 64, dim 32,
    depth 1, 4 heads, ring over 8 groups, Adam 1e-2, tokens [2, 64] cut
    on the sequence) from carried weights: three steps' losses within
    rtol 1e-5 and the parameters within 1e-4 of each tensor's largest;
    the loss falls."""
    jmesh = jax_make_mesh(8, 1, devices=eight_devices)
    seq = 64
    jm = JaxLM(vocab=64, dim=32, depth=1, num_heads=4,
               attn_fn=functools.partial(jax_ring, mesh=jmesh))
    params = _lm_pair(seq)[1]
    tx = optax.adam(1e-2)
    jstate = jax_train.shard_train_state(
        jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats={}, opt_state=tx.init(params)),
        jmesh)
    jstep = jax_train_lm.jit_lm_train_step(jm, tx, jmesh,
                                           sequence_parallel=True)
    mesh = virtual_mesh(8, 1, "cpu")
    tm = TransformerLM(vocab=64, dim=32, depth=1, num_heads=4,
                       attn_fn=make_attn_fn("ring", mesh=mesh))
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    state = TrainState(0, tm.train(), adam(1e-2)(tm.parameters()))
    step = jit_lm_train_step(tm, state.optimizer, mesh,
                             sequence_parallel=True)
    toks = np.random.default_rng(4).integers(0, 64, (2, seq))
    jtoks = jax.device_put(jnp.asarray(toks), jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec(None, "data")))
    losses = []
    for _ in range(3):
        jstate, jm_ = jstep(jstate, jtoks)
        losses.append(float(step(state, torch.from_numpy(toks))["loss"]))
        np.testing.assert_allclose(losses[-1], float(jm_["loss"]),
                                   rtol=1e-5)
    assert losses[-1] < losses[0] and state.step == 3
    want = lm_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4 * float(want[name].abs().max()),
                                   err_msg=name)


def test_sequence_parallel_refusals():
    """An axis the model does not attend over raises ``SequenceAxisError``
    naming both; ring attention over a mesh across processes, here
    without the process group it needs, raises ``MeshShapeError`` naming
    the missing group; a sequence the ring does not divide raises before
    the step runs."""
    mesh = virtual_mesh(4, 1, "cpu")
    tm = TransformerLM(vocab=64, dim=32, depth=1, num_heads=4,
                       attn_fn=make_attn_fn("ring", mesh=mesh))
    opt = adam(1e-2)(tm.parameters())
    with pytest.raises(SequenceAxisError, match="'model'.*'data'"):
        jit_lm_train_step(tm, opt, mesh, sequence_parallel=True,
                          axis="model")
    step = jit_lm_train_step(tm, opt, mesh, sequence_parallel=True)
    with pytest.raises(ValueError, match="not divisible"):
        step(TrainState(0, tm, opt), torch.zeros((2, 30), dtype=torch.int64))
    cpu = torch.device("cpu")
    spread = Mesh(((cpu,), (cpu,)), virtual=True, owners=((0,), (1,)))
    q, k, v = map(torch.from_numpy, qkv(5, t=16))
    with pytest.raises(MeshShapeError,
                       match="no torch.distributed process group"):
        ring_attention(q, k, v, spread)
