"""Pipeline parallelism of the port against the JAX package's, on the CPU
(virtual (data, stage) meshes): the counterparts of
``tests/test_pipeline.py`` and of the pipelined cases of
``tests/test_train_lm.py``.

- ``pipeline_apply`` against JAX ``pipeline_apply`` and the sequential
  stack (4 stages × 8 microbatches, and the 8-stage case), within 1e-5;
  its gradients against JAX's and the sequential stack's (1e-5); the
  (data, stage) composition equal to the one-row schedule;
- the pipelined LM step (4 stages, 4 microbatches, Adam 1e-2) from the
  JAX package's init carried across: losses against JAX's pipelined step
  and the port's dense step (rtol 1e-5), parameters after the steps
  within 1e-4 of each tensor's largest plus 1e-3 of Adam's largest move
  (Adam moves an element whose gradient is at rounding level by a
  rounding-set amount: the key biases); PP × DP over a (2, 4) mesh with
  ``data_axis``; a GQA model over 2 stages;
- ``merge_lm_params(partition_lm_params(p))`` returns p exactly, and the
  port's partition of the carried weights is JAX's partition carried;
- the routed model refused with JAX's words; a depth the stages do not
  divide; a mesh across processes outside its process group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from idunno_tpu.engine import pipeline_lm as jax_pp
from idunno_tpu.engine import train as jax_train
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.parallel import pipeline as jax_pipe
from idunno_tpu_torch.engine.pipeline_lm import (
    PipelinedLM, create_pipelined_lm_train_state, jit_pipelined_lm_train_step,
    merge_lm_params, partition_lm_params, shard_pipelined_state)
from idunno_tpu_torch.engine.train import adam
from idunno_tpu_torch.engine.train_lm import (create_lm_train_state,
                                              make_lm_train_step)
from idunno_tpu_torch.models.convert import (lm_state_dict_from_flax,
                                             pipelined_lm_params_from_flax)
from idunno_tpu_torch.models.moe import MoETransformerLM
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.parallel.mesh import (STAGE_AXIS, Mesh, MeshShapeError,
                                            virtual_mesh)
from idunno_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                split_microbatches,
                                                stack_stage_params)
from tests.torch_workers import share_cores  # noqa: F401


def stage_params(seed, p, d):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(
                np.float32),
             "b": rng.standard_normal(d).astype(np.float32) * 0.1}
            for _ in range(p)]


def jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def port_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def stage_mesh(n_data, n_stage):
    return virtual_mesh(n_data, n_stage, "cpu", axis=STAGE_AXIS)


def to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("p,d,m,mb", [(4, 16, 8, 4), (8, 8, 16, 2)])
def test_pipeline_matches_jax_and_sequential(eight_devices, p, d, m, mb):
    per = stage_params(p, p, d)
    x = np.random.default_rng(1).standard_normal((m * mb, d)).astype(
        np.float32)
    jmesh = JaxMesh(np.asarray(eight_devices[:p]), (jax_pipe.STAGE_AXIS,))
    want = np.asarray(jax_pipe.pipeline_apply(
        jax_stage, jax_pipe.stack_stage_params(
            [jax.tree.map(jnp.asarray, sp) for sp in per]),
        jax_pipe.split_microbatches(jnp.asarray(x), m), jmesh))
    got = pipeline_apply(port_stage, stack_stage_params(
        [to_torch(sp) for sp in per]),
        split_microbatches(torch.from_numpy(x), m), stage_mesh(1, p))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    seq = torch.from_numpy(x)
    for sp in per:
        seq = port_stage(to_torch(sp), seq)
    np.testing.assert_allclose(got.numpy(), split_microbatches(seq, m)
                               .numpy(), atol=1e-5, rtol=1e-5)


def test_pipeline_grads_match_jax_and_sequential(eight_devices):
    """Gradients of the summed output through the schedule (4 stages, 4
    microbatches of 2) against JAX's and the sequential stack's; the
    (2, 4) (data, stage) composition gives the same output and
    gradients."""
    p, d, m, mb = 4, 8, 4, 2
    per = stage_params(4, p, d)
    x = np.random.default_rng(5).standard_normal((m * mb, d)).astype(
        np.float32)
    jmesh = JaxMesh(np.asarray(eight_devices[:p]), (jax_pipe.STAGE_AXIS,))
    micro_j = jax_pipe.split_microbatches(jnp.asarray(x), m)
    want = jax.jit(jax.grad(lambda sp: jax_pipe.pipeline_apply(
        jax_stage, sp, micro_j, jmesh).sum()))(jax_pipe.stack_stage_params(
            [jax.tree.map(jnp.asarray, sp) for sp in per]))
    micro = split_microbatches(torch.from_numpy(x), m)
    grads = {}
    for name, mesh, axis in (("pipe", stage_mesh(1, p), None),
                             ("pp_x_dp", stage_mesh(2, p), "data")):
        stacked = {k: v.requires_grad_() for k, v in stack_stage_params(
            [to_torch(sp) for sp in per]).items()}
        out = pipeline_apply(port_stage, stacked, micro, mesh,
                             data_axis=axis)
        out.sum().backward()
        grads[name] = (out.detach(), {k: v.grad for k, v in stacked.items()})
    seq_params = [{k: v.requires_grad_() for k, v in to_torch(sp).items()}
                  for sp in per]
    seq = torch.from_numpy(x)
    for sp in seq_params:
        seq = port_stage(sp, seq)
    seq.sum().backward()
    for k in ("w", "b"):
        got = grads["pipe"][1][k].numpy()
        np.testing.assert_allclose(got, np.asarray(want[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, torch.stack(
            [sp[k].grad for sp in seq_params]).numpy(), atol=1e-5,
            rtol=1e-5, err_msg=k)
        torch.testing.assert_close(grads["pp_x_dp"][1][k],
                                   grads["pipe"][1][k], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(grads["pp_x_dp"][0], grads["pipe"][0])


def _states(shape, depth, b, t, num_kv_heads=None, steps=3, axis=None):
    """The JAX pipelined step, the port's pipelined step and the port's
    dense step from the JAX package's init, ``steps`` steps on one seeded
    batch: (losses by name, the JAX step's params in the port's dense
    names, the port's pipelined state, the port's dense model)."""
    n_data, p = shape
    kw = dict(vocab=64, dim=32, depth=depth, num_heads=4,
              num_kv_heads=num_kv_heads)
    jm = JaxLM(**kw)
    tx = optax.adam(1e-2)
    devs = jax.devices()[:n_data * p]
    jmesh = JaxMesh(np.asarray(devs).reshape(n_data, p),
                    ("data", jax_pipe.STAGE_AXIS)) if n_data > 1 else \
        JaxMesh(np.asarray(devs), (jax_pipe.STAGE_AXIS,))
    # JAX create_pipelined_lm_train_state, its init jitted
    params = jax_pp.partition_lm_params(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, t), jnp.int32))["params"],
        depth, p)
    jstate = jax_pp.shard_pipelined_state(jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params)), jmesh)
    jstep = jax_pp.jit_pipelined_lm_train_step(jm, jmesh, tx,
                                               num_microbatches=4,
                                               data_axis=axis)
    dense = jax.tree.map(np.asarray,
                         jax_pp.merge_lm_params(jstate.params, depth))
    mesh = stage_mesh(n_data, p)
    state = create_pipelined_lm_train_state(
        TransformerLM(**kw), torch.Generator().manual_seed(0), adam(1e-2),
        p, device="cpu")
    state.model.load_pp_params(pipelined_lm_params_from_flax(dense, depth,
                                                             p))
    state = shard_pipelined_state(state, mesh)
    step = jit_pipelined_lm_train_step(state.model, state.optimizer, mesh, 4,
                                       data_axis=axis)
    dm = TransformerLM(**kw)
    dm.load_state_dict(lm_state_dict_from_flax(dense))
    dstate = create_lm_train_state(dm, torch.Generator().manual_seed(0),
                                   adam(1e-2), device="cpu")
    dm.load_state_dict(lm_state_dict_from_flax(dense))
    dstep = make_lm_train_step(dm, dstate.optimizer)
    toks = np.random.default_rng(7).integers(0, 64, (b, t))
    losses = {"jax": [], "port": [], "dense": []}
    for _ in range(steps):
        jstate, jmet = jstep(jstate, jnp.asarray(toks))
        losses["jax"].append(float(jmet["loss"]))
        losses["port"].append(float(step(state, torch.from_numpy(toks))
                                    ["loss"]))
        losses["dense"].append(float(dstep(dstate, torch.from_numpy(toks))
                                     ["loss"]))
    want = lm_state_dict_from_flax(jax.tree.map(
        np.asarray, jax_pp.merge_lm_params(jstate.params, depth)))
    return losses, want, state, dm


@pytest.mark.parametrize("shape,depth,kv,steps,axis", [
    ((1, 4), 4, None, 3, None), ((2, 4), 4, None, 2, "data"),
    ((2, 4), 4, None, 1, None), ((1, 2), 2, 2, 1, None)],
    ids=["pp4", "pp4_x_dp2", "pp4_x_dp2_replicated", "gqa"])
def test_pipelined_lm_step_matches_jax_and_dense(shape, depth, kv, steps,
                                                 axis):
    """JAX ``test_lm_pipeline_matches_dense`` (4 stages, batch 8, seq 16,
    4 microbatches, 3 steps), ``composes_with_dp`` ((2, 4), 2 steps), the
    (2, 4) mesh without ``data_axis`` (every data row runs the whole
    batch, JAX's replicated tokens; 1 step) and ``supports_gqa`` (2
    stages, 2 KV heads, 1 step): losses within rtol
    1e-5 of JAX's pipelined step and of the port's dense step; parameters
    within 1e-4 of each tensor's largest plus 1e-3 of Adam's largest move
    (lr a step) of both; every group's replica equal after the update."""
    losses, want, state, dense = _states(shape, depth, 8, 16, kv, steps,
                                         axis)
    # Adam moves an element by up to lr a step whatever its gradient's
    # size: where the gradient is at rounding level (the key biases), the
    # rounding sets the move; 1e-3 of the steps' largest move bounds it
    moved = 1e-3 * 1e-2 * steps
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    np.testing.assert_allclose(losses["port"], losses["dense"], rtol=1e-5)
    got = state.model.dense_state_dict()
    own = dense.state_dict()
    assert set(got) == set(want) == set(own)
    for name, p in got.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4 * scale + moved, err_msg=name)
        np.testing.assert_allclose(p.numpy(), own[name].numpy(), rtol=0,
                                   atol=1e-4 * scale + moved, err_msg=name)
    assert len(state.groups) == shape[0]
    for g in state.groups[1:]:
        for name, p in g.model.dense_state_dict().items():
            torch.testing.assert_close(p, got[name], rtol=0, atol=0)


def test_partition_round_trip_and_jax_layout():
    """``merge_lm_params(partition_lm_params(p))`` returns p exactly; the
    port's partition of carried weights is the JAX package's partition
    of the same weights, carried (JAX ``test_lm_pipeline_partition_
    roundtrip``: vocab 32, dim 16, depth 4, 2 stages)."""
    jm = JaxLM(vocab=32, dim=16, depth=4, num_heads=2)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    sd = lm_state_dict_from_flax(params)
    pp = partition_lm_params(sd, 4, 2)
    assert pp["stages"]["attn.q.weight"].shape == (2, 2, 16, 16)
    back = merge_lm_params(pp, 4)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    carried = pipelined_lm_params_from_flax(
        jax_pp.merge_lm_params(jax_pp.partition_lm_params(params, 4, 2), 4),
        4, 2)
    for part in ("outer", "stages"):
        for k, v in pp[part].items():
            assert torch.equal(carried[part][k], v), k
    model = TransformerLM(vocab=32, dim=16, depth=4, num_heads=2)
    model.load_state_dict(sd)
    pl = PipelinedLM(model, 2)
    for k, v in pl.dense_state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_pipeline_refusals():
    mesh = stage_mesh(1, 2)
    routed = MoETransformerLM(vocab=32, dim=16, depth=2, num_heads=2,
                              n_experts=2)
    with pytest.raises(ValueError, match="supports dense blocks only"):
        create_pipelined_lm_train_state(routed, torch.Generator(),
                                        adam(1e-2), 2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 2 pipeline"):
        PipelinedLM(TransformerLM(vocab=32, dim=16, depth=3, num_heads=2), 2)
    with pytest.raises(ValueError, match="not divisible by 3"):
        split_microbatches(torch.zeros(8, 2), 3)
    with pytest.raises(ValueError, match="not divisible by data axis"):
        pipeline_apply(port_stage, {"w": torch.zeros(2, 4, 4),
                                    "b": torch.zeros(2, 4)},
                       torch.zeros(2, 3, 4), stage_mesh(2, 2),
                       data_axis="data")
    state = create_pipelined_lm_train_state(
        TransformerLM(vocab=32, dim=16, depth=2, num_heads=2),
        torch.Generator(), adam(1e-2), 2, device="cpu")
    step = jit_pipelined_lm_train_step(state.model, state.optimizer, mesh,
                                       4)
    with pytest.raises(ValueError, match="placed on its mesh"):
        step(state, torch.zeros((8, 4), dtype=torch.int64))
    with pytest.raises(MeshShapeError, match="not the data axis"):
        jit_pipelined_lm_train_step(state.model, state.optimizer, mesh, 4,
                                    data_axis=STAGE_AXIS)
    placed = shard_pipelined_state(state, mesh)
    step = jit_pipelined_lm_train_step(placed.model, placed.optimizer, mesh,
                                       4)
    with pytest.raises(ValueError, match="need data_axis"):
        step(placed, [torch.zeros((8, 4), dtype=torch.int64)])
    cpu = torch.device("cpu")
    spread = Mesh(((cpu, cpu), (cpu, cpu)), virtual=True,
                  owners=((0, 1), (0, 1)), axes=("data", STAGE_AXIS))
    with pytest.raises(MeshShapeError,
                       match="no torch.distributed process group"):
        shard_pipelined_state(state, spread)
