"""FSDP and the data-parallel LM step of the port against the JAX package's,
on the CPU: the counterparts of ``tests/test_fsdp.py`` and of
``jit_lm_train_step``.

- ``fsdp_param_spec`` chooses JAX's dim on JAX's shapes (and the flax
  layouts of a few of the port's);
- the port's FSDP step equals its data-parallel step over three steps,
  its cut leaves stay cut, and a group keeps about 1/n of the bytes
  (ResNet-18 over four groups; JAX's test runs AlexNet over eight);
- the port's ``jit_lm_train_step`` on a virtual mesh of two groups
  against the JAX package's on ``make_mesh(2, 1)`` (dim 32, depth 2,
  three steps); ``sequence_parallel=True`` over a model that does not
  attend by ring or Ulysses raises the typed ``SequenceAxisError``;
- groups of unequal rows weight their losses by their shares;
- the train bench over a virtual (2, 1) mesh records its ``fsdp`` point;
- AlexNet: the port's DP, FSDP and tensor-parallel steps against its own
  one-group step (dropout masks cannot match flax's; the port's draw the
  global batch's masks whatever the mesh).

Weights are the JAX package's init carried across by
``models/convert.py``, inputs numpy seeds, everything f32.
"""
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
from idunno_tpu.parallel.sharding import shard_batch as jax_shard_batch
from idunno_tpu_torch.engine.train import (
    TrainState, fsdp_param_spec, fsdp_shard_train_state,
    gathered_params, jit_train_step, resident_bytes, sgd, shard_train_state)
from idunno_tpu_torch.engine.train_lm import (SequenceAxisError,
                                              jit_lm_train_step)
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM, make_attn_fn
from idunno_tpu_torch.parallel.mesh import virtual_mesh
from idunno_tpu_torch.parallel.sharding import ColumnSplit
from idunno_tpu_torch.utils.train_bench import run_train_bench
from tests.torch_workers import share_cores  # noqa: F401


def jax_dim(spec) -> int | None:
    return next((i for i, ax in enumerate(spec) if ax == "data"), None)


@pytest.mark.parametrize("shape,n", [
    ((3, 16, 5), 8), ((3, 5), 8), ((), 8), ((64, 24), 8),
    ((7,), 8), ((16, 16), 4), ((9216, 4096), 2), ((1000,), 2),
    ((3, 3, 64, 128), 4)])
def test_fsdp_param_spec_matches_jax(shape, n):
    """The same dim as ``idunno_tpu/engine/train.py:fsdp_param_spec``: the
    largest dividing dim (the first on a tie); replicated when the leaf is
    a scalar, smaller than ``n`` or indivisible."""
    want = jax_dim(jax_train.fsdp_param_spec(jnp.zeros(shape), n))
    assert fsdp_param_spec(shape, n) == want


def test_fsdp_step_matches_replicated_dp():
    """ResNet-18 over four data groups, three SGD-momentum steps: the FSDP
    losses and parameters equal the data-parallel ones (f32; 1e-5 of the
    losses, 1e-5 of each tensor's largest parameter), the cut leaves stay
    cut after the steps, and a group holds at most a third of the
    replica's parameter and moment bytes (JAX: a quarter of the largest
    leaf)."""
    mesh = virtual_mesh(4, 1, "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 3, 32, 32))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, 8))
    out = {}
    for kind in ("dp", "fsdp"):
        model = create_model("resnet18")
        model.init_weights(torch.Generator().manual_seed(2))
        state = TrainState(0, model.train(),
                           sgd(1e-2, momentum=0.9)(model.parameters()))
        state = (fsdp_shard_train_state(state, mesh) if kind == "fsdp"
                 else shard_train_state(state, mesh))
        step = jit_train_step(state.model, state.optimizer, mesh)
        losses = [float(step(state, x, y)["loss"]) for _ in range(3)]
        out[kind] = (losses, gathered_params(state), state)
    np.testing.assert_allclose(out["fsdp"][0], out["dp"][0], rtol=1e-5)
    for name, p in out["dp"][1].items():
        np.testing.assert_allclose(
            out["fsdp"][1][name].numpy(), p.numpy(), rtol=0,
            atol=1e-5 * float(p.abs().max()))
    fstate, dstate = out["fsdp"][2], out["dp"][2]
    big = max(fstate.fsdp, key=lambda n: out["dp"][1][n].numel())
    assert fstate.fsdp[big] is not None
    for g in fstate.groups:
        assert g.params[big].numel() == out["dp"][1][big].numel() // 4
    assert resident_bytes(fstate) <= resident_bytes(dstate) / 3


def _lm_pair(seed=1):
    jm = JaxLM(vocab=64, dim=32, depth=2, num_heads=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=64, dim=32, depth=2, num_heads=4,
                       attn_fn=make_attn_fn("flash"))
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm


def test_lm_mesh_step_matches_jax(eight_devices):
    """Three SGD-momentum steps on tokens [4, 32] over two data groups:
    the port's step (flash attention: its plain versions on the CPU)
    against JAX ``jit_lm_train_step`` on ``make_mesh(2, 1)``: losses to
    rtol 1e-5 and parameters within 1e-5 of each tensor's largest (f32,
    the sums in another order)."""
    jm, params, tm = _lm_pair()
    tx = optax.sgd(0.5, momentum=0.9)
    jmesh = jax_make_mesh(2, 1, devices=eight_devices[:2])
    jstate = jax_train.shard_train_state(
        jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats={}, opt_state=tx.init(params)),
        jmesh)
    jstep = jax_train_lm.jit_lm_train_step(jm, tx, jmesh)
    mesh = virtual_mesh(2, 1, "cpu")
    state = shard_train_state(
        TrainState(0, tm.train(), sgd(0.5, momentum=0.9)(
            tm.parameters())), mesh)
    step = jit_lm_train_step(state.model, state.optimizer, mesh)
    toks = np.random.default_rng(7).integers(0, 64, (4, 32))
    for _ in range(3):
        jstate, jmetrics = jstep(jstate,
                                 jax_shard_batch(jmesh, jnp.asarray(toks)))
        metrics = step(state, torch.from_numpy(toks))
        assert set(metrics) == {"loss", "ce", "aux", "accuracy"}
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
    want = lm_state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, p in gathered_params(state).items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5 * float(want[name].abs().max()))
    with pytest.raises(SequenceAxisError, match="attends over None"):
        jit_lm_train_step(state.model, state.optimizer, mesh,
                          sequence_parallel=True)
    with pytest.raises(ValueError, match="another model"):
        jit_lm_train_step(_lm_pair()[2], state.optimizer, mesh)(
            state, torch.from_numpy(toks))


def test_uneven_groups_weight_the_loss_by_their_share():
    """Ten rows over four groups (3, 3, 2, 2): the loss is the global
    batch's mean and BatchNorm's count the global one, so the step equals
    the one-group step (an unweighted mean of the groups' means would
    not)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((10, 3, 32, 32))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, 10))
    out = []
    for n in (1, 4):
        mesh = virtual_mesh(n, 1, "cpu")
        model = create_model("resnet18")
        model.init_weights(torch.Generator().manual_seed(5))
        state = shard_train_state(
            TrainState(0, model.train(), sgd(0.1)(model.parameters())), mesh)
        step = jit_train_step(state.model, state.optimizer, mesh)
        out.append((float(step(state, x, y)["loss"]),
                    float(state.model.bn1.running_var.sum())))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5)


def test_train_bench_fsdp_point_over_a_virtual_mesh():
    """The CPU miniature's record over a virtual (2, 1) mesh: no point in
    error, and the ``fsdp`` point's group holds about half the bytes of a
    replica."""
    rec = run_train_bench(device="cpu", mesh=virtual_mesh(2, 1, "cpu"))
    assert rec["mesh"] == {"data": 2, "model": 1, "virtual": True}
    assert rec["n_devices"] == 1 and rec["config"]["batch"] == 8
    assert not any("error" in v for v in rec.values() if isinstance(v, dict))
    f = rec["fsdp"]
    assert f["tokens_per_s"] > 0 and f["vs_plain"] > 0
    assert f["optimizer_layout"].startswith("per-tensor")
    ratio = f["resident_bytes_per_group"] / f["replicated_resident_bytes"]
    assert 0.45 <= ratio <= 0.55, ratio
    assert rec["accum"]["tokens_per_s"] > 0
    assert rec["cnn"]["images_per_s"] > 0 and rec["cnn"]["batch"] == 8


# -- AlexNet: DP, FSDP and TP against the port's one-group step -------------

def _alexnet_state(kind: str, mesh):
    model = create_model("alexnet")
    model.init_weights(torch.Generator().manual_seed(2))
    state = TrainState(0, model.train(),
                       sgd(1e-2, momentum=0.9)(model.parameters()))
    if kind == "fsdp":
        return fsdp_shard_train_state(state, mesh)
    return shard_train_state(state, mesh, tensor_parallel=kind == "tp")


@pytest.fixture(scope="module")
def alexnet_batch():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((8, 3, 64, 64))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 1000, 8)))


@pytest.fixture(scope="module")
def alexnet_one_group(alexnet_batch):
    mesh = virtual_mesh(1, 1, "cpu")
    state = _alexnet_state("dp", mesh)
    step = jit_train_step(state.model, state.optimizer, mesh)
    losses = [float(step(state, *alexnet_batch)["loss"]) for _ in range(2)]
    return losses, gathered_params(state)


@pytest.mark.parametrize("kind,shape", [("dp", (2, 1)), ("fsdp", (2, 1)),
                                        ("tp", (2, 2))])
def test_alexnet_mesh_steps_equal_one_group(alexnet_batch,
                                            alexnet_one_group, kind, shape):
    """Two steps with dropout on: the same masks (the global batch's, from
    the step's generator), the same losses to rtol 1e-5 and the same
    parameters within 1e-5 of each tensor's largest (the gradients sum in
    another order). FSDP keeps its kernels cut after the steps; TP cuts
    the three FC kernels (JAX's ``tp_param_spec`` cuts the same three)."""
    mesh = virtual_mesh(*shape, "cpu")
    state = _alexnet_state(kind, mesh)
    step = jit_train_step(state.model, state.optimizer, mesh)
    losses = [float(step(state, *alexnet_batch)["loss"]) for _ in range(2)]
    want_losses, want = alexnet_one_group
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = gathered_params(state)
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5 * float(want[name].abs().max()))
    if kind == "fsdp":
        # [4096, 9216]: the in-features, flax's [9216, 4096] dim 0
        assert state.fsdp["classifier.1.weight"] == 1
        shard = state.groups[0].params["classifier.1.weight"]
        assert shard.shape == (4096, 4608)
        assert state.model.classifier[1].weight.numel() == 0
    if kind == "tp":
        split = [n for n, m in state.model.named_modules()
                 if isinstance(m, ColumnSplit)]
        assert split == ["classifier.1", "classifier.4", "classifier.6"]
