"""The port's CNNs with a compute dtype beside the parameters' dtype, against
the JAX package on the CPU.

The JAX ``ResNet`` and ``AlexNet`` compute in bf16 over f32 parameters by
default (``dtype=bfloat16, param_dtype=float32``), and the JAX train
bench trains ResNet-18 that way. The port's ``compute_dtype=
torch.bfloat16`` must follow it: f32 master weights cast to bf16 for each
conv and the FC, BatchNorm statistics and running averages in f32. One
SGD-momentum step from the same weights on the same images, and the
forward of both families, against the JAX modules' defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idunno_tpu.engine import train as jax_train
from idunno_tpu.models import create_model as jax_create_model
from idunno_tpu_torch.engine.train import (TrainState, flat_tx,
                                           make_train_step, sgd)
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.convert import state_dict_from_flax
from tests.test_torch_train import jax_cnn_state
from tests.torch_workers import share_cores  # noqa: F401


def _flax_vars(state) -> dict:
    return jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})


def test_resnet18_bf16_step_matches_jax_default():
    """One step of ResNet-18, bf16 compute over f32 parameters, against the
    JAX package's default ``resnet18()`` (the same split) from the same
    weights on the same images (batch 8, 64²).

    Every conv and the FC must compute in bf16 (forward hooks read their
    outputs' dtype), every BatchNorm must keep f32 running statistics, and
    the parameters stay f32. bf16 rounds the activations at other points
    in the two packages (XLA fuses, torch does not), and at this size the
    JAX step's own bf16 update is 18% (largest element) and 9% (L2) away
    from its f32 update. So: the loss within rtol 2e-2; the update
    (parameters after minus before, every tensor together) within 0.25 of
    the JAX update's largest element at its largest difference (seen:
    0.128) and within 0.2 of its L2 norm (seen: 0.094); each running mean
    and variance within 5e-2 of its largest value."""
    jmodel = jax_create_model("resnet18")
    assert jmodel.dtype == jnp.bfloat16 and jmodel.param_dtype == jnp.float32
    tx = optax.sgd(0.1, momentum=0.9)
    jstate = jax_cnn_state(jmodel, jax.random.PRNGKey(3), 32, tx)
    before = state_dict_from_flax("resnet18", _flax_vars(jstate))
    model = create_model("resnet18", compute_dtype=torch.bfloat16)
    model.load_state_dict(before)
    assert model.compute_dtype == torch.bfloat16
    rng = np.random.default_rng(12)
    images = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, 8)
    jstate2, jmetrics = jax.jit(jax_train.make_train_step(jmodel, tx))(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    state = TrainState(step=0, model=model.train(),
                       optimizer=flat_tx(sgd(0.1, momentum=0.9))(
                           model.parameters()))
    out_dtypes = {}

    def record(name):
        def hook(mod, args, out):
            out_dtypes[name] = out.dtype
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    metrics = make_train_step(model, state.optimizer)(
        state, torch.from_numpy(images).permute(0, 3, 1, 2),
        torch.from_numpy(labels))
    for h in hooks:
        h.remove()
    assert len(out_dtypes) == 21
    assert set(out_dtypes.values()) == {torch.bfloat16}
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=2e-2)
    after = state_dict_from_flax("resnet18", _flax_vars(jstate2))
    got = model.state_dict()
    err = scale = sq_err = sq = 0.0
    n_stats = 0
    for name, want in after.items():
        if name.endswith("num_batches_tracked"):
            continue
        assert got[name].dtype == torch.float32, name
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            top = float(want.abs().max())
            assert float((got[name] - want).abs().max()) <= 5e-2 * top, name
            continue
        dw_want = want - before[name]
        diff = got[name] - before[name] - dw_want
        err = max(err, float(diff.abs().max()))
        scale = max(scale, float(dw_want.abs().max()))
        sq_err += float((diff ** 2).sum())
        sq += float((dw_want ** 2).sum())
    assert n_stats == 40
    assert err <= 0.25 * scale, (err, scale)
    assert sq_err ** 0.5 <= 0.2 * sq ** 0.5, (sq_err, sq)


@pytest.mark.parametrize("name", ["resnet18", "alexnet"])
def test_bf16_compute_forward_matches_jax_default(name):
    """Eval logits of the JAX module's default (bf16 compute, f32 params)
    against the port's ``compute_dtype=torch.bfloat16`` on the same
    weights: within 3e-2 of the largest logit (bf16 rounding through the
    whole network), logits f32, parameters still f32."""
    size = 64 if name == "resnet18" else 224
    jmodel = jax_create_model(name)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, size, size, 3), jnp.float32)))(
        jax.random.PRNGKey(4))
    model = create_model(name, compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_flax(
        name, jax.tree.map(np.asarray, dict(variables))))
    images = np.random.default_rng(13).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 3e-2 * scale


def test_compute_dtype_defaults_to_the_parameters():
    """Without a compute dtype the CNNs compute in their parameters' dtype,
    as the serving engine's bf16 models always have."""
    for name in ("resnet18", "alexnet"):
        model = create_model(name).to(torch.bfloat16)
        assert model.compute_dtype == torch.bfloat16
        assert create_model(name).compute_dtype == torch.float32
