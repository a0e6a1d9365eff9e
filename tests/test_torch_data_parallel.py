"""Data parallelism of the port against the JAX package's, on the CPU.

The port's mesh steps and engine run on virtual meshes of the CPU
(``parallel/mesh.py:virtual_mesh``); the JAX package's on ``conftest.py``'s
forced host devices. Weights are the JAX package's own init carried across
by ``models/convert.py``; inputs come from numpy seeds; everything is f32.

- ResNet-18: the port's data-parallel step on ``virtual_mesh(4, 1)``
  (BatchNorm over the global batch) against ``jit_train_step`` on
  ``make_mesh(4, 1)``: losses, parameters, running statistics;
- the tensor-parallel split of AlexNet's FC kernels against JAX's
  ``tp_param_spec`` (its DP, FSDP and TP steps are held to the one-group
  step in ``tests/test_torch_fsdp.py``);
- the engine on ``(4, 1)`` and ``(2, 2)`` meshes against the one-group
  engine and the JAX engine on the same mesh shape, with a batch that
  needs padding;
- the data-axis pieces: ``shard_batch``, ``from_process_local``,
  ``reduce_gradients``, the engine's device and mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idunno_tpu.config import EngineConfig as JaxEngineConfig
from idunno_tpu.engine import train as jax_train
from idunno_tpu.engine.inference import InferenceEngine as JaxEngine
from idunno_tpu.models import create_model as jax_create_model
from idunno_tpu.parallel.mesh import make_mesh as jax_make_mesh
from idunno_tpu.parallel.sharding import shard_batch as jax_shard_batch
from idunno_tpu.parallel.sharding import tp_param_spec as jax_tp_param_spec
from idunno_tpu_torch.config import EngineConfig
from idunno_tpu_torch.engine import data as data_lib
from idunno_tpu_torch.engine.inference import InferenceEngine
from idunno_tpu_torch.engine.train import (
    TrainState, gathered_params, jit_train_step, make_train_step, sgd,
    shard_train_state)
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.convert import state_dict_from_flax
from idunno_tpu_torch.parallel.data import (from_process_local,
                                            reduce_gradients, shard_batch)
from idunno_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                            make_mesh, virtual_mesh)
from idunno_tpu_torch.parallel.sharding import ColumnSplit, tp_param_spec
from tests.test_torch_train import jax_cnn_state
from tests.torch_workers import share_cores  # noqa: F401

SMALL = dict(batch_size=6, image_size=64, resize_size=64)
# f32 on both sides, as tests/test_torch_engine.py
PROB_ATOL = 1e-6


def assert_close(got, want, tol):
    """|got - want| within ``tol`` of the reference's largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def cpu_mesh(nd, nm=1):
    return virtual_mesh(nd, nm, "cpu")


# -- ResNet-18: global BatchNorm against JAX ----------------------------------

def test_resnet18_dp_step_matches_jax(eight_devices):
    """Two SGD-momentum steps over four data groups, batch 8 at 32²: two
    rows a group, so per-group BatchNorm statistics would be far off
    (the last stage is 1x1: n = 2 a group against 8 global). Losses to
    rtol 1e-5; parameters (gathered from group 0) within 1e-4 of each
    tensor's largest; every BatchNorm's running mean within 1e-5 and
    running variance within 1e-4, on every group's replica."""
    jmodel = jax_create_model("resnet18", dtype=jnp.float32)
    tx = optax.sgd(0.1, momentum=0.9)
    jstate = jax_cnn_state(jmodel, jax.random.PRNGKey(3), 32, tx)
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    jmesh = jax_make_mesh(4, 1, devices=eight_devices[:4])
    jstate = jax_train.shard_train_state(jstate, jmesh)
    jstep = jax_train.jit_train_step(jmodel, tx, jmesh)
    model = create_model("resnet18")
    model.load_state_dict(state_dict_from_flax("resnet18", variables))
    mesh = cpu_mesh(4)
    state = shard_train_state(
        TrainState(0, model.train(), sgd(0.1, momentum=0.9)(
            model.parameters())), mesh)
    step = jit_train_step(state.model, state.optimizer, mesh)
    rng = np.random.default_rng(11)
    images = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, 8)
    nchw = torch.from_numpy(images).permute(0, 3, 1, 2)
    for _ in range(2):
        jstate, jmetrics = jstep(jstate,
                                 jax_shard_batch(jmesh, jnp.asarray(images)),
                                 jax_shard_batch(jmesh, jnp.asarray(labels)))
        metrics = step(state, nchw, torch.from_numpy(labels))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
    assert state.step == 2
    want = state_dict_from_flax("resnet18", jax.tree.map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    got = gathered_params(state)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, p in got.items():
        assert_close(p, want[name].numpy(), 1e-4)
    for g in state.groups:
        stats = g.model.state_dict()
        for name in want:
            if name.endswith("running_mean"):
                assert_close(stats[name], want[name].numpy(), 1e-5)
            elif name.endswith("running_var"):
                assert_close(stats[name], want[name].numpy(), 1e-4)


def test_resnet_one_group_mesh_step_is_todays_step():
    """A mesh of one group takes torch's BatchNorm (no reduction), so its
    step equals ``make_train_step``'s to the bit."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, 4))
    out = []
    for mesh in (None, cpu_mesh(1)):
        model = create_model("resnet18")
        model.init_weights(torch.Generator().manual_seed(1))
        state = TrainState(0, model.train(), sgd(0.1)(model.parameters()))
        if mesh is None:
            step = make_train_step(model, state.optimizer)
        else:
            state = shard_train_state(state, mesh)
            step = jit_train_step(state.model, state.optimizer, mesh)
        out.append((float(step(state, x, y)["loss"]),
                    state.model.state_dict()))
    assert out[0][0] == out[1][0]
    for name, t in out[0][1].items():
        assert torch.equal(t, out[1][1][name]), name


def test_tp_param_spec_matches_jax():
    """The port's FC names (``classifier.<i>``, ``fc``) take JAX's rule on
    flax's (``fc0``-``fc2``, ``fc``): AlexNet's three FC kernels cut, its
    convs, biases and ResNet-18's 512 x 1000 ``fc`` (2^19 elements) not."""
    jnames = {"classifier.1": "fc0", "classifier.4": "fc1",
              "classifier.6": "fc2", "fc": "fc", "features.3": "conv1"}
    shapes = {"classifier.1": (4096, 9216), "classifier.4": (4096, 4096),
              "classifier.6": (1000, 4096), "fc": (1000, 512),
              "features.3": (192, 64, 5, 5)}
    for name, shape in shapes.items():
        jleaf = jnp.zeros(shape[::-1] if len(shape) == 2 else
                          (shape[2], shape[3], shape[1], shape[0]))
        jspec = jax_tp_param_spec((jnames[name], "kernel"), jleaf)
        got = tp_param_spec(f"{name}.weight", shape)
        assert (got == 0) == (jspec != jax.sharding.PartitionSpec()), name
        assert tp_param_spec(f"{name}.bias", shape[:1]) is None


# -- the engine over a mesh -----------------------------------------------------

@pytest.fixture(scope="module")
def one_group():
    eng = InferenceEngine(EngineConfig(compute_dtype="float32",
                                       preprocess="plain", **SMALL),
                          device="cpu")
    return eng


@pytest.mark.parametrize("shape,name", [((4, 1), "resnet"),
                                        ((2, 2), "resnet"),
                                        ((2, 2), "alexnet")])
def test_engine_over_mesh_matches_jax_and_one_group(eight_devices,
                                                    one_group, shape,
                                                    name):
    """21 images at batch 6 (rounded up to 8 over four data groups: the
    last batch padded): the port's engine on a virtual mesh gives the
    records of the JAX engine on the same mesh shape and of the one-group
    engine (names and categories equal, probabilities within 1e-6);
    ``(2, 2)`` cuts the wide layers over the model axis."""
    nd, nm = shape
    jeng = JaxEngine(JaxEngineConfig(compute_dtype="float32",
                                     preprocess="xla", **SMALL),
                     mesh=jax_make_mesh(nd, nm,
                                        devices=eight_devices[:nd * nm]),
                     seed=0, pretrained=False)
    jeng.load(name)
    sd = state_dict_from_flax(name, jax.tree.map(
        np.asarray, jeng._models[name].variables))
    eng = InferenceEngine(EngineConfig(compute_dtype="float32",
                                       preprocess="plain", **SMALL),
                          mesh=cpu_mesh(nd, nm))
    eng.load(name, state_dict=sd)
    one_group.load(name, state_dict=sd)
    assert eng._device_batch() == jeng._device_batch() == (8 if nd == 4
                                                            else 6)
    if nm > 1:
        assert any(isinstance(m, ColumnSplit)
                   for m in eng._replicas[name][1].modules())
    ref, one, out = (e.infer(name, 0, 20) for e in (jeng, one_group, eng))
    for other in (ref, one):
        assert [r[0] for r in out.records] == [r[0] for r in other.records]
        assert [r[1] for r in out.records] == [r[1] for r in other.records]
        np.testing.assert_allclose([r[2] for r in out.records],
                                   [r[2] for r in other.records],
                                   rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("quantize,name", [("int8", "resnet"),
                                           ("none", "vit_tiny")])
def test_int8_and_vit_engines_over_a_2x2_mesh(quantize, name):
    """Int8 weights (each part of a cut layer quantized on its own: the
    scales are per output feature, so the parts hold the whole layer's
    values) and ViT's cut q/k/v, MLP and patch embedding over a (2, 2)
    mesh: the one-group engine's records (probabilities within 1e-6)."""
    cfg = EngineConfig(compute_dtype="float32", preprocess="plain",
                       quantize=quantize, **SMALL)
    one = InferenceEngine(cfg, device="cpu")
    eng = InferenceEngine(cfg, mesh=cpu_mesh(2, 2))
    want, got = one.infer(name, 0, 13), eng.infer(name, 0, 13)
    assert [r[1] for r in got.records] == [r[1] for r in want.records]
    np.testing.assert_allclose([r[2] for r in got.records],
                               [r[2] for r in want.records],
                               rtol=0, atol=PROB_ATOL)


def test_engine_batch_and_staged_paths_over_mesh(one_group):
    """``infer_batch`` and ``stage``/``infer_staged`` over two data groups
    (the staged blocks ``[K, B / 2]`` per group) give the one-group
    engine's answers; a mesh of one group stages one block, ``[K, B]``."""
    eng = InferenceEngine(EngineConfig(compute_dtype="float32",
                                       preprocess="plain", **SMALL),
                          mesh=cpu_mesh(2))
    one_group.load("resnet")
    eng.load("resnet", state_dict=one_group._models["resnet"].state_dict())
    _, images = data_lib.load_range(None, 0, 12, size=64)
    idx, prob = one_group.infer_batch("resnet", images)
    staged, n = eng.stage(images)
    assert n == 13 and [tuple(s.shape) for s in staged] == \
        [(3, 3, 64, 64, 3)] * 2
    for got in (eng.infer_batch("resnet", images),
                eng.infer_staged("resnet", staged, n)):
        np.testing.assert_array_equal(got[0], idx)
        np.testing.assert_allclose(got[1], prob, rtol=0, atol=PROB_ATOL)
    assert [tuple(s.shape) for s in one_group.stage(images)[0]] == \
        [(3, 6, 64, 64, 3)]
    assert eng.warmup("resnet") >= 0.0
    with pytest.raises(ValueError, match="model axis"):
        InferenceEngine(EngineConfig(**SMALL), mesh=cpu_mesh(1, 2),
                        store=object()).publish_weights("resnet")


# -- the data-axis pieces ------------------------------------------------------

def test_shard_batch_and_process_local_rows():
    """A global batch cut into contiguous rows per data group (on each
    group's device); this process's rows cut over its local groups; a
    batch with fewer rows than groups raises."""
    mesh = cpu_mesh(4)
    x = torch.arange(8.0)
    parts = shard_batch(mesh, x)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    parts = shard_batch(mesh, np.arange(10))
    assert [len(p) for p in parts] == [3, 3, 2, 2]
    assert [p.tolist() for p in from_process_local(cpu_mesh(2), x[:4])] == \
        [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="cannot be cut"):
        shard_batch(mesh, x[:3])
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 1}
    assert mesh.local_groups == (0, 1, 2, 3)


def test_reduce_gradients_sums_every_copy():
    """Each parameter's gradients summed over the groups' copies (a
    missing one counts as zero), every copy getting the sum."""
    copies = [[torch.nn.Parameter(torch.zeros(3)),
               torch.nn.Parameter(torch.zeros(2))] for _ in range(3)]
    for i, (a, b) in enumerate(copies):
        a.grad = torch.full((3,), float(i + 1))
        if i != 1:
            b.grad = torch.full((2,), 10.0 * i)
    reduce_gradients(copies)
    for a, b in copies:
        assert a.grad.tolist() == [6.0] * 3
        assert b.grad.tolist() == [20.0] * 2


def test_engine_device_and_mesh():
    """An engine on ``device="cpu"`` (a ``--cpu`` node's) is one group on
    the CPU; an engine over a mesh runs its data groups, and a device
    that is not the mesh's lead raises."""
    eng = InferenceEngine(EngineConfig(**SMALL), device="cpu")
    assert eng.mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    assert eng.device == torch.device("cpu")
    mesh = make_mesh(2, 1, devices=["cpu", "cpu"], virtual=True)
    assert InferenceEngine(EngineConfig(**SMALL), mesh=mesh).n_data == 2
    with pytest.raises(ValueError, match="lead device"):
        InferenceEngine(EngineConfig(**SMALL), device="meta", mesh=mesh)


def test_group_sync_under_many_threads():
    """Eight groups (more than this test's cores need) meet 200 times at
    the barrier with a tiny switch interval: every group gets every sum
    whole. A group that fails releases the others, and the failure is
    what ``run_groups`` raises."""
    import sys
    import threading

    from idunno_tpu_torch.parallel.data import GroupSync, run_groups

    mesh = cpu_mesh(8)
    sync = GroupSync(mesh)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            return [float(sync.sum(i, torch.tensor([float(i + k)])))
                    for k in range(200)]

        out = run_groups([lambda i=i: work(i) for i in range(8)], sync)
    finally:
        sys.setswitchinterval(old)
    for sums in out:
        assert sums == [28.0 + 8 * k for k in range(200)]

    sync = GroupSync(mesh)

    def fail():
        raise RuntimeError("group 3 failed")

    calls = [lambda i=i: sync.sum(i, torch.ones(1)) for i in range(8)]
    calls[3] = fail
    done = []
    t = threading.Thread(target=lambda: done.append(
        pytest.raises(RuntimeError, run_groups, calls, sync)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "group 3" in str(done[0].value)
