"""The routed FFN (switch MoE) and ``remat`` of the port against the JAX
package, on the CPU.

The JAX module's dense path (``mesh=None``, every expert local) is the
reference: the same numpy-seeded inputs and the JAX package's own initial
weights, carried into the port by ``models/convert.py``, go through
``idunno_tpu/parallel/expert.py:switch_dispatch``,
``idunno_tpu/models/moe.py`` (``SwitchFFN``, ``MoETransformerLM``), the
JAX LM train step, and through their
counterparts in ``idunno_tpu_torch``. The serving half (the routed
``DecodeServer``, the training job) is ``tests/test_torch_moe_serve.py``.
Small sizes, f32: dim 16-32, depth 2-4, 4 experts, vocab 64.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from idunno_tpu.engine import train as jax_train
from idunno_tpu.engine import train_lm as jax_train_lm
from idunno_tpu.models.moe import MoETransformerLM as JaxMoELM
from idunno_tpu.models.moe import SwitchFFN as JaxSwitchFFN
from idunno_tpu.models.moe import moe_aux_loss as jax_moe_aux_loss
from idunno_tpu.models.moe import switch_ffn_factory as jax_switch_factory
from idunno_tpu.parallel.expert import switch_dispatch as jax_switch_dispatch
from idunno_tpu_torch.engine.checkpoint import decode_state, encode_state
from idunno_tpu_torch.engine.generate import lm_store_name, load_lm, save_lm
from idunno_tpu_torch.engine.train import TrainState, sgd
from idunno_tpu_torch.engine.train_lm import (make_lm_train_step,
                                              next_token_loss)
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.moe import (MoETransformerLM, SwitchFFN,
                                         moe_aux_loss, switch_ffn_factory,
                                         top_k)
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.parallel.expert import (expert_parallel_apply,
                                              switch_dispatch)
from tests.torch_workers import share_cores  # noqa: F401

VOCAB = 64
LM = dict(vocab=VOCAB, dim=32, num_heads=4, n_experts=4)


def assert_close(got, want, tol):
    """|got - want| within ``tol`` of the reference's largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class MemStore:
    """The store surface ``save_lm``/``load_lm`` use."""

    def __init__(self):
        self.blobs: dict[str, list[bytes]] = {}

    def put_bytes(self, name, blob):
        self.blobs.setdefault(name, []).append(bytes(blob))
        return len(self.blobs[name])

    def get_bytes(self, name, version=None):
        vs = self.blobs[name]
        v = len(vs) if version is None else version
        return vs[v - 1], v


# -- switch_dispatch ----------------------------------------------------------

def test_switch_dispatch_positions_and_drops():
    """``tests/test_moe.py``'s case: expert 0 takes tokens 0 and 2 (slots
    0, 1) and drops token 3; bit-equal to the JAX tensors."""
    gate_idx = np.asarray([0, 1, 0, 0, 1])
    gate_w = np.asarray([1.0, 0.5, 0.25, 0.125, 0.0625], np.float32)
    dispatch, combine = switch_dispatch(torch.from_numpy(gate_idx),
                                        torch.from_numpy(gate_w),
                                        n_experts=2, capacity=2)
    assert dispatch[0, 0, 0] == 1 and dispatch[2, 0, 1] == 1
    assert float(dispatch[3].sum()) == 0.0
    assert dispatch[1, 1, 0] == 1 and dispatch[4, 1, 1] == 1
    assert float(combine[2, 0, 1]) == 0.25
    jd, jc = jax_switch_dispatch(jnp.asarray(gate_idx), jnp.asarray(gate_w),
                                 2, 2)
    assert dispatch.dtype == combine.dtype == torch.float32
    assert np.array_equal(dispatch.numpy(), np.asarray(jd))
    assert np.array_equal(combine.numpy(), np.asarray(jc))


@pytest.mark.parametrize("capacity", [1, 3, 40])
def test_switch_dispatch_bit_equal_to_jax(capacity):
    rng = np.random.default_rng(capacity)
    gate_idx = rng.integers(0, 5, 40)
    gate_w = rng.random(40).astype(np.float32)
    dispatch, combine = switch_dispatch(torch.from_numpy(gate_idx),
                                        torch.from_numpy(gate_w), 5, capacity)
    jd, jc = jax_switch_dispatch(jnp.asarray(gate_idx), jnp.asarray(gate_w),
                                 5, capacity)
    assert np.array_equal(dispatch.numpy(), np.asarray(jd))
    assert np.array_equal(combine.numpy(), np.asarray(jc))
    assert (float(dispatch.sum()) < 40) == (capacity < 40)


def test_top_k_takes_the_lower_index_on_ties():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                        [0.3, 0.1, 0.3, 0.3]], np.float32)
    for k in (1, 2, 3):
        w, idx = top_k(torch.from_numpy(probs), k)
        jw, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert np.array_equal(w.numpy(), np.asarray(jw))


def test_expert_parallelism_raises_naming_roadmap():
    """Expert parallelism's typed refusals, the JAX path's: experts that
    do not divide the axis (at construction and in
    ``expert_parallel_apply``) and routing units that do not; and a mesh
    across processes outside the process group it was made in, which
    ``Mesh.along`` refuses naming the missing group."""
    from idunno_tpu_torch.parallel.mesh import (EXPERT_AXIS, Mesh,
                                                MeshShapeError, virtual_mesh)

    mesh = virtual_mesh(1, 4, "cpu", axis=EXPERT_AXIS)
    with pytest.raises(ValueError, match="6 experts not divisible"):
        switch_ffn_factory(6, mesh=mesh)(16)
    with pytest.raises(ValueError, match="6 experts not divisible"):
        MoETransformerLM(n_experts=6, mesh=mesh)
    params = {"w1": torch.zeros(6, 4, 8), "b1": torch.zeros(6, 8),
              "w2": torch.zeros(6, 8, 4), "b2": torch.zeros(6, 4)}
    with pytest.raises(ValueError, match="6 experts not divisible"):
        expert_parallel_apply(lambda p, t: t, params, torch.zeros(8, 4),
                              torch.zeros(8, dtype=torch.int64),
                              torch.ones(8), mesh, capacity=2)
    ffn = SwitchFFN(4, 8, 4, mesh=mesh)
    with pytest.raises(ValueError, match="6 routing units not divisible"):
        ffn(torch.zeros(1, 6, 4))
    across = Mesh(mesh.devices, owners=((0, 0, 1, 1),), axes=mesh.axes)
    with pytest.raises(MeshShapeError,
                       match="no torch.distributed process group"):
        SwitchFFN(4, 8, 4, mesh=across)
    with pytest.raises(MeshShapeError, match="process group"):
        expert_parallel_apply(lambda p, t: t, params, torch.zeros(8, 4),
                              torch.zeros(8, dtype=torch.int64),
                              torch.ones(8), across, capacity=2)


# -- SwitchFFN ------------------------------------------------------------------

def ffn_pair(k, capacity_factor, seed=1):
    """(JAX SwitchFFN, its variables, the port's with the same weights)."""
    jffn = JaxSwitchFFN(dim=16, hidden=32, n_experts=4, k=k,
                        capacity_factor=capacity_factor)
    x0 = jnp.zeros((2, 24, 16), jnp.float32)
    variables = jffn.init(jax.random.PRNGKey(seed), x0)
    p = np_tree(variables["params"])
    ffn = SwitchFFN(16, 32, 4, k=k, capacity_factor=capacity_factor)
    ffn.load_state_dict({
        "router.weight": torch.from_numpy(p["router"]["kernel"].T.copy()),
        "router.bias": torch.from_numpy(p["router"]["bias"].copy()),
        **{n: torch.from_numpy(p[n].copy()) for n in ("w1", "b1", "w2",
                                                      "b2")}})
    return jffn, variables, ffn


@pytest.mark.parametrize("k,capacity_factor", [(1, 2.0), (2, 2.0), (1, 0.5),
                                               (2, 0.75)],
                         ids=["k1", "k2", "k1-drops", "k2-drops"])
def test_switch_ffn_matches_jax_dense_path(k, capacity_factor):
    """Gate indices equal; output and aux within 1e-5 (of the output's
    largest magnitude; absolute for aux). The small capacity factors
    overflow capacity: some routing units are dropped on both sides."""
    jffn, variables, ffn = ffn_pair(k, capacity_factor)
    x = np.random.default_rng(2).standard_normal((2, 24, 16)).astype(
        np.float32)
    want, upd = jffn.apply({"params": variables["params"]}, jnp.asarray(x),
                           mutable=["losses"])
    got = ffn(torch.from_numpy(x))
    assert got.shape == (2, 24, 16) and got.dtype == torch.float32
    assert_close(got, want, 1e-5)
    assert float(ffn.aux.detach()) == pytest.approx(float(jax_moe_aux_loss(upd)),
                                           abs=1e-5)
    # the routing itself
    p = variables["params"]["router"]
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 16) @ p["kernel"]
                            + p["bias"])
    probs = torch.softmax(ffn.router(torch.from_numpy(x).reshape(-1, 16)), -1)
    assert np.array_equal(top_k(probs, k)[1].numpy(),
                          np.asarray(jax.lax.top_k(jprobs, k)[1]))
    # dropped units: fewer kept than routed, on both sides alike
    units = 48 * k
    cap = ffn.capacity(units)
    assert cap == max(k, int(capacity_factor * units / 4))
    idx = top_k(probs, k)[1].reshape(-1)
    dispatch, _ = switch_dispatch(idx, torch.ones(units), 4, cap)
    kept = int(dispatch.sum())
    assert (kept < units) == (capacity_factor < 1.0)


def test_switch_ffn_bf16_compute_promotes_the_hidden_layer():
    """bf16 activations over f32 parameters: tokens and kernels round to
    bf16 and the f32 biases promote the hidden layer to f32, as in JAX
    (``dtype=bfloat16``): outputs within 2e-2 of the largest, in bf16."""
    jffn = JaxSwitchFFN(dim=16, hidden=32, n_experts=4, dtype=jnp.bfloat16)
    x = np.random.default_rng(3).standard_normal((2, 24, 16)).astype(
        np.float32)
    variables = jffn.init(jax.random.PRNGKey(1), jnp.asarray(x))
    _, _, ffn = ffn_pair(1, 2.0)
    want = jffn.apply(variables, jnp.asarray(x, jnp.bfloat16))
    got = ffn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_close(got.float(), np.asarray(want, np.float32), 2e-2)


def test_int8_switch_ffn_reads_what_jax_dequantizes():
    """int8 weights of a bf16 SwitchFFN (``ops/quantize.py``): the JAX
    package quantizes every leaf of two or more dimensions, router kernel
    and expert biases too, and dequantizes to f32, which its module adds
    to the f32-promoted hidden layer and feeds the f32 router as they are.
    The port reads the router and the biases back in f32 and the expert
    kernels in bf16 (cast to the compute dtype anyway): each bit-equal to
    the JAX dequantized leaf in that dtype."""
    from idunno_tpu.ops.quantize import dequantize_tree as jax_dequantize
    from idunno_tpu.ops.quantize import quantize_tree as jax_quantize
    from idunno_tpu_torch.ops.quantize import quantize_tree

    _, variables, ffn = ffn_pair(1, 2.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                      variables["params"])
    want = np_tree(jax_dequantize(jax_quantize(jp)))
    ffn = quantize_tree(ffn.to(torch.bfloat16))
    got = {"router.weight": ffn.router.weight.T, "w1": ffn.w1,
           "b1": ffn.b1, "w2": ffn.w2, "b2": ffn.b2}
    ref = {"router.weight": want["router"]["kernel"], "w1": want["w1"],
           "b1": want["b1"], "w2": want["w2"], "b2": want["b2"]}
    for name, w in got.items():
        dt = torch.bfloat16 if name in ("w1", "w2") else torch.float32
        assert w.dtype == dt, name
        r = torch.from_numpy(np.array(ref[name], np.float32)).to(dt)
        assert torch.equal(w, r), name
    assert ffn.router.bias.dtype == torch.bfloat16    # one dimension: dense


# -- MoETransformerLM -----------------------------------------------------------

def port_lm(moe_every, depth=4, seed=0):
    """The port's routed LM seeded with flax's initialisers (no JAX)."""
    tm = MoETransformerLM(depth=depth, moe_every=moe_every, **LM)
    init_like_flax(tm, torch.Generator().manual_seed(seed))
    return tm


def lm_pair(moe_every, depth=4, seed=0, k=1):
    jm = JaxMoELM(depth=depth, moe_every=moe_every, k=k, **LM)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = MoETransformerLM(depth=depth, moe_every=moe_every, k=k, **LM)
    tm.load_state_dict(lm_state_dict_from_flax(np_tree(params)))
    return jm, params, tm


def jax_loss(jm):
    def loss_fn(params, tokens):
        logits, upd = jm.apply({"params": params}, tokens, mutable=["losses"])
        ce, _ = jax_train_lm.next_token_loss(logits, tokens)
        return ce + 0.01 * jax_moe_aux_loss(upd)
    return loss_fn


def tokens(seed, b=4, t=16):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t))


@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_lm_logits_and_grads_match_jax(moe_every):
    """``moe_every=1`` routes both blocks of 2; ``moe_every=2`` is the
    layout of ``tests/test_moe.py``: blocks 1 and 3 of 4 (the last block
    always). Logits within 1e-5, the gradient of CE + 0.01·aux of every
    parameter within 1e-4 of its tensor's largest, against ``jax.grad``."""
    jm, params, tm = lm_pair(moe_every, depth=2 * moe_every)
    routed = [i for i, blk in enumerate(tm.blocks) if blk.ffn is not None]
    assert routed == ([0, 1] if moe_every == 1 else [1, 3])
    toks = tokens(4)
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(toks)))
    got = tm(torch.from_numpy(toks))
    assert_close(got, want, 1e-5)
    ce, _ = next_token_loss(got, torch.from_numpy(toks))
    loss = ce + 0.01 * moe_aux_loss(tm)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss(jm)))(
        params, jnp.asarray(toks))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    want_g = lm_state_dict_from_flax(np_tree(jgrads))
    got_p = dict(tm.named_parameters())
    assert set(got_p) == set(want_g)
    for name, g in want_g.items():
        assert got_p[name].grad is not None, name
        assert_close(got_p[name].grad, g.numpy(), 1e-4)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_moe_train_step_matches_jax(accum_steps):
    """One ``make_lm_train_step`` step of a depth-2 LM with both blocks
    routed (SGD 0.1, so the update is the gradient) against the JAX step from the same weights on the same
    batch: loss, ce and aux within rtol 1e-5, every parameter's update
    within 1e-4 of its tensor's largest update plus four f32 ulps of the
    tensor's largest parameter (the updates are read back as differences
    of stored f32 parameters). With ``accum_steps=2`` the aux is
    per chunk, averaged, on both sides."""
    jm, params, tm = lm_pair(1, depth=2, seed=3)
    toks = tokens(5, b=4)
    tx = optax.sgd(0.1)
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                  params=params, batch_stats={},
                                  opt_state=tx.init(params))
    jstate, jmetrics = jax.jit(jax_train_lm.make_lm_train_step(
        jm, tx, accum_steps=accum_steps))(jstate, jnp.asarray(toks))
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    state = TrainState(step=0, model=tm,
                       optimizer=sgd(0.1)(tm.parameters()))
    metrics = make_lm_train_step(tm, state.optimizer,
                                 accum_steps=accum_steps)(
        state, torch.from_numpy(toks))
    for key in ("loss", "ce", "aux"):
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]),
                                                    rel=1e-5), key
    assert float(metrics["aux"]) >= 2.0       # two routed blocks, each >= 1
    after = lm_state_dict_from_flax(np_tree(jstate.params))
    got = tm.state_dict()
    eps = float(np.finfo(np.float32).eps)
    for name, w in after.items():
        want_d = (w - before[name]).numpy()
        got_d = (got[name] - before[name]).numpy()
        # the update's own tolerance, plus the rounding of the stored f32
        # parameters the two updates are read back from
        tol = (1e-4 * float(np.abs(want_d).max())
               + 4 * eps * float(before[name].abs().max()))
        np.testing.assert_allclose(got_d, want_d, rtol=0, atol=tol,
                                   err_msg=name)


def test_remat_gives_the_same_loss_and_gradients():
    """``remat=True`` recomputes each block in the backward pass: the same
    loss and the same gradients, element for element, as without."""
    plain = port_lm(2, seed=5)
    remat = copy.deepcopy(plain)
    remat.remat = True
    toks = torch.from_numpy(tokens(6))
    grads = []
    for m in (plain, remat):
        ce, _ = next_token_loss(m(toks), toks)
        loss = ce + 0.01 * moe_aux_loss(m)
        loss.backward()
        grads.append((float(loss.detach()), {n: p.grad for n, p in
                                    m.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


def test_dense_lm_has_zero_aux_and_the_jax_layout():
    tm = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4,
                       ffn_every=2)
    assert all(blk.ffn is None for blk in tm.blocks)
    tm(torch.from_numpy(tokens(1)))
    assert float(moe_aux_loss(tm)) == 0.0
    with pytest.raises(ValueError, match="ffn_every"):
        TransformerLM(ffn_every=0)


# -- save_lm / load_lm --------------------------------------------------------------

def test_save_load_round_trip_of_a_routed_lm():
    """A routed LM stores its factory's declarative twin under ``ffn``,
    with the JAX twin's keys, beside ``ffn_every`` and ``remat``; loading
    rebuilds the same routed model (equal logits). A custom factory is
    still refused, and an unknown ``ffn`` kind raises on load."""
    tm = port_lm(2, seed=7)
    tm.remat = True
    store = MemStore()
    assert save_lm(store, "moe", tm) == 1
    header, _ = decode_state(store.blobs[lm_store_name("moe")][0])
    cfg = header["lm"]
    assert cfg["ffn"] == {"kind": "switch", "n_experts": 4,
                          "capacity_factor": 2.0, "hidden_ratio": 4, "k": 1}
    assert set(cfg["ffn"]) == set(jax_switch_factory(4).lm_store_ffn)
    assert cfg["ffn_every"] == 2 and cfg["remat"] is True
    back = load_lm(store, "moe", device="cpu")
    assert back.remat and back.ffn_every == 2
    assert [b.ffn is not None for b in back.blocks] == [False, True,
                                                        False, True]
    toks = torch.from_numpy(tokens(8))
    with torch.no_grad():
        assert torch.equal(back(toks), tm.eval()(toks))

    custom = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4,
                           ffn_factory=lambda dim: nn.Linear(dim, dim))
    with pytest.raises(ValueError, match="custom"):
        save_lm(store, "custom", custom)
    bad = dict(cfg, ffn={"kind": "other"})
    store.put_bytes(lm_store_name("bad"), encode_state(tm.state_dict(),
                                                       {"lm": bad}))
    with pytest.raises(ValueError, match="unknown ffn kind"):
        load_lm(store, "bad", device="cpu")
