"""Expert parallelism of the port against the JAX package, on the CPU.

The JAX package's expert-parallel path (``idunno_tpu/parallel/expert.py:
expert_parallel_apply`` under ``shard_map``, ``SwitchFFN(mesh=)``,
``MoETransformerLM(mesh=)``) runs on the conftest's eight host devices
(``eight_devices``) as a 1-D ``expert`` mesh of p = 2, 4 and 8; the port
runs the same weights and numpy-seeded inputs over a virtual expert mesh
of the one CPU (``parallel/mesh.py:virtual_mesh(1, p, "cpu",
axis=EXPERT_AXIS)``). Held: outputs, the balance loss and gradients in
f32 within 1e-5 of the largest, at k = 1 and 2, at a capacity that drops
routing units (the same units on both sides: each shard dispatches its
own block at the per-shard capacity) and at one that drops none, where
the port's EP path also equals its dense path; the typed errors; the
weights across layouts (the flax EP tree's dense layout loads into the
EP module, `dense_state_dict` and back, ``save_lm``/``load_lm`` store the
dense form); seeding; and the train step (CE + aux, backward through the
exchange, fused AdamW over the shards' parameters) against the dense
step. Small sizes: dim 16-32, depth 2, vocab 64, 8 experts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from idunno_tpu.engine import train_lm as jax_train_lm
from idunno_tpu.models.moe import MoETransformerLM as JaxMoELM
from idunno_tpu.models.moe import SwitchFFN as JaxSwitchFFN
from idunno_tpu.models.moe import moe_aux_loss as jax_moe_aux_loss
from idunno_tpu.parallel.expert import EXPERT_AXIS as JAX_EXPERT_AXIS
from idunno_tpu.parallel.expert import \
    expert_parallel_apply as jax_expert_parallel_apply
from idunno_tpu.parallel.expert import switch_dispatch as jax_switch_dispatch
from idunno_tpu_torch.engine.generate import load_lm, save_lm
from idunno_tpu_torch.engine.train import TrainState, adamw, flat_tx
from idunno_tpu_torch.engine.train_lm import (make_lm_train_step,
                                              next_token_loss)
from idunno_tpu_torch.models.convert import (dense_state_dict,
                                             expert_parallel_state_dict,
                                             lm_state_dict_from_flax)
from idunno_tpu_torch.models.init import init_like_flax
from idunno_tpu_torch.models.moe import (ExpertShard, MoETransformerLM,
                                         SwitchFFN, moe_aux_loss, top_k)
from idunno_tpu_torch.parallel.expert import (expert_parallel_apply,
                                              switch_dispatch)
from idunno_tpu_torch.parallel.mesh import EXPERT_AXIS, virtual_mesh
from tests.test_torch_moe import MemStore
from tests.torch_workers import share_cores  # noqa: F401

VOCAB, E = 64, 8
TOL = 1e-5


def assert_close(got, want, tol=TOL, what=""):
    """|got - want| within ``tol`` of the reference's largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, err_msg=what,
        atol=tol * max(float(np.abs(want).max()), 1e-30))


def jax_mesh(devices, p):
    return JaxMesh(np.asarray(devices[:p]), (JAX_EXPERT_AXIS,))


def port_mesh(p):
    return virtual_mesh(1, p, "cpu", axis=EXPERT_AXIS)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ffn_state(p_flax) -> dict:
    """The port's dense ``SwitchFFN`` state dict from a JAX one's params."""
    return {"router.weight": torch.from_numpy(
                np.array(p_flax["router"]["kernel"]).T.copy()),
            "router.bias": torch.from_numpy(np.array(p_flax["router"]["bias"])),
            **{n: torch.from_numpy(np.array(p_flax[n]))
               for n in ("w1", "b1", "w2", "b2")}}


def test_expert_parallel_apply_matches_jax(eight_devices):
    """The function itself, at p = 2 and 8 on seeded gates with a
    capacity that drops units: bit-for-bit the JAX dispatch per shard, the
    output within 1e-5 of the largest."""
    rng = np.random.default_rng(0)
    n, d, h = 32, 8, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, E, n)
    w = rng.random(n).astype(np.float32)
    params = {"w1": rng.standard_normal((E, d, h)).astype(np.float32),
              "b1": rng.standard_normal((E, h)).astype(np.float32),
              "w2": rng.standard_normal((E, h, d)).astype(np.float32),
              "b2": rng.standard_normal((E, d)).astype(np.float32)}

    def jax_expert(p, toks):
        return jax.nn.gelu(toks @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def port_expert(p, toks):
        hid = torch.nn.functional.gelu(torch.matmul(toks, p["w1"])
                                       + p["b1"][:, None], approximate="tanh")
        return torch.matmul(hid, p["w2"]) + p["b2"][:, None]

    for p in (2, 8):
        want = jax.jit(lambda *a, p=p: jax_expert_parallel_apply(
            jax_expert, *a, jax_mesh(eight_devices, p), capacity=2))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x),
            jnp.asarray(idx), jnp.asarray(w))
        got = expert_parallel_apply(
            port_expert, {k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w),
            port_mesh(p), capacity=2)
        assert got.shape == (n, d) and got.dtype == torch.float32
        assert_close(got, want, what=f"p={p}")
        per = n // p
        for s in range(p):
            rows = slice(s * per, (s + 1) * per)
            jd, _ = jax_switch_dispatch(jnp.asarray(idx[rows]),
                                        jnp.asarray(w[rows]), E, 2)
            td, _ = switch_dispatch(torch.from_numpy(idx[rows]),
                                    torch.from_numpy(w[rows]), E, 2)
            assert np.array_equal(td.numpy(), np.asarray(jd))
        assert int(td.sum()) <= per


CASES = [(p, k, cf) for p in (2, 4, 8) for k in (1, 2)
         for cf in (0.5, float(E))]


def ffn_params(seed: int) -> dict:
    """Seeded flax params of a ``SwitchFFN(dim=16, hidden=32, n_experts=E)``
    (the router with a bias, so routing is not uniform)."""
    rng = np.random.default_rng(seed)
    return {"router": {"kernel": rng.standard_normal((16, E)).astype(
                           np.float32) * 0.5,
                       "bias": rng.standard_normal(E).astype(np.float32)},
            "w1": rng.standard_normal((E, 16, 32)).astype(np.float32) * 0.25,
            "b1": rng.standard_normal((E, 32)).astype(np.float32) * 0.1,
            "w2": rng.standard_normal((E, 32, 16)).astype(np.float32) * 0.2,
            "b2": rng.standard_normal((E, 16)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("p,k,cf", CASES,
                         ids=[f"p{p}-k{k}-{'drops' if cf < E else 'nodrop'}"
                              for p, k, cf in CASES])
def test_switch_ffn_over_an_expert_mesh_matches_jax(eight_devices, p, k,
                                                    cf):
    """``SwitchFFN(mesh=)`` against the JAX EP layer on the same weights
    (the flax tree's dense layout cut by `expert_parallel_state_dict`):
    output, aux and the gradients of ``sum(out · r) + aux`` with respect
    to every parameter and to the input within 1e-5 of the largest, against
    ``jax.grad`` through the JAX all-to-all path; the units each shard
    keeps are the JAX shard's (capacity ``n_units / p``); at capacity
    factor E (no unit can overflow) the EP output also equals the port's
    dense path."""
    rng = np.random.default_rng(10 * p + k)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    r = rng.standard_normal((2, 32, 16)).astype(np.float32)
    params = ffn_params(p + k)
    kw = dict(dim=16, hidden=32, n_experts=E, k=k, capacity_factor=cf)
    jep = JaxSwitchFFN(**kw, mesh=jax_mesh(eight_devices, p))

    def jloss(prm, xx):
        out, upd = jep.apply({"params": prm}, xx, mutable=["losses"])
        aux = jax_moe_aux_loss(upd)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (want, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    ep = SwitchFFN(16, 32, E, k=k, capacity_factor=cf, mesh=port_mesh(p))
    dense_sd = ffn_state(params)
    ep.load_state_dict(expert_parallel_state_dict(dense_sd, p))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ep(xt)
    assert_close(got, want)
    assert float(ep.aux.detach()) == pytest.approx(float(jaux), abs=TOL)
    ((got * torch.from_numpy(r)).sum() + ep.aux).backward()
    assert_close(xt.grad, jgx, what="x")
    want_g = expert_parallel_state_dict(ffn_state(np_tree(jgp)), p)
    for name, param in ep.named_parameters():
        assert_close(param.grad, want_g[name].numpy(), what=name)
    # the units each shard keeps, from the routing both sides take
    probs = torch.softmax(ep.router(torch.from_numpy(x).reshape(-1, 16)), -1)
    w, idx = top_k(probs.detach(), k)
    if k > 1:
        w = w / w.sum(-1, keepdim=True)
    idx, w = idx.reshape(-1), w.reshape(-1)
    units = idx.shape[0]
    cap = ep.capacity(units // p)
    kept = 0
    for s in range(p):
        rows = slice(s * units // p, (s + 1) * units // p)
        td, _ = switch_dispatch(idx[rows], w[rows], E, cap)
        jd, _ = jax_switch_dispatch(jnp.asarray(idx[rows].numpy()),
                                    jnp.asarray(w[rows].numpy()), E, cap)
        assert np.array_equal(td.numpy(), np.asarray(jd))
        kept += int(td.sum())
    assert (kept < units) == (cf < E)
    if cf == E:
        dense = SwitchFFN(16, 32, E, k=k, capacity_factor=cf)
        dense.load_state_dict(dense_sd)
        assert_close(got, dense(torch.from_numpy(x)).detach().numpy())


def lm_pair(devices, p, k, cf, seed):
    kw = dict(vocab=VOCAB, dim=32, depth=2, num_heads=4, n_experts=E, k=k,
              capacity_factor=cf)
    jm = JaxMoELM(**kw, mesh=jax_mesh(devices, p))
    params = jax.jit(JaxMoELM(**kw).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = MoETransformerLM(**kw, mesh=port_mesh(p))
    tm.load_state_dict(expert_parallel_state_dict(
        lm_state_dict_from_flax(np_tree(params)), p))
    return jm, params, tm


LM_CASES = [(4, 2, 0.5), (8, 1, float(E))]


@pytest.mark.parametrize("p,k,cf", LM_CASES,
                         ids=[f"p{p}-k{k}-{'drops' if cf < E else 'nodrop'}"
                              for p, k, cf in LM_CASES])
def test_moe_lm_over_an_expert_mesh_matches_jax(eight_devices, p, k, cf):
    """``MoETransformerLM(mesh=)`` against the JAX EP model on the same
    weights: logits and the balance loss within 1e-5, and the gradient of
    CE + 0.01·aux of every parameter (the experts' cut over the shards as
    the port holds them) within 1e-5 of its tensor's largest, against
    ``jax.grad`` through the JAX all-to-all path."""
    jm, params, tm = lm_pair(eight_devices, p, k, cf, seed=p + k)
    toks = np.random.default_rng(p).integers(0, VOCAB, (2, 16))

    def loss_fn(prm, t):
        logits, upd = jm.apply({"params": prm}, t, mutable=["losses"])
        ce, _ = jax_train_lm.next_token_loss(logits, t)
        aux = jax_moe_aux_loss(upd)
        return ce + 0.01 * aux, (logits, aux)

    (jloss, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jnp.asarray(toks))
    t = torch.from_numpy(toks)
    logits = tm(t)
    assert_close(logits, jlogits)
    aux = moe_aux_loss(tm)
    assert float(aux.detach()) == pytest.approx(float(jaux), abs=TOL)
    ce, _ = next_token_loss(logits, t)
    loss = ce + 0.01 * aux
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    loss.backward()
    want = expert_parallel_state_dict(
        lm_state_dict_from_flax(np_tree(jgrads)), p)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    assert any(".ffn.shards." in name for name in got)
    for name, g in want.items():
        assert_close(got[name].grad, g.numpy(), what=name)


def test_weights_across_layouts_and_seeding():
    """The EP module and the dense one share weights both ways
    (`expert_parallel_state_dict` / `dense_state_dict`), an EP model seeded
    from a generator takes the dense model's weights from the same one,
    ``save_lm`` stores the dense form and ``load_lm`` gives a dense model
    with equal logits, and an expert shard keeps its device when the
    model is cast or moved, never passing through the target device (a
    card test holds shards on two devices)."""
    kw = dict(vocab=VOCAB, dim=32, depth=2, num_heads=4, n_experts=E,
              capacity_factor=float(E), moe_every=2)
    dense = MoETransformerLM(**kw)
    init_like_flax(dense, torch.Generator().manual_seed(4))
    ep = MoETransformerLM(**kw, mesh=port_mesh(4))
    init_like_flax(ep, torch.Generator().manual_seed(4))
    sd = dense_state_dict(ep.state_dict())
    assert sd.keys() == dense.state_dict().keys()
    for name, v in dense.state_dict().items():
        assert torch.equal(sd[name], v), name
    back = expert_parallel_state_dict(sd, 4)
    assert back.keys() == ep.state_dict().keys()
    assert back["blocks.1.ffn.shards.3.w1"].shape == (2, 32, 128)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, VOCAB, (2, 16)))
    with torch.no_grad():
        want = dense(toks)
        assert_close(ep(toks), want.numpy())
    store = MemStore()
    save_lm(store, "ep", ep)
    loaded = load_lm(store, "ep", device="cpu")
    assert all(blk.ffn is None or not hasattr(blk.ffn, "shards")
               for blk in loaded.blocks)
    with torch.no_grad():
        assert torch.equal(loaded(toks), want)
    ep.to("cpu").to(torch.float64)
    shard = ep.blocks[1].ffn.shards[2]
    assert isinstance(shard, ExpertShard) and shard.placed.type == "cpu"
    assert shard.w1.device == shard.placed and shard.w1.dtype == torch.float64
    # a shard never passes through the target device: to the meta device,
    # whence nothing can be copied back, the rest of the model moves and
    # the shards keep their place and values
    w1 = shard.w1.detach().clone()
    ep.to("meta")
    assert ep.ln_f.weight.is_meta and ep.blocks[1].ffn.router.weight.is_meta
    assert shard.w1.device == shard.placed and torch.equal(shard.w1, w1)
    with pytest.raises(ValueError, match="6 experts not divisible"):
        expert_parallel_state_dict(dense_state_dict(
            SwitchFFN(4, 8, 6).state_dict()), 4)


@pytest.mark.parametrize("k", [1, 2])
def test_ep_train_step_matches_the_dense_step(k):
    """One ``make_lm_train_step`` step (CE + 0.01·aux, backward through
    the exchanges, fused AdamW over every parameter, the shards' too) of
    the EP model at no-drop capacity against the dense model's step from
    the same weights on the same batch: metrics within 1e-5, every
    parameter after the step within 1e-5 of its tensor's largest update
    plus four f32 ulps of its largest value."""
    kw = dict(vocab=VOCAB, dim=32, depth=2, num_heads=4, n_experts=E, k=k,
              capacity_factor=float(E))
    dense = MoETransformerLM(**kw)
    init_like_flax(dense, torch.Generator().manual_seed(7 + k))
    ep = MoETransformerLM(**kw, mesh=port_mesh(4))
    ep.load_state_dict(expert_parallel_state_dict(dense.state_dict(), 4))
    before = {n: v.clone() for n, v in dense.state_dict().items()}
    toks = torch.from_numpy(np.random.default_rng(k).integers(
        0, VOCAB, (4, 16)))
    metrics = {}
    for name, model in (("dense", dense), ("ep", ep)):
        state = TrainState(0, model,
                           flat_tx(adamw(1e-3))(model.parameters()))
        metrics[name] = make_lm_train_step(model, state.optimizer)(state,
                                                                   toks)
    for key in ("loss", "ce", "aux"):
        assert float(metrics["ep"][key]) == pytest.approx(
            float(metrics["dense"][key]), rel=TOL), key
    got = dense_state_dict(ep.state_dict())
    eps = float(np.finfo(np.float32).eps)
    for name, w in dense.state_dict().items():
        upd = (w - before[name]).abs().max()
        tol = TOL * float(upd) + 4 * eps * float(before[name].abs().max())
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=tol, err_msg=name)
