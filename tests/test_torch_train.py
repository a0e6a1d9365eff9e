"""Parity of the port's training path with the JAX package, on the CPU.

The flash backward (the autograd Function, whose kernels run their plain
versions on CPU tensors) against ``jax.grad`` through the JAX package's
Pallas flash in interpret mode; the LM train step, its loss, its
optimizer and its data against the JAX step; the ResNet-18 step; the
train bench's record at the CPU miniature. Inputs and weights come from
numpy seeds or from the JAX package's own init, carried across by the
weight converters; everything is f32 unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idunno_tpu.engine import data_lm as jax_data_lm
from idunno_tpu.engine import train as jax_train
from idunno_tpu.engine import train_lm as jax_train_lm
from idunno_tpu.models import create_model as jax_create_model
from idunno_tpu.models.moe import moe_aux_loss
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.models.transformer import make_attn_fn as jax_make_attn_fn
from idunno_tpu.ops import flash_attention as jax_flash
from idunno_tpu_torch.engine.data_lm import TokenDataset
from idunno_tpu_torch.engine.train import (TrainState, adam, adamw,
                                           create_train_state, flat_tx,
                                           make_train_step, sgd)
from idunno_tpu_torch.engine.train_lm import (create_lm_train_state,
                                              make_lm_train_step,
                                              next_token_loss)
from idunno_tpu_torch.models import create_model
from idunno_tpu_torch.models.convert import (lm_state_dict_from_flax,
                                             state_dict_from_flax)
from idunno_tpu_torch.models.transformer import TransformerLM, make_attn_fn
from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.ops.flash_attention import (
    NEG_INF, attention_delta, flash_attention, flash_attention_bwd_dkv_kernel,
    flash_attention_bwd_dq_kernel, flash_attention_bwd_plain,
    flash_attention_kernel, flash_attention_plain, tensor_core_bound)
from idunno_tpu_torch.utils.train_bench import run_train_bench
from tests.torch_workers import share_cores  # noqa: F401


def jax_cnn_state(jmodel, key, size: int, tx):
    """``idunno_tpu/engine/train.py:create_train_state`` with its init
    jitted: the same state, without the seconds a ResNet-18's eager flax
    init takes."""
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, size, size, 3), jnp.float32), train=True))(key)
    params = variables["params"]
    return jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats=variables.get("batch_stats", {}),
                                opt_state=tx.init(params))


VOCAB, DIM, DEPTH, HEADS, T, B = 64, 64, 2, 4, 32, 4


def arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def assert_close(got, want, tol):
    """|got - want| within ``tol`` of the reference's largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


# -- the flash backward ------------------------------------------------------

@pytest.mark.parametrize("t", [64, 40])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax_pallas_backward(causal, d, t):
    """dq, dk, dv of the port's FlashAttention against ``jax.grad`` through
    the Pallas forward and backward kernels (interpret mode, 16 x 16
    blocks, so T = 40 is padded and masked). f32 on both sides, only the
    summation order differs: 1e-5 of each gradient's largest magnitude."""
    q, k, v, do = arrays(t + d + causal, (2, t, 2, d), 4)

    def jax_loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=causal, block_q=16,
                                        block_k=16, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    out.backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, want):
        assert_close(leaf.grad, w, 1e-5)


def tensor_core_dkv(q, k, v, do, lse, delta, causal, tile=64):
    """Emulation of K5's bf16 tensor-core arithmetic
    (``csrc/flash_attention_bwd.cu:flash_bwd_dkv_tc``) in torch: bf16
    inputs whose products are exact in f32, 64-query tiles in order,
    Pᵀ = exp(Sᵀ·scale − lse) and dSᵀ = Pᵀ∘(dPᵀ − delta)·scale in f32, both
    rounded to bf16 before dV += Pᵀ·dO and dK += dSᵀ·Q, dK and dV rounded
    to bf16 at the end."""
    _, t, _, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, of = (x.float().transpose(1, 2) for x in (q, k, v, do))
    keys = torch.arange(t)[:, None]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, t, tile):
        qt, ot = qf[:, :, q0:q0 + tile], of[:, :, q0:q0 + tile]
        st = (kf @ qt.transpose(-1, -2)) * scale
        if causal:
            rows = torch.arange(q0, q0 + qt.shape[2])[None, :]
            st = st.masked_fill(keys > rows, NEG_INF)
        pt = torch.exp(st - lse[:, :, None, q0:q0 + tile])
        dst = pt * (vf @ ot.transpose(-1, -2)
                    - delta[:, :, None, q0:q0 + tile]) * scale
        dv += pt.bfloat16().float() @ ot
        dk += dst.bfloat16().float() @ qt
    return dk.transpose(1, 2).bfloat16(), dv.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_dkv_within_bound_of_jax_vjp(causal, t, d):
    """K5's bf16 tensor-core arithmetic (emulated, on lse and delta of the
    f32 forward) against ``jax.vjp`` through the JAX package's Pallas
    flash in f32 (interpret mode) on the same bf16-representable inputs:
    each dK and dV element within ``tensor_core_bound``, the bound the
    card checks hold K5 to."""
    rng = np.random.default_rng(200 + t + d + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, t, 2, d),
                                                        dtype=np.float32))
                   .bfloat16() for _ in range(4))
    qf, kf, vf, of = (x.float() for x in (q, k, v, do))

    def jax_fwd(q, k, v):
        return jax_flash.flash_attention(q, k, v, causal=causal, block_q=32,
                                         block_k=32, interpret=True)

    _, vjp = jax.vjp(jax_fwd, *(jnp.asarray(x.numpy()) for x in (qf, kf, vf)))
    _, want_dk, want_dv = (torch.from_numpy(np.array(g))
                           for g in vjp(jnp.asarray(of.numpy())))
    out, lse = flash_attention_plain(qf, kf, vf, causal=causal)
    delta = attention_delta(out, of)
    dk, dv = tensor_core_dkv(q, k, v, do, lse, delta, causal)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        bound = tensor_core_bound(name, got, want, q, k, v, causal=causal,
                                  do=do, lse=lse, delta=delta)
        ratio = float(((got.float() - want).abs().double() / bound).max())
        assert ratio <= 1.0, (name, ratio)


def tensor_core_dq(q, k, v, do, lse, delta, causal, tile=64):
    """Emulation of K4's bf16 tensor-core arithmetic
    (``csrc/flash_attention_bwd.cu:flash_bwd_dq_tc``) in torch: bf16
    inputs whose products are exact in f32, 64-key tiles in order,
    P = exp(S·scale − lse) and dS = P∘(dP − delta)·scale in f32, dS
    rounded to bf16 before dQ += dS·K, dQ rounded to bf16 at the end."""
    _, t, _, d = q.shape
    scale = 1.0 / d ** 0.5
    qf, kf, vf, of = (x.float().transpose(1, 2) for x in (q, k, v, do))
    rows = torch.arange(t)[:, None]
    dq = torch.zeros_like(qf)
    for k0 in range(0, t, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        p = torch.exp(s - lse[..., None])
        ds = p * (of @ vt.transpose(-1, -2) - delta[..., None]) * scale
        dq += ds.bfloat16().float() @ kt
    return dq.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_dq_within_bound_of_jax_vjp(causal, t, d):
    """K4's bf16 tensor-core arithmetic (emulated, on lse and delta of the
    f32 forward) against ``jax.vjp`` through the JAX package's Pallas
    flash in f32 (interpret mode) on the same bf16-representable inputs:
    each dQ element within ``tensor_core_bound("dq")``, the bound the
    card checks hold K4 to; the emulated dQ scaled by 1 + 2⁻⁷ breaks it."""
    rng = np.random.default_rng(300 + t + d + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, t, 2, d),
                                                        dtype=np.float32))
                   .bfloat16() for _ in range(4))
    qf, kf, vf, of = (x.float() for x in (q, k, v, do))

    def jax_fwd(q, k, v):
        return jax_flash.flash_attention(q, k, v, causal=causal, block_q=32,
                                         block_k=32, interpret=True)

    _, vjp = jax.vjp(jax_fwd, *(jnp.asarray(x.numpy()) for x in (qf, kf, vf)))
    want = torch.from_numpy(np.array(vjp(jnp.asarray(of.numpy()))[0]))
    out, lse = flash_attention_plain(qf, kf, vf, causal=causal)
    delta = attention_delta(out, of)
    dq = tensor_core_dq(q, k, v, do, lse, delta, causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape

    def ratio(got):
        bound = tensor_core_bound("dq", got, want, q, k, v, causal=causal,
                                  do=do, lse=lse, delta=delta)
        return float(((got.float() - want).abs().double() / bound).max())

    assert ratio(dq) <= 1.0
    assert ratio((dq.float() * (1 + 2 ** -7)).bfloat16()) > 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd_of_full_attention(causal):
    """The plain backward against torch autograd through the reference
    attention (``ops/attention.py``); 1e-5 of the largest magnitude."""
    q, k, v, do = map(torch.from_numpy, arrays(3 + causal, (2, 24, 3, 16), 4))
    out, lse = flash_attention_kernel(q, k, v, causal=causal)   # plain on CPU
    got = flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    full_attention(*leaves, causal=causal).backward(do)
    for g, leaf in zip(got, leaves):
        assert_close(g, leaf.grad.numpy(), 1e-5)


def test_bwd_kernel_wrappers_run_plain_on_cpu():
    q, k, v, do = map(torch.from_numpy, arrays(4, (2, 9, 2, 8), 4))
    out, lse = flash_attention_kernel(q, k, v, causal=True)
    delta = attention_delta(out, do)
    before = (flash_attention_bwd_dq_kernel.launches,
              flash_attention_bwd_dkv_kernel.launches)
    dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, causal=True)
    dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                            causal=True)
    assert (flash_attention_bwd_dq_kernel.launches,
            flash_attention_bwd_dkv_kernel.launches) == before
    ref = flash_attention_bwd_plain(q, k, v, out, do, lse, causal=True)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), ref))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dq_kernel(q, k, v, do, lse[:, :, :4], delta)
    with pytest.raises(ValueError, match="gradient"):
        flash_attention_bwd_dkv_kernel(q, k, v, do[:, :4], lse, delta)


# -- the LM step ---------------------------------------------------------------

def lm_pair(seed=0):
    """(JAX model attending through the Pallas flash in interpret mode, its
    params, the port's model with the same weights through ``flash``)."""
    jm = JaxLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
               attn_fn=jax_make_attn_fn("flash", interpret=True))
    params = jax.jit(JaxLM(vocab=VOCAB, dim=DIM, depth=DEPTH,
                           num_heads=HEADS).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                       attn_fn=make_attn_fn("flash"))
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    return jm, params, tm


def lm_tokens(seed, b=B, t=T):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t))


def jax_lm_loss(jm):
    """The loss of ``make_lm_train_step`` (CE + 0.01 × the MoE aux loss)."""
    def loss_fn(params, tokens):
        logits, updates = jm.apply({"params": params}, tokens,
                                   mutable=["losses"])
        ce, _ = jax_train_lm.next_token_loss(logits, tokens)
        return ce + 0.01 * moe_aux_loss(updates)
    return loss_fn


def test_next_token_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    toks = rng.integers(0, 11, (3, 7))
    toks[0, 1:4] = np.argmax(logits[0, :3], -1)     # three right guesses
    want_ce, want_acc = jax_train_lm.next_token_loss(jnp.asarray(logits),
                                                     jnp.asarray(toks))
    ce, acc = next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks))
    np.testing.assert_allclose(float(ce), float(want_ce), rtol=1e-6)
    assert float(acc) == pytest.approx(float(want_acc), abs=1e-7)
    assert float(acc) > 0


def test_lm_step_grads_match_jax():
    """One step's gradients of every parameter of the port's TransformerLM
    (through the flash Function) against ``jax.grad`` of the JAX step's
    loss (through the Pallas flash in interpret mode), carried across by
    ``lm_state_dict_from_flax``. f32 on both sides: 1e-5 of each tensor's
    largest gradient (two layers of f32 matmuls in another order; the
    largest difference seen here was 1.0e-6)."""
    jm, params, tm = lm_pair()
    toks = lm_tokens(6)
    want = jax.grad(jax_lm_loss(jm))(params, jnp.asarray(toks))
    want = lm_state_dict_from_flax(jax.tree.map(np.asarray, want))
    ce, _ = next_token_loss(tm(torch.from_numpy(toks)), torch.from_numpy(toks))
    ce.backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].grad is not None, name
        assert_close(got[name].grad, w.numpy(), 1e-5)


@pytest.mark.parametrize("layout", ["flat", "per_tensor"])
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizers_match_optax(name, layout):
    """Three updates on identical numpy gradients: the port's optimizer
    (fused for ``flat_tx``, per-tensor otherwise) against optax's; params
    equal to f32 rounding (1e-6 of their largest magnitude)."""
    port = {"adamw": adamw(1e-2), "adam": adam(1e-2),
            "sgd": sgd(0.1, momentum=0.9)}[name]
    ref = {"adamw": optax.adamw(1e-2), "adam": optax.adam(1e-2),
           "sgd": optax.sgd(0.1, momentum=0.9)}[name]
    if layout == "flat":
        port, ref = flat_tx(port), jax_train.flat_tx(ref)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    init = [arrays(i, s, 1)[0] for i, s in enumerate(shapes)]
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in init]
    opt = port(params)
    jparams = [jnp.asarray(x) for x in init]
    opt_state = ref.init(jparams)
    for step in range(3):
        grads = [arrays(10 * step + i, s, 1)[0] for i, s in enumerate(shapes)]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, opt_state = ref.update([jnp.asarray(g) for g in grads],
                                        opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, w in zip(params, jparams):
            assert_close(p, np.asarray(w), 1e-6)


def test_lm_loss_trajectory_matches_jax():
    """Three steps of the port's LM step (flat adamw) against the JAX step
    from the same weights on the same tokens: each step's loss within
    rtol 1e-3."""
    jm, params, tm = lm_pair(seed=1)
    toks = lm_tokens(7)
    tx = optax.adamw(1e-2)
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                  params=params, batch_stats={},
                                  opt_state=tx.init(params))
    jstep = jax.jit(jax_train_lm.make_lm_train_step(jm, tx))
    state = TrainState(step=0, model=tm,
                       optimizer=flat_tx(adamw(1e-2))(tm.parameters()))
    step = make_lm_train_step(tm, state.optimizer)
    for i in range(3):
        jstate, jm_metrics = jstep(jstate, jnp.asarray(toks))
        metrics = step(state, torch.from_numpy(toks))
        assert set(metrics) == {"loss", "ce", "aux", "accuracy"}
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jm_metrics["loss"]), rtol=1e-3)
        assert float(metrics["aux"]) == 0.0
    assert state.step == 3


def test_accum_steps_match_full_batch():
    """``accum_steps=4`` against the full batch from the same weights: the
    same metrics and, after one SGD update, the same parameters (1e-5 of
    their largest magnitude: the chunks' gradients sum in another order).
    A batch that does not divide raises."""
    _, _, a = lm_pair(seed=2)
    _, _, b = lm_pair(seed=2)
    toks = torch.from_numpy(lm_tokens(8, b=8))
    out = {}
    for name, model, accum in (("full", a, 1), ("accum", b, 4)):
        opt = sgd(0.5)(model.parameters())
        state = TrainState(step=0, model=model, optimizer=opt)
        out[name] = make_lm_train_step(model, opt, accum_steps=accum)(state,
                                                                      toks)
    for key in ("loss", "ce", "accuracy"):
        np.testing.assert_allclose(float(out["accum"][key]),
                                   float(out["full"][key]), rtol=1e-5)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert_close(pb, pa.detach().numpy(), 1e-5)
    state = TrainState(step=0, model=b, optimizer=opt)
    with pytest.raises(ValueError, match="not divisible"):
        make_lm_train_step(b, opt, accum_steps=3)(state, toks)
    with pytest.raises(ValueError, match="accum_steps"):
        make_lm_train_step(b, opt, accum_steps=0)


def test_lm_mixed_precision_training():
    """bf16 compute over f32 master parameters (the JAX package's
    ``test_lm_mixed_precision_training``): params and their gradients stay
    f32, the block outputs are bf16, the logits f32, and ten adam steps on
    one batch lower the loss below 0.9 of the first."""
    model = TransformerLM(vocab=VOCAB, dim=32, depth=1, num_heads=4,
                          attn_fn=make_attn_fn("flash"),
                          compute_dtype=torch.bfloat16)
    state = create_lm_train_state(model, torch.Generator().manual_seed(0),
                                  adam(1e-2), device="cpu")
    seen = {}
    model.blocks[0].register_forward_hook(
        lambda mod, args, out: seen.__setitem__("block", out.dtype))
    toks = torch.from_numpy(lm_tokens(19))
    assert model(toks).dtype == torch.float32
    assert seen["block"] == torch.bfloat16
    step = make_lm_train_step(model, state.optimizer)
    losses = [float(step(state, toks)["loss"]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] * 0.9
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert model.dtype == torch.float32
    assert model.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("param_dtype,compute_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_layer_norm_and_dense_match_flax(param_dtype, compute_dtype):
    """The port's ``LayerNorm`` and ``Dense`` (one path for every dtype
    pairing) against flax's with ``param_dtype``/``dtype``: the same
    output dtype, LayerNorm within 1e-6 of its largest output (flax takes
    the variance as E[x²] - E[x]², torch by Welford's rule) plus, at bf16,
    1 ulp of each element (both compute in f32 and round once), Dense
    within 1e-6 relative at f32 and 2 bf16 ulps of the largest output at
    bf16 (the products' summation order differs)."""
    import flax.linen as fnn
    from idunno_tpu_torch.models.transformer import LN_EPS, Dense, LayerNorm
    pdt, cdt = getattr(torch, param_dtype), getattr(torch, compute_dtype)
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, (3, 7, 48)).astype(np.float32)
    w = rng.normal(0.0, 0.2, (48, 40)).astype(np.float32)
    scale = rng.normal(1.0, 0.3, 48).astype(np.float32)
    bias = rng.normal(0.0, 0.3, 48).astype(np.float32)
    jx = jnp.asarray(x, dtype=compute_dtype)

    ln_ref = fnn.LayerNorm(epsilon=LN_EPS, dtype=compute_dtype,
                           param_dtype=param_dtype).apply(
        {"params": {"scale": jnp.asarray(scale, param_dtype),
                    "bias": jnp.asarray(bias, param_dtype)}}, jx)
    ln = LayerNorm(48, eps=LN_EPS).to(pdt)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(cdt))
    assert got.dtype == cdt
    want = np.asarray(ln_ref.astype(jnp.float32))
    ulp = np.abs(want) * (2.0 ** -7 if cdt == torch.bfloat16 else 0.0)
    assert np.all(np.abs(got.float().numpy() - want)
                  <= ulp + 1e-6 * np.abs(want).max())

    d_ref = fnn.Dense(40, dtype=compute_dtype, param_dtype=param_dtype
                      ).apply({"params": {"kernel": jnp.asarray(w, param_dtype),
                                          "bias": jnp.asarray(bias[:40],
                                                              param_dtype)}},
                              jx)
    dense = Dense(48, 40).to(pdt)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T))
        dense.bias.copy_(torch.from_numpy(bias[:40]))
        got = dense(torch.from_numpy(x).to(cdt))
    assert got.dtype == cdt
    want = np.asarray(d_ref.astype(jnp.float32))
    tol = (2 * 2.0 ** -8 if cdt == torch.bfloat16 else 1e-6) * np.abs(
        want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_compute_dtype_defaults_to_the_parameters():
    model = TransformerLM(vocab=VOCAB, dim=32, depth=1, num_heads=4)
    assert model.compute_dtype == model.dtype == torch.float32
    model.to(torch.bfloat16)
    assert model.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("processes", [1, 3])
def test_token_dataset_matches_jax(processes):
    """The same corpus and seed give the same blocks, epoch by epoch and
    process by process, as the JAX package's TokenDataset."""
    corpus = np.random.default_rng(9).integers(0, 1000, 5000)
    port, ref = TokenDataset(corpus, 31, seed=4), \
        jax_data_lm.TokenDataset(corpus, 31, seed=4)
    assert port.n_blocks == ref.n_blocks
    for epoch in range(2):
        for p in range(processes):
            kw = dict(process_index=p, process_count=processes)
            got = list(port.batches(5, epoch, **kw))
            want = list(ref.batches(5, epoch, **kw))
            assert len(got) == len(want) > 0
            assert all(np.array_equal(g, w) and g.dtype == np.int32
                       for g, w in zip(got, want))
    with pytest.raises(ValueError, match="shorter"):
        TokenDataset(corpus[:10], 31)


# -- the bench and the entry points --------------------------------------------

def test_train_bench_record_at_cpu_miniature():
    rec = run_train_bench(device="cpu")
    assert rec["platform"] == "cpu" and rec["n_devices"] == 1
    assert rec["config"]["dim"] == 64 and rec["config"]["seq"] == 32
    lm = rec["lm"]
    for key in ("tokens_per_s", "step_s", "loss", "attention",
                "optimizer_layout", "flops_per_token_gf"):
        assert key in lm, key
    assert "mfu" not in lm                  # no device metric from a CPU run
    assert "flash" in lm["attention"] and np.isfinite(lm["loss"])
    assert lm["flops_per_token_gf"] == pytest.approx(
        (6 * rec["n_params"] + 12 * 32 * 64 * 1) / 1e9)
    assert rec["accum"]["accum_steps"] == 2 and rec["accum"]["tokens_per_s"] > 0
    assert "fsdp" not in rec        # one data group on the CPU, as JAX
    assert rec["cnn"]["model"] == "resnet18" and rec["cnn"]["images_per_s"] > 0
    assert not any("error" in v for v in rec.values() if isinstance(v, dict))


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` the entry points run on the card, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    model = TransformerLM(vocab=VOCAB, dim=32, depth=1, num_heads=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_lm_train_state(model, torch.Generator(), adamw(1e-3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(create_model("resnet18"), torch.Generator(),
                           sgd(0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_train_bench()


# -- the ResNet-18 step --------------------------------------------------------

def test_resnet18_step_matches_jax():
    """One SGD-momentum step of the port's ResNet-18 against the JAX step
    from the same weights on the same images (f32, batch 4, 32²): the
    loss, the running means (1e-5 of their largest magnitude) and the
    running variances (1e-4), each against the JAX value directly: the
    port folds flax's biased batch variance into ``running_var``
    (``models/resnet.py:BatchNorm2d``). At this shape the last stage is
    1x1, so n = 4 there, where torch's unbiased rule would be 4/3 off."""
    jmodel = jax_create_model("resnet18", dtype=jnp.float32)
    tx = optax.sgd(0.1, momentum=0.9)
    jstate = jax_cnn_state(jmodel, jax.random.PRNGKey(3), 32, tx)
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    model = create_model("resnet18")
    model.load_state_dict(state_dict_from_flax("resnet18", variables))
    rng = np.random.default_rng(11)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, 4)
    jstate2, jmetrics = jax.jit(jax_train.make_train_step(jmodel, tx))(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    state = TrainState(step=0, model=model.train(),
                       optimizer=flat_tx(sgd(0.1, momentum=0.9))(
                           model.parameters()))
    bns = [name for name, mod in model.named_modules()
           if isinstance(mod, torch.nn.BatchNorm2d)]
    metrics = make_train_step(model, state.optimizer)(
        state, torch.from_numpy(images).permute(0, 3, 1, 2),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    new = state_dict_from_flax("resnet18", jax.tree.map(
        np.asarray, {"params": jstate2.params,
                     "batch_stats": jstate2.batch_stats}))
    got = model.state_dict()
    assert len(bns) == 20
    for bn in bns:
        assert_close(got[f"{bn}.running_mean"], new[f"{bn}.running_mean"]
                     .numpy(), 1e-5)
        assert_close(got[f"{bn}.running_var"], new[f"{bn}.running_var"]
                     .numpy(), 1e-4)
