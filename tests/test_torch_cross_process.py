"""Sequence, pipeline and expert parallelism across processes, on the CPU:
``idunno_tpu_torch/dryrun.py:cross_process_check("cpu", processes=2,
groups=2)`` (two gloo processes of two groups each, an axis of 4; its
CPU shapes: vocab 64, dim 64, depth 2 (4 for the pipeline), 4 heads, seq
64) from the JAX package's initial weights carried across with
``models/convert.py``, held against the JAX package on the conftest's
eight host devices, under ``jax.jit``:

- ring and Ulysses attention (causal, f32) on a (4, 1) mesh: the
  processes' output slices, joined, and their q/k/v gradients within
  1e-5;
- the sequence-parallel LM step (ring, Adam 1e-2) against JAX's
  ``jit_lm_train_step(sequence_parallel=True)``: the logits before the
  steps and the first step's gradients (against ``jax.grad`` of the
  same loss) within 1e-5 of the largest, three steps' losses within rtol
  1e-5 and the parameters after them within ``UPDATE_GAP`` of each
  tensor's largest move;
- the pipelined LM over a (1, 4) stage mesh: logits and loss within
  1e-5 of JAX ``make_pipelined_lm_apply``'s;
- the routed LM (8 experts on every other block, capacity factor 2) over
  a 4-shard expert mesh: the processes' logits, joined, and CE + 0.01·aux
  within 1e-5 of JAX ``MoETransformerLM(mesh=)``'s.

A second check runs one group a process (an axis of 2, every hop
crossing processes). Each process also holds its runs against the port's
in-process axis (the record's gates): the ring, Ulysses and pipeline outputs (the
pipelined LM's logits and ``pipeline_apply``'s output, which reaches
both processes) and the expert layer's output (``expert_parallel_apply``
on the same tokens and gates) equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

from idunno_tpu.engine import pipeline_lm as jax_pp
from idunno_tpu.engine import train as jax_train
from idunno_tpu.engine import train_lm as jax_train_lm
from idunno_tpu.models.moe import MoETransformerLM as JaxMoELM
from idunno_tpu.models.moe import moe_aux_loss as jax_moe_aux_loss
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu.parallel.expert import EXPERT_AXIS as JAX_EXPERT_AXIS
from idunno_tpu.parallel.mesh import make_mesh as jax_make_mesh
from idunno_tpu.parallel.pipeline import STAGE_AXIS as JAX_STAGE_AXIS
from idunno_tpu.parallel.ring_attention import ring_attention as jax_ring
from idunno_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from idunno_tpu_torch.dryrun import cross_config, cross_process_check
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from tests.torch_workers import share_cores  # noqa: F401

CFG = cross_config("cpu")
P = 4
# Adam moves an element by about lr a step whatever the size of its
# gradient, so where a gradient is small the rounding of sums taken in
# another order (over processes, or by XLA) sets part of the move; at
# these widths (dim 64, depth 2) that is past the ring test's 1e-4 rule
# for the port's one-process step too. The parameters are held within
# this share of each tensor's largest move (chip_smoke.py's
# EP["update_gap"]), beside the first step's gradients within 1e-5 of
# each tensor's largest.
UPDATE_GAP = 0.1


def close(got, want, tol=1e-5, what=""):
    """|got - want| within ``tol`` of the reference's largest magnitude."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * float(np.abs(want).max()))


def lm_kw(depth):
    return dict(vocab=CFG["vocab"], dim=CFG["dim"], depth=depth,
                num_heads=CFG["heads"])


def moe_kw():
    return dict(lm_kw(CFG["depth"]), n_experts=CFG["n_experts"],
                moe_every=2, capacity_factor=CFG["capacity_factor"])


def init_params(model, seq, seed):
    return jax.jit(model.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, seq), jnp.int32))["params"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX initial weights, the check's records and each process's
    saved outputs."""
    tmp = tmp_path_factory.mktemp("cross_process")
    params = {"lm": init_params(JaxLM(**lm_kw(CFG["depth"])), 8, 0),
              "pp": init_params(JaxLM(**lm_kw(CFG["pp_depth"])), 8, 1),
              "moe": init_params(JaxMoELM(**moe_kw()), 8, 2)}
    torch.save({k: lm_state_dict_from_flax(np_tree(v))
                for k, v in params.items()}, tmp / "init.pt")
    recs = cross_process_check("cpu", processes=2, groups=2,
                               init=str(tmp / "init.pt"), out_dir=str(tmp),
                               timeout=240)
    outs = [torch.load(tmp / f"process{i}.pt") for i in range(2)]
    return params, recs, outs


def joined(outs, key, dim=0):
    return torch.cat([o[key] for o in outs], dim=dim)


def test_records_hold_the_in_process_axis(run):
    """Both processes' gates hold: outputs equal to the in-process axis of
    4 where the arithmetic is the same, the steps' losses, gradients and
    updates within the record's tolerances; every crossing went through
    the transport (ring hops, all-to-alls, pipeline hops), nothing staged
    on the CPU."""
    _, recs, outs = run
    assert [r["process"] for r in recs] == [0, 1]
    for r in recs:
        assert r["ok"], r["failed"]
        assert r["backend"] == "gloo" and r["axis"] == P
        assert r["ring_attention"]["out_equal"]
        assert r["ulysses_attention"]["out_equal"]
        assert r["pipeline_apply"]["out_equal"]
        assert r["ep_step"]["expert_layer_equal"]
        assert r["ring_attention"]["transport"]["hops"] > 0
        assert r["ulysses_attention"]["transport"]["exchanges"] > 0
        assert r["stage_step"]["transport"]["hops"] > 0
        assert r["ep_step"]["transport"]["exchanges"] > 0
        assert all(r[k]["transport"]["bytes_staged"] == 0 for k in
                   ("ring_attention", "sp_step", "stage_step", "ep_step"))
    # pipeline_apply's output reaches every process
    assert torch.equal(outs[0]["pipeline_apply_out"],
                       outs[1]["pipeline_apply_out"])
    # the pipeline's logits live with the last stage
    assert "logits_equal" not in recs[0]["stage_step"]
    assert recs[1]["stage_step"]["logits_equal"]
    # each process keeps only its own stages' weights
    assert recs[0]["stage_step"]["held_params"][0] == "embed.weight"
    assert recs[1]["stage_step"]["held_params"][0] == "head.bias"


def test_attention_matches_jax(run, eight_devices):
    _, _, outs = run
    b, t, h = CFG["batch"], CFG["seq"], CFG["heads"]
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal((b, t, h, CFG["dim"] // h))
                   .astype(np.float32) for _ in range(4))
    jmesh = jax_make_mesh(P, 1, devices=eight_devices[:P])
    for name, fn in (("ring", jax_ring), ("ulysses", jax_ulysses)):
        @jax.jit
        def both(q, k, v, do, fn=fn):
            out, vjp = jax.vjp(functools.partial(fn, mesh=jmesh, causal=True),
                               q, k, v)
            return out, vjp(do)

        want, grads = both(q, k, v, do)
        close(joined(outs, f"{name}_out", 1), want, what=name)
        for x, g in zip("qkv", grads):
            close(joined(outs, f"{name}_d{x}", 1), g, what=f"{name} d{x}")


def test_sequence_parallel_step_matches_jax(run, eight_devices):
    params, _, outs = run
    jmesh = jax_make_mesh(P, 1, devices=eight_devices[:P])
    jm = JaxLM(**lm_kw(CFG["depth"]),
               attn_fn=functools.partial(jax_ring, mesh=jmesh))
    toks = np.random.default_rng(21).integers(
        0, CFG["vocab"], (CFG["batch"], CFG["seq"]))
    close(joined(outs, "sp_logits", 1),
          jax.jit(jm.apply)({"params": params["lm"]}, jnp.asarray(toks)))
    tx = optax.adam(CFG["lr"])
    jstate = jax_train.shard_train_state(jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params["lm"], batch_stats={},
        opt_state=tx.init(params["lm"])), jmesh)
    jstep = jax_train_lm.jit_lm_train_step(jm, tx, jmesh,
                                           sequence_parallel=True)
    jtoks = jax.device_put(jnp.asarray(toks), NamedSharding(
        jmesh, PartitionSpec(None, "data")))
    losses = []
    for _ in range(CFG["steps"]):
        jstate, metrics = jstep(jstate, jtoks)
        losses.append(float(metrics["loss"]))
    for o in outs:
        np.testing.assert_allclose(o["sp_losses"].numpy(), losses, rtol=1e-5)

    def loss_fn(prm, t):
        return jax_train_lm.next_token_loss(
            JaxLM(**lm_kw(CFG["depth"])).apply({"params": prm}, t), t)[0]

    grads = lm_state_dict_from_flax(np_tree(jax.jit(jax.grad(loss_fn))(
        params["lm"], jnp.asarray(toks))))
    init = lm_state_dict_from_flax(np_tree(params["lm"]))
    want = lm_state_dict_from_flax(np_tree(jstate.params))
    for name, w in want.items():
        close(outs[0][f"sp_grad.{name}"], grads[name].numpy(), what=name)
        got = outs[0][f"sp_param.{name}"]
        assert torch.equal(got, outs[1][f"sp_param.{name}"]), name
        update = float((w - init[name]).abs().max())
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=UPDATE_GAP * update, err_msg=name)


def test_pipelined_lm_matches_jax(run, eight_devices):
    params, _, outs = run
    depth, m = CFG["pp_depth"], CFG["microbatches"]
    jmesh = JaxMesh(np.asarray(eight_devices[:P]), (JAX_STAGE_AXIS,))
    jm = JaxLM(**lm_kw(depth))
    apply_fn = jax_pp.make_pipelined_lm_apply(jm, jmesh, m)
    toks = jnp.asarray(np.random.default_rng(22).integers(
        0, CFG["vocab"], (CFG["pp_batch"], CFG["pp_seq"])))

    @jax.jit
    def logits_and_loss(pp_params, tokens):
        logits = apply_fn(pp_params, tokens)
        return logits, jax_train_lm.next_token_loss(logits, tokens)[0]

    logits, loss = logits_and_loss(
        jax_pp.partition_lm_params(params["pp"], depth, P), toks)
    assert "stage_logits" not in outs[0]
    close(outs[1]["stage_logits"], logits)
    assert float(outs[1]["stage_loss"]) == pytest.approx(float(loss),
                                                         rel=1e-5)


def test_expert_parallel_lm_matches_jax(run, eight_devices):
    params, _, outs = run
    jm = JaxMoELM(**moe_kw(), mesh=JaxMesh(np.asarray(eight_devices[:P]),
                                           (JAX_EXPERT_AXIS,)))
    toks = jnp.asarray(np.random.default_rng(23).integers(
        0, CFG["vocab"], tuple(CFG["ep_tokens"])))

    @jax.jit
    def logits_and_loss(prm, t):
        logits, upd = jm.apply({"params": prm}, t, mutable=["losses"])
        ce, _ = jax_train_lm.next_token_loss(logits, t)
        return logits, ce + 0.01 * jax_moe_aux_loss(upd)

    logits, loss = logits_and_loss(params["moe"], toks)
    close(joined(outs, "ep_logits"), logits)
    for o in outs:
        assert float(o["ep_loss"]) == pytest.approx(float(loss), rel=1e-5)


def test_one_group_a_process_holds_the_in_process_axis():
    """Two processes of one group each (an axis of 2, every hop crossing
    processes): each process's gates against the in-process axis hold,
    from seeded weights."""
    recs = cross_process_check("cpu", processes=2, groups=1, timeout=240)
    for r in recs:
        assert r["ok"] and r["axis"] == 2, r["failed"]
        assert r["ring_attention"]["out_equal"]
        assert r["stage_step"]["transport"]["hops"] > 0
