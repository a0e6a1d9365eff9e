"""The port's cluster training job (``engine/train_job.py``), its corpus
(``engine/data_lm.py:save_corpus``/``load_corpus``) and its train-state
checkpoints (``engine/checkpoint.py``), on the CPU, against the JAX
package's job:

- a corpus round-trips through a store, in the JAX package's bytes;
- from the same initial parameters (the JAX job's, carried into the port
  through ``models/convert.py``) the two jobs draw equal batches, their
  per-step losses agree within LOSS_RTOL over 6 f32 steps and their
  published final parameters within PARAM_RTOL (per tensor, relative
  norm of the difference; the attention key biases, whose true gradient
  is zero, aside) and PARAM_ATOL (every element);
- a stopped job resumed from its checkpoint ends on a ``state_dict``
  ``torch.equal`` to an uninterrupted run's (a corpus of identical
  blocks, so every step sees the same batch in both runs; the
  counterpart of ``tests/test_lm_lifecycle.py::test_training_resume_is_exact``);
- a stored train state that does not fit the job raises
  ``OptStateLayoutMismatch``; a flax blob raises naming the format;
- a train state over the store's frame cap fails typed, naming the cap,
  and the job thread ends (the cap is patched small; the model stays
  small).

Small model, f32: dim 64, depth 2, 4 heads, vocab 64, seq 16, batch 4.
"""
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from idunno_tpu.engine import train_job as jax_train_job
from idunno_tpu.engine.data_lm import TokenDataset as JaxTokenDataset
from idunno_tpu.engine.data_lm import save_corpus as jax_save_corpus
from idunno_tpu.engine.generate import load_lm as jax_load_lm
from idunno_tpu.engine.train import flat_tx as jax_flat_tx
from idunno_tpu.engine.train_lm import create_lm_train_state
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu_torch.engine import train_job
from idunno_tpu_torch.engine.checkpoint import (restore_train_state,
                                                save_train_state,
                                                save_variables,
                                                train_state_name)
from idunno_tpu_torch.engine.data_lm import (TokenDataset, load_corpus,
                                             save_corpus)
from idunno_tpu_torch.engine.generate import load_lm
from idunno_tpu_torch.engine.train import TrainState, adam, flat_tx
from idunno_tpu_torch.engine.train_job import (LMTrainJob,
                                               OptStateLayoutMismatch)
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from tests.torch_workers import share_cores  # noqa: F401

CFG = {"vocab": 64, "dim": 64, "depth": 2, "num_heads": 4}
JOB = dict(batch_size=4, seq_len=16, lr=1e-2)
# per-step losses of the port's job against the JAX job's, 6 f32 steps
LOSS_RTOL = 1e-4
# final parameters after those steps: per tensor, the norm of the
# difference relative to the JAX tensor's norm ...
PARAM_RTOL = 1e-4
# ... and every element within PARAM_ATOL. Adam moves an element whose
# gradient is near zero by its rounding noise divided by the noise's own
# RMS: a step of up to about lr that either package takes its own way
# (one element of 16,384 in an MLP kernel moves 2.7e-4 apart here, the
# rest stay within 3e-5). The attention key biases are all such elements:
# softmax is invariant to the shift q·b_k they add to every score of a
# row, so their true gradient is 0; they are held only to PARAM_ATOL.
PARAM_ATOL = 1e-3

class MemStore:
    """The store surface the jobs use: versioned put/get of blobs."""

    def __init__(self):
        self.blobs: dict[str, list[bytes]] = {}
        self.lock = threading.Lock()

    def put_bytes(self, name, blob):
        with self.lock:
            self.blobs.setdefault(name, []).append(bytes(blob))
            return len(self.blobs[name])

    def get_bytes(self, name, version=None):
        with self.lock:
            vs = self.blobs[name]
            v = len(vs) if version is None else version
            return vs[v - 1], v


def corpus(seed: int, n: int = 4000) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, CFG["vocab"], size=n) \
        .astype(np.int32)


def repeating_corpus() -> np.ndarray:
    """Every (seq_len + 1)-token block the same: each batch of every epoch
    is the same tensor, whatever the shuffle."""
    pattern = np.random.default_rng(9).integers(0, CFG["vocab"], size=17)
    return np.tile(pattern, 64).astype(np.int32)


def finished(job, timeout=300.0) -> dict:
    job.join(timeout=timeout)
    st = job.status()
    assert st["error"] is None, st
    assert st["done"], st
    return st


def test_corpus_round_trip_in_the_jax_bytes():
    store, jstore = MemStore(), MemStore()
    toks = corpus(0, 1000)
    assert save_corpus(store, "corpus/a", toks) == 1
    jax_save_corpus(jstore, "corpus/a", toks)
    assert store.blobs["corpus/a"] == jstore.blobs["corpus/a"]
    got = load_corpus(store, "corpus/a")
    assert got.dtype == np.int32 and np.array_equal(got, toks)
    for epoch in range(2):
        a = list(TokenDataset(got, 16, seed=3).batches(4, epoch))
        b = list(JaxTokenDataset(toks, 16, seed=3).batches(4, epoch))
        assert len(a) == len(b) > 0
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


class _Recording:
    """Mixin: keep every per-step loss a job reports."""

    def _set(self, **kw):
        if "loss" in kw:
            self.losses.append(kw["loss"])
        super()._set(**kw)


class PortJob(_Recording, LMTrainJob):
    def __init__(self, *a, **kw):
        self.losses = []
        super().__init__(*a, **kw)


class JaxJob(_Recording, jax_train_job.LMTrainJob):
    def __init__(self, *a, **kw):
        self.losses = []
        super().__init__(*a, **kw)


def test_job_matches_the_jax_job_from_carried_weights(monkeypatch):
    seed = 0
    jm = JaxLM(**CFG)
    init = create_lm_train_state(jm, jax.random.PRNGKey(seed), JOB["seq_len"],
                                 jax_flat_tx(optax.adam(JOB["lr"])))
    carried = lm_state_dict_from_flax(jax.tree.map(np.asarray, init.params))

    def carried_model(model_config, seed, device):
        tm = TransformerLM(**train_job.model_kwargs(model_config))
        tm.load_state_dict(carried)
        return tm.to(device)

    monkeypatch.setattr(train_job, "_new_model", carried_model)
    store, jstore = MemStore(), MemStore()
    toks = corpus(1)
    save_corpus(store, "c", toks)
    jax_save_corpus(jstore, "c", toks)
    kw = dict(corpus="c", model_config=CFG, steps=6, checkpoint_every=3,
              seed=seed, **JOB)
    job = PortJob(store, "lm", device="cpu", **kw)
    jjob = JaxJob(jstore, "lm", **kw)
    st, jst = finished(job), finished(jjob)
    assert len(job.losses) == len(jjob.losses) == 6
    np.testing.assert_allclose(job.losses, jjob.losses, rtol=LOSS_RTOL)
    assert st["first_loss"] == job.losses[0] and st["step"] == 6
    assert st["checkpoint_version"] == 3    # steps 3 and 6, then the final
    assert st["served_version"] == 1
    _, jparams = jax_load_lm(jstore, "lm")
    want = lm_state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    got = load_lm(store, "lm", device="cpu").state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        if not k.endswith("attn.k.bias"):
            rel = float((got[k] - v).norm() / v.norm())
            assert rel <= PARAM_RTOL, (k, rel)


def test_stop_and_resume_equal_an_uninterrupted_run():
    store = MemStore()
    save_corpus(store, "rep", repeating_corpus())
    kw = dict(corpus="rep", model_config=CFG, checkpoint_every=2, seed=1,
              device="cpu", **JOB)
    job = LMTrainJob(store, "stopped", steps=10_000, **kw)
    deadline = time.time() + 120
    while time.time() < deadline and job.status()["step"] < 3:
        assert job.status()["error"] is None, job.status()
        time.sleep(0.01)
    job.stop(timeout=60)
    st = job.status()
    assert st["stopped"] and not st["done"] and st["error"] is None, st
    stopped_at = st["step"]
    assert stopped_at >= 3 and st["checkpoint_version"] is not None
    total = stopped_at + 3
    resumed = LMTrainJob(store, "stopped", steps=total, resume=True, **kw)
    rst = finished(resumed)
    assert rst["start_step"] == stopped_at and rst["step"] == total
    whole = finished(LMTrainJob(store, "whole", steps=total, **kw))
    assert whole["step"] == total
    a = load_lm(store, "stopped", device="cpu").state_dict()
    b = load_lm(store, "whole", device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b)
    # and the optimizer's moments: restore both final train states
    states = []
    for name in ("stopped", "whole"):
        model = TransformerLM(**CFG)
        tmpl = TrainState(0, model, flat_tx(adam(1e-2))(model.parameters()))
        states.append(restore_train_state(store, name, tmpl)[0])
    assert states[0].step == states[1].step == total
    sa, sb = (s.optimizer.state_dict()["state"] for s in states)
    assert sa.keys() == sb.keys() and len(sa) == len(list(model.parameters()))
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def small_state(**cfg):
    model = TransformerLM(**dict(CFG, **cfg))
    return TrainState(0, model, flat_tx(adam(1e-2))(model.parameters()))


def test_mismatched_train_state_raises_typed():
    store = MemStore()
    src = small_state()
    src.model(torch.zeros((1, 4), dtype=torch.int64)).sum().backward()
    src.optimizer.step()
    src.step = 1
    save_train_state(store, "j", src)
    with pytest.raises(OptStateLayoutMismatch, match="shape"):
        restore_train_state(store, "j", small_state(dim=32))
    with pytest.raises(OptStateLayoutMismatch, match="keys"):
        restore_train_state(store, "j", small_state(depth=1))
    # a moment whose shape is not its parameter's
    other = small_state()
    groups = [{"params": list(other.model.parameters())[:2]},
              {"params": list(other.model.parameters())[2:]}]
    other.optimizer = flat_tx(adam(1e-2))(groups)
    with pytest.raises(OptStateLayoutMismatch, match="parameter groups"):
        restore_train_state(store, "j", other)
    # the matching template restores it, step included
    ok, version = restore_train_state(store, "j", small_state())
    assert ok.step == 1 and version == 1
    # a weights checkpoint is not a train state; a flax blob is refused
    save_variables(store, "train/w", src.model)
    with pytest.raises(OptStateLayoutMismatch, match="no train state"):
        restore_train_state(store, "w", small_state())
    store.put_bytes(train_state_name("flax"), b"\x81\xa4flax")
    with pytest.raises(ValueError, match="format"):
        restore_train_state(store, "flax", small_state())
    # through the job: a resume of another architecture ends in the error
    save_corpus(store, "c", corpus(2))
    job = LMTrainJob(store, "j", corpus="c", model_config=dict(CFG, dim=32),
                     steps=3, resume=True, device="cpu", **JOB)
    job.join(timeout=60)
    st = job.status()
    assert st["error"].startswith("OptStateLayoutMismatch"), st
    assert not st["done"]


def test_oversized_train_state_fails_typed_naming_the_cap(monkeypatch):
    from idunno_tpu_torch.comm import net

    monkeypatch.setattr(net, "_MAX_FRAME", 1 << 17)
    store = MemStore()
    with pytest.raises(ValueError, match=r"comm/net\.py:_MAX_FRAME"):
        save_train_state(store, "big", small_state())
    assert train_state_name("big") not in store.blobs
    save_corpus(store, "c", corpus(3))
    job = LMTrainJob(store, "big", corpus="c", model_config=CFG, steps=5,
                     checkpoint_every=1, device="cpu", **JOB)
    job.join(timeout=60)
    assert not job._thread.is_alive()
    st = job.status()
    assert st["error"].startswith("ValueError") and "131,072" in st["error"]
    assert st["step"] == 1 and not st["done"], st
    assert train_state_name("big") not in store.blobs


def test_model_config_follows_the_jax_field_names():
    kw = train_job.model_kwargs({"vocab": 8, "dim": 16, "depth": 1,
                                 "num_heads": 2, "dtype": "bfloat16",
                                 "param_dtype": "float32",
                                 "remat": False, "ffn_every": 1})
    assert kw == {"vocab": 8, "dim": 16, "depth": 1, "num_heads": 2,
                  "compute_dtype": torch.bfloat16, "dtype": torch.float32,
                  "remat": False, "ffn_every": 1}
    assert "compute_dtype" not in train_job.model_kwargs({"dtype":
                                                          "float32"})
    # remat and ffn_every pass through to TransformerLM, as the JAX job's
    # TransformerLM(**model_config) takes them
    assert train_job.model_kwargs({"remat": True, "ffn_every": 2}) == {
        "remat": True, "ffn_every": 2}
    with pytest.raises(ValueError, match="no field"):
        train_job.model_kwargs({"scan_layers": True})
