"""Cluster LM training jobs: a background trainer any node can run via RPC.

A port of ``idunno_tpu/engine/train_job.py``. The runner pulls a tokenized
corpus from the replicated store (``engine/data_lm.py``), drives the port's
LM train step (``engine/train_lm.py``) on the node's device, checkpoints
the full train state (model, optimizer moments, step) back into the store
on a cadence (``engine/checkpoint.py:save_train_state``; a crash resumes
from the last version), and on completion publishes the servable (config +
weights) LM object that ``lm_serve``/``generate`` load — so the whole
train → checkpoint → serve loop runs over the control RPC with no
out-of-band steps.

The model is ``TransformerLM(**model_config)`` with the JAX package's
field names on the wire (``dtype`` is the compute dtype, ``param_dtype``
the parameters'), attending with its default ``full_attention`` as the
JAX job's model does, and the optimizer ``flat_tx(adam(lr))``. The port
has one optimizer layout, so a checkpoint whose layout differs is an
error (``OptStateLayoutMismatch``), never a retry on another layout.

One thread per job; `status()` is safe from any thread.
"""
from __future__ import annotations

import threading
from typing import Any

import torch


class OptStateLayoutMismatch(ValueError):
    """A stored train state does not fit the job's model and optimizer:
    a parameter key or shape, a moment's shape or the parameter-group
    count differs (``engine/checkpoint.py:restore_train_state``)."""


# the JAX TransformerLM fields a job's model_config may carry (those
# `save_lm` stores); as in the JAX job, ``ffn_every`` without an FFN
# factory leaves every block dense
_FREE = ("vocab", "dim", "depth", "num_heads", "num_kv_heads", "causal",
         "ffn_every", "kv_cache_dtype", "remat", "dtype", "param_dtype")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"model_config dtype {name!r} is not a torch dtype")
    return dt


def model_kwargs(model_config: dict[str, Any]) -> dict[str, Any]:
    """The port's ``TransformerLM`` keyword arguments for a JAX-style
    ``model_config`` (the ``train_start`` wire form). Unknown fields
    raise."""
    kw: dict[str, Any] = {}
    for key, value in model_config.items():
        if key not in _FREE:
            raise ValueError(f"model_config has no field {key!r}")
        elif key == "dtype":
            kw["compute_dtype"] = _torch_dtype(value)
        elif key == "param_dtype":
            kw["dtype"] = _torch_dtype(value)
        else:
            kw[key] = value
    if kw.get("compute_dtype") == kw.get("dtype", torch.float32):
        kw.pop("compute_dtype", None)
    return kw


def _new_model(model_config: dict[str, Any], seed: int,
               device: torch.device):
    """The job's freshly initialised model on ``device``, seeded with
    flax's initialisers from ``seed`` (``engine/train.py:place``)."""
    from idunno_tpu_torch.engine.train import place
    from idunno_tpu_torch.models.transformer import TransformerLM

    gen = torch.Generator(device=device).manual_seed(int(seed))
    return place(TransformerLM(**model_kwargs(model_config)), gen, device)


class LMTrainJob:
    """Background training of a dense `TransformerLM` on one node."""

    def __init__(self, store, name: str, *, corpus: str,
                 model_config: dict[str, Any], steps: int,
                 batch_size: int = 8, seq_len: int = 32,
                 lr: float = 1e-2, checkpoint_every: int = 50,
                 seed: int = 0, resume: bool = False,
                 device: torch.device | str | None = None) -> None:
        from idunno_tpu_torch.engine.inference import resolve_device

        if steps < 1:
            raise ValueError(f"steps={steps}: must be >= 1")
        self.store = store
        self.name = name
        self.corpus = corpus
        self.model_config = dict(model_config)
        self.steps = steps
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.lr = lr
        self.checkpoint_every = checkpoint_every
        self.seed = seed
        self.resume = resume
        self.device = resolve_device(device)

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._state: dict[str, Any] = {
            "step": 0, "start_step": 0, "loss": None, "first_loss": None,
            "done": False, "stopped": False, "error": None,
            "checkpoint_version": None, "served_version": None,
        }
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"train-{name}")
        self._thread.start()

    # -- any thread -------------------------------------------------------

    def status(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._state)

    def stop(self, timeout: float = 10.0) -> None:
        """Request a graceful stop: the loop checkpoints and exits."""
        self._stop.set()
        self._thread.join(timeout=timeout)

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout=timeout)

    def _set(self, **kw) -> None:
        with self._lock:
            self._state.update(kw)

    # -- job thread -------------------------------------------------------

    def _run(self) -> None:
        try:
            self._train()
        except Exception as e:  # noqa: BLE001 - RPC-visible, not node-fatal
            self._set(error=f"{type(e).__name__}: {e}", done=False)

    def _train(self) -> None:
        from idunno_tpu_torch.engine.checkpoint import (restore_train_state,
                                                        save_train_state)
        from idunno_tpu_torch.engine.data_lm import TokenDataset, load_corpus
        from idunno_tpu_torch.engine.generate import save_lm
        from idunno_tpu_torch.engine.train import TrainState, adam, flat_tx
        from idunno_tpu_torch.engine.train_lm import make_lm_train_step

        tokens = load_corpus(self.store, self.corpus)
        model = _new_model(self.model_config, self.seed, self.device).train()
        state = TrainState(step=0, model=model,
                           optimizer=flat_tx(adam(self.lr))(
                               model.parameters()))
        if self.resume:
            state, _ = restore_train_state(self.store, self.name, state)
        start = int(state.step)
        self._set(step=start, start_step=start)
        step_fn = make_lm_train_step(model, state.optimizer)
        ds = TokenDataset(tokens, self.seq_len, seed=self.seed)

        step = start
        epoch = 0
        while step < self.steps and not self._stop.is_set():
            progressed = False
            for batch in ds.batches(self.batch_size, epoch):
                if step >= self.steps or self._stop.is_set():
                    break
                metrics = step_fn(state, torch.from_numpy(batch).to(
                    self.device, torch.int64))
                step += 1
                progressed = True
                loss = float(metrics["loss"])
                self._set(step=step, loss=loss)
                if step == start + 1:
                    self._set(first_loss=loss)
                if self.checkpoint_every and \
                        step % self.checkpoint_every == 0:
                    v = save_train_state(self.store, self.name, state)
                    self._set(checkpoint_version=v)
            epoch += 1
            if not progressed:
                raise ValueError(
                    f"corpus {self.corpus!r} yields no "
                    f"[{self.batch_size}, {self.seq_len + 1}] batches")

        v = save_train_state(self.store, self.name, state)
        if self._stop.is_set() and step < self.steps:
            self._set(checkpoint_version=v, stopped=True)
            return
        served = save_lm(self.store, self.name, model)
        self._set(checkpoint_version=v, served_version=served, done=True)
