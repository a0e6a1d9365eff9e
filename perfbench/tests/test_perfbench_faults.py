"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and every other part of a run (set-up,
window, output check, result line) runs at CPU size, once for each fault
the cell can have. One chip has no exchange between chips to leave out."""
from __future__ import annotations

import importlib

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

CPU = torch.device("cpu")


def _line(cell, seconds: float = 1.0) -> dict:
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, 2**31 + 99, seconds, False, CPU)
    return run.result(cell, out, 0.0, False, "cpu", 1)


def _roll_logits(monkeypatch):
    """Every token the pool produces becomes another one: the logits that
    pick it are rolled by one along the vocabulary."""
    from idunno_tpu_torch.engine import serve_lm

    real = serve_lm.decode_apply

    def rolled(*args, **kw):
        return torch.roll(real(*args, **kw), 1, dims=-1)
    monkeypatch.setattr(serve_lm, "decode_apply", rolled)


def _frozen_pool(monkeypatch):
    """From the window's start, a decode dispatch that returns the pool's
    state unchanged (set-up's warm-up still drains)."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer

    from perfbench.harness import Window

    real = Window.start

    def start(self):
        monkeypatch.setattr(DecodeServer, "_decode", lambda srv: None)
        return real(self)
    monkeypatch.setattr(Window, "start", start)


@pytest.mark.parametrize("name", ["gpt2-medium.chat", "gpt2-medium.decode"])
def test_served_token_altered_where_it_is_produced(monkeypatch, name):
    _roll_logits(monkeypatch)
    line = _line(tiny.cell(name))
    assert line["correct"] is False
    assert line["check"]["logit_gap_mean"]["value"] > \
        line["check"]["logit_gap_mean"]["limit"]


@pytest.mark.parametrize("name", ["gpt2-medium.chat", "gpt2-medium.decode"])
def test_pool_step_that_returns_its_state_unchanged(monkeypatch, name):
    _frozen_pool(monkeypatch)
    line = _line(tiny.cell(name, drain_seconds=0.5))
    assert line["correct"] is False
    assert line["check"]["unserved"]["value"] > 0


def test_image_answer_altered_where_it_is_produced(monkeypatch):
    from idunno_tpu_torch.engine import inference

    real = inference.top1_from_logits

    def least_likely(logits):
        _, prob = real(logits)
        idx = torch.argmin(logits, dim=-1).to(torch.int32)
        return idx, prob
    monkeypatch.setattr(inference, "top1_from_logits", least_likely)
    line = _line(tiny.cell("vit-s16.bulk"))
    assert line["correct"] is False


def test_train_step_that_returns_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    line = _line(tiny.cell("gpt2-medium.train"))
    assert line["correct"] is False
    assert line["check"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_step_that_leaves_half_its_batch_out(monkeypatch):
    from idunno_tpu_torch.engine import train_lm

    real = train_lm.next_token_loss

    def half(logits, tokens):
        b = tokens.shape[0] // 2
        return real(logits[:b], tokens[:b])
    monkeypatch.setattr(train_lm, "next_token_loss", half)
    line = _line(tiny.cell("gpt2-medium.train"))
    assert line["correct"] is False
    assert line["check"]["grad_gap"]["value"] > \
        line["check"]["grad_gap"]["limit"]
