"""The control of each cell's output check: the plain reference in the
program's place, one precision below what the configuration states (fp8
matrix products for the bfloat16 served models, bfloat16 master weights
for the float32 ones of training). It has to come out not correct.

On the CPU at test size the control reads further from the reference than
the program does; on the card (marked ``gpu``), at the cell's own size, it
fails the cell's limits while the program passes them:

    python3 -m pytest perfbench/tests -m gpu
"""
from __future__ import annotations

import importlib

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

# the number each cell's control is held to
HELD = {"vit-s16.bulk": "prob_gap", "gpt2-medium.chat": "logit_gap_mean",
        "gpt2-medium.decode": "logit_gap_mean",
        "gpt2-medium.train": "update_gap"}


def _readings(cell, device, seconds):
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    return driver.run(cell, 2**31 + 5, seconds, False, device,
                      control=True).readings


@pytest.mark.parametrize("name", sorted(HELD))
def test_control_reads_further_than_the_program(name):
    r = _readings(tiny.cell(name), torch.device("cpu"), 1.0)
    key = HELD[name]
    assert r[f"control.{key}"] > r[key]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(HELD))
def test_control_fails_the_limits_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    cell = tiny.full(name)
    seconds = {"gpt2-medium.decode": 24.0}.get(name, 12.0)
    r = _readings(cell, torch.device("cuda", 0), seconds)
    program = harness.limits_check(cell.limits, r)
    control = harness.limits_check(
        cell.limits, {k[len("control."):]: v for k, v in r.items()
                      if k.startswith("control.")} | {
            k: v for k, v in r.items() if k == "unserved"})
    assert all(c.ok for c in program)
    assert not all(c.ok for c in control)
