"""The harness's plumbing on the CPU: every part of a cell is found by
name, the traffic repeats under a seed and moves under another, the
result line holds the contract's keys and nothing of JAX may be loaded."""
from __future__ import annotations

import importlib
import json
import os
import re
import sys

import pytest
import torch

from perfbench import harness, run, spec, traffic
from perfbench.drivers import image_closed_loop, lm_open_loop, lm_train
from perfbench.tests import tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_every_part_of_a_cell_is_found_by_name(name):
    cell = spec.find_cell(name)
    assert importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}").run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e
    assert [k for k in cell.limits if not k.startswith("_")]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_chat_traffic_repeats_under_a_seed_and_moves_under_another():
    cell = spec.find_cell("gpt2-medium.chat")
    a = lm_open_loop.schedule(cell, 2**31 + 7, 10.0, 2.0)
    assert a == lm_open_loop.schedule(cell, 2**31 + 7, 10.0, 2.0)
    b = lm_open_loop.schedule(cell, 2**31 + 8, 10.0, 2.0)
    assert a[1] != b[1]
    # the same amount of work under every seed: arrivals, lengths, choices
    win_a = [r for r in a[1] if r[0] < 10.0]
    win_b = [r for r in b[1] if r[0] < 10.0]
    assert len(win_a) == len(win_b) == 42
    assert sorted(len(r[2]) for r in win_a) == sorted(len(r[2]) for r in win_b)
    assert sorted(r[3] for r in win_a) == sorted(r[3] for r in win_b)
    assert all(0 <= r[0] < 12.0 for r in a[1])


def test_arrival_gaps_are_the_same_multiset_for_every_seed():
    d1 = traffic.poisson_arrivals(5.0, 20.0, traffic.rng(1, "arrivals"))
    d2 = traffic.poisson_arrivals(5.0, 20.0, traffic.rng(2, "arrivals"))
    assert len(d1) == len(d2) == 100
    g1 = sorted(d1[1:] - d1[:-1]) + [d1[0]]
    g2 = sorted(d2[1:] - d2[:-1]) + [d2[0]]
    assert sorted(g1) == pytest.approx(sorted(g2))
    assert d1.tolist() != d2.tolist()


def test_markov_rows_and_images_repeat_under_a_seed():
    cell = tiny.cell("gpt2-medium.train")
    cpu = torch.device("cpu")
    a = lm_train.batches(cell, 5, cpu)
    assert torch.equal(a, lm_train.batches(cell, 5, cpu))
    assert not torch.equal(a, lm_train.batches(cell, 6, cpu))
    rows = a.reshape(-1, a.shape[-1])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    vit = tiny.cell("vit-s16.bulk")
    i = image_closed_loop.images(vit, 2**40, cpu)
    assert (i == image_closed_loop.images(vit, 2**40, cpu)).all()
    assert (i != image_closed_loop.images(vit, 2**40 + 1, cpu)).any()


def _outcome():
    out = harness.Outcome(end_to_end={"tokens_per_s": 12.5},
                          counters={"window_s": 1.0}, attempted=3)
    out.compared = [harness.Compared("logit_gap", 0.01, 0.1)]
    return out


def test_result_line_holds_the_contract_keys_and_the_check_last():
    cell = spec.find_cell("gpt2-medium.decode")
    line = run.result(cell, _outcome(), 4.5, False, "cpu", 1)
    assert set(line) - {"card"} == {"correct", "attempted", "failed",
                                    "metrics", "device", "check"}
    assert list(line)[-1] == "check"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "tokens_per_s"}
    assert line["metrics"]["tokens_per_s"] == {"value": 12.5,
                                               "unit": "tokens/s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["check"] == {"logit_gap": {"value": 0.01, "limit": 0.1}}
    json.dumps(line)


def test_a_number_beyond_its_limit_or_missing_is_not_correct():
    cell = spec.find_cell("gpt2-medium.decode")
    out = _outcome()
    out.compared = [harness.Compared("logit_gap", 0.2, 0.1)]
    assert run.result(cell, out, 1.0, False, "cpu", 1)["correct"] is False
    out.compared = harness.limits_check({"logit_gap": {"limit": 0.1}}, {})
    assert run.result(cell, out, 1.0, False, "cpu", 1)["correct"] is False


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib.xla", "flax", "idunno_tpu.engine"):
        monkeypatch.setitem(sys.modules, name, object())
        assert run.loaded_forbidden() == [name.split(".")[0]]
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "idunno_tpu_torch.engine", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.loaded_forbidden() == []


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "gpt2-medium.chat", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_fewer_cards_than_the_cell_asks_for_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "gpt2-medium.decode", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_the_harness_imports_nothing_of_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|idunno_tpu)"
                         r"(?:\s|\.|$)", re.M)
    for root, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert not pattern.search(text), f


def test_the_references_import_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "idunno_tpu" not in open(os.path.join(ref, f)).read(), f
