"""``python -m idunno_tpu_torch.bench`` on the CPU: the one-line record
contract and its exit codes, and the helpers it shares with the
repository's ``bench.py``.

Runs as a subprocess at the JAX LM test's ``TINY`` sizes (and a batch of
8 for the cnn suite): ``--cpu`` prints exactly one JSON line in the record
shape and exits 0; without ``--cpu`` and without a card it exits
non-zero; a phase made to fail exits non-zero with the error in the line.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import bench as jax_bench
from idunno_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "BENCH_LM_DIM": "64", "BENCH_LM_DEPTH": "1", "BENCH_LM_HEADS": "2",
    "BENCH_LM_VOCAB": "128", "BENCH_LM_SLOTS": "2", "BENCH_LM_PROMPT": "8",
    "BENCH_LM_MAXNEW": "16", "BENCH_LM_MAXLEN": "64",
    "BENCH_LM_DECODE_STEPS": "4", "BENCH_LM_PREFILL_BATCH": "2",
    "BENCH_LM_PREFILL_SEQ": "32", "BENCH_LM_DRAFT_DIM": "32",
    "BENCH_LM_DRAFT_DEPTH": "1", "BENCH_LM_GQA_KV_HEADS": "1",
    "BENCH_LM_TRAINED_DIM": "32", "BENCH_LM_TRAINED_DEPTH": "1",
    "BENCH_LM_TRAINED_DRAFT_DIM": "16", "BENCH_LM_TRAINED_STEPS": "6",
    "BENCH_SWEEP": "8", "BENCH_BATCH": "8", "BENCH_NBATCH": "1",
    "BENCH_ITERS": "1",
}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


def run_bench(*args, **env) -> tuple[int, list[str], str]:
    """(exit code, stdout lines, stderr) of one bench run from the root of
    the repository; no file may appear at the root."""
    before = set(os.listdir(REPO))
    full = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    full.update(TINY, **env)
    proc = subprocess.run([sys.executable, "-m", "idunno_tpu_torch.bench",
                           *args], cwd=REPO, env=full, capture_output=True,
                          text=True, timeout=300)
    assert set(os.listdir(REPO)) <= before, set(os.listdir(REPO)) - before
    return proc.returncode, proc.stdout.strip().splitlines(), proc.stderr


@pytest.fixture
def no_card():
    """The exit-code test needs a machine without a card: decided here."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


@pytest.mark.parametrize("suite,flag", [("cnn", "--cpu"), ("lm", "env")])
def test_cpu_run_prints_one_record_and_exits_0(suite, flag):
    args, env = ((flag,), {}) if flag == "--cpu" else ((), {
        "BENCH_DEVICE": "cpu", "BENCH_LM_COMPACT": "1"})
    rc, lines, err = run_bench(*args, BENCH_SUITE=suite, **env)
    assert rc == 0 and len(lines) == 1, (rc, lines, err[-2000:])
    rec = json.loads(lines[0])
    assert LINE_KEYS <= rec.keys() and "error" not in rec
    assert rec["metric"] == bench.metric_name(suite, "resnet18")
    assert rec["value"] > 0
    d = rec["details"]
    assert not bench.find_errors(d)
    assert d["provenance"]["torch_version"] == torch.__version__
    assert "launches" not in d             # counted on the card only
    if suite == "cnn":
        assert rec["unit"] == "images/sec" and rec["vs_baseline"] > 0
        assert d["pallas_preprocess"] == "n/a (cpu)" and d["lm"] is None
        assert d["best_batch_size"] == 8 and d["sweep"][0]["images_per_s"] > 0
        assert d["e2e_worker_path_images_per_s"] > 0
    else:
        assert rec["unit"] == "tokens/sec" and rec["vs_baseline"] is None
        assert d["platform"] == "cpu" and d["flash_attention"] == "n/a (cpu)"
        assert "speculative" not in d and d["wall_s"] >= 0


def test_without_a_card_it_exits_non_zero(no_card):
    rc, lines, _ = run_bench(BENCH_SUITE="lm")
    assert rc != 0 and len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] is None and "no CUDA card" in rec["error"]


def test_a_failed_phase_exits_non_zero_with_its_error():
    """A draft longer than the cache leaves no room for the speculative
    rows: the speculative phases fail, the decode headline does not, and
    the run still exits non-zero with the errors in its line."""
    rc, lines, err = run_bench("--cpu", BENCH_SUITE="lm",
                               BENCH_LM_DRAFT_LEN="60")
    assert rc == 1 and len(lines) == 1, (rc, lines, err[-2000:])
    rec = json.loads(lines[0])
    assert rec["value"] > 0
    assert "error" in rec["details"]["speculative"]
    assert "details.speculative.error" in rec["error"]


def test_refused_suite_names_roadmap():
    """``lm_tp``, once refused naming ROADMAP.md, runs: one line, exit 0,
    the n_model 2 points beside n_model 1 with their exactness probe
    (CPU: a virtual mesh)."""
    rc, lines, err = run_bench("--cpu", BENCH_SUITE="lm_tp")
    assert rc == 0 and len(lines) == 1, (rc, lines, err[-2000:])
    rec = json.loads(lines[0])
    assert rec["value"] > 0 and "error" not in rec
    tp = [p for p in rec["details"]["points"] if p["n_model"] == 2]
    assert tp and all(isinstance(p["token_exact_vs_1"], bool) for p in tp)


@pytest.mark.parametrize("env", [{"BENCH_SUITE": "nope"},
                                 {"BENCH_MODEL": "resnet34"}])
def test_unknown_suite_or_model_is_a_usage_error(env):
    rc, lines, err = run_bench("--cpu", **env)
    assert rc == 2 and not lines and "want" in err


@pytest.mark.parametrize("model", ["resnet18", "resnet50", "alexnet", "vit",
                                   "vit_tiny"])
def test_flops_equal_the_repository_bench(model):
    assert (bench.model_forward_flops(model)
            == jax_bench.model_forward_flops(model) > 0)


def test_metric_names_and_peak():
    assert bench.metric_name("cnn", "resnet18") == jax_bench.METRIC
    assert bench.peak_bf16_for("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.peak_bf16_for("NVIDIA H100 PCIe") is None
    assert bench.peak_bf16_for("cpu") is None


def test_find_errors_names_each_path():
    rec = {"a": {"error": "x"}, "b": [{"c": {"error": "y"}}, {"ok": 1}],
           "d": {"error": None}}
    assert bench.find_errors(rec) == ["details.a.error: x",
                                      "details.b[0].c.error: y"]
