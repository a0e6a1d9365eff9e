"""The port's LM bench suites (``idunno_tpu_torch/utils/lm_bench.py``)
against the JAX package's (``idunno_tpu/utils/lm_bench.py``) on the CPU,
at the JAX test's ``TINY`` sizes (``tests/test_lm_bench.py``).

The numbers mean nothing here; these tests pin the configuration, the
record shape (every suite's record has the JAX record's keys, with no
``error`` anywhere) and the counts that follow from the workload and the
cache rather than from the weights: the prefix suite's prefill tokens and
radix hits equal the JAX suite's.
"""
import random
import time

import numpy as np
import pytest

import idunno_tpu.utils.lm_bench as jax_bench
import idunno_tpu_torch.utils.lm_bench as lb
from idunno_tpu_torch.bench import find_errors

TINY = {
    "BENCH_LM_DIM": "64", "BENCH_LM_DEPTH": "1", "BENCH_LM_HEADS": "2",
    "BENCH_LM_VOCAB": "128", "BENCH_LM_SLOTS": "2", "BENCH_LM_PROMPT": "8",
    "BENCH_LM_MAXNEW": "16", "BENCH_LM_MAXLEN": "64",
    "BENCH_LM_DECODE_STEPS": "4", "BENCH_LM_PREFILL_BATCH": "2",
    "BENCH_LM_PREFILL_SEQ": "32", "BENCH_LM_DRAFT_DIM": "32",
    "BENCH_LM_DRAFT_DEPTH": "1", "BENCH_LM_GQA_KV_HEADS": "1",
    "BENCH_LM_TRAINED_DIM": "32", "BENCH_LM_TRAINED_DEPTH": "1",
    "BENCH_LM_TRAINED_DRAFT_DIM": "16", "BENCH_LM_TRAINED_STEPS": "6",
}
# a few overrides the JAX config reads that TINY leaves alone
ODD = dict(TINY, BENCH_LM_DRAFT_LEN="3", BENCH_LM_PREFILL_TILE="2",
           BENCH_LM_TRAINED_DRAFT_DEPTH="2")

# each suite's JAX record at TINY on the CPU: its top-level keys, and the
# keys of its headline sub-record (idunno_tpu/utils/lm_bench.py)
JAX_KEYS = {
    "run_lm_bench": (
        {"config", "platform", "device_kind", "n_devices", "n_params",
         "param_bytes", "prefill", "flash_attention", "decode_compile_s",
         "decode", "speculative", "int8_decode", "gqa_decode",
         "decode_slots_scaling", "speculative_trained"},
        "decode", {"tokens_per_s", "slots", "decode_steps",
                   "timed_dispatches", "dispatch_s",
                   "implied_weight_stream_gbps"}),
    "run_lm_slots_bench": (
        {"config", "platform", "device_kind", "n_devices", "n_params",
         "slots_curve", "blessed", "best"},
        "best", {"slots", "tokens_per_s"}),
    "run_lm_prefix_bench": (
        {"config", "platform", "device_kind", "n_devices", "kv_block_size",
         "n_params", "param_bytes", "workload", "cache_on", "cache_off",
         "speedup_vs_off", "prefill_tokens_ratio"},
        "cache_on", {"tokens_per_s", "drain_s", "tokens_generated",
                     "prefill_tokens", "dispatches", "prefix_cache"}),
    "run_lm_cluster_prefix_bench": (
        {"config", "platform", "device_kind", "n_devices", "kv_block_size",
         "n_params", "workload", "publisher", "baseline", "cold", "warmed",
         "suffix_prefill_fraction", "cold_suffix_prefill_fraction",
         "ring_bytes_fetched"},
        "warmed", {"ttft_s", "prefill_tokens", "warm_s", "warm_blocks",
                   "tokens_per_s", "drain_s", "tokens_generated"}),
    "run_lm_paged_bench": (
        {"config", "platform", "device_kind", "n_devices", "kv_block_size",
         "n_params", "points", "best"},
        "best", {"slots", "context", "tokens_per_s"}),
    "run_lm_gateway_bench": (
        {"config", "platform", "device_kind", "n_devices", "n_requests",
         "n_params", "capacity", "overload", "underload"},
        "overload", {"offered", "offered_rps", "goodput_rps",
                     "tokens_per_s", "shed_rate", "offer_s", "total_s",
                     "classes", "queue_wait_s", "load_multiple"}),
    "run_lm_autoscale_bench": (
        {"config", "platform", "device_kind", "n_devices", "n_requests",
         "n_params", "capacity", "ramp", "overload", "underload",
         "overload_scaled", "autoscale"},
        "overload_scaled", {"offered", "tokens_per_s", "shed_rate",
                            "load_multiple", "replicas"}),
    "run_lm_distserve_bench": (
        {"config", "platform", "device_kind", "n_devices", "workload",
         "n_params", "handoff", "role_split", "colocated",
         "decode_interference", "predictive"},
        "handoff", {"completed_longs", "ticks", "wall_s", "tokens_generated",
                    "tokens_per_s", "ttft_p50_s", "ttft_max_s", "itl_p50_ms",
                    "itl_p95_ms", "itl_samples", "prefill_contaminated_steps",
                    "handoff_ships", "handoff_bytes", "handoff_fallbacks"}),
    "run_lm_gray_bench": (
        {"config", "platform", "device_kind", "n_devices", "workload",
         "n_params", "decode", "hedged", "baseline", "quarantine",
         "p99_cut"},
        "hedged", {"polls", "wall_s", "rows_delivered", "tokens_per_s",
                   "p50_ms", "p95_ms", "p99_ms", "detect_poll", "health",
                   "hedged_rpcs", "hedge_wins"}),
}


@pytest.fixture
def tiny_env(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)


def _clear_env(monkeypatch):
    for k in list(ODD):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("env", [{}, TINY, ODD], ids=["default", "tiny",
                                                       "odd"])
def test_cpu_config_equals_jax(monkeypatch, env):
    _clear_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, ref = lb.lm_bench_config("cpu"), jax_bench.lm_bench_config("cpu")
    assert mine.keys() == ref.keys()
    assert ({k: v for k, v in mine.items() if k != "prefill_tile"}
            == {k: v for k, v in ref.items() if k != "prefill_tile"})
    assert mine["prefill_tile"] == int(env.get("BENCH_LM_PREFILL_TILE", 1))


def test_default_config_is_the_full_width_tpu_config(monkeypatch):
    """No argument is the card's config: the JAX bench's TPU widths
    (prefill_tile aside, PREFILL_TILE_NOTE), which chip_smoke.py serves."""
    _clear_env(monkeypatch)
    cfg = lb.lm_bench_config()
    assert cfg == lb.lm_bench_config("cuda")
    assert (cfg["dim"], cfg["depth"], cfg["heads"], cfg["vocab"]) == (
        1024, 12, 16, 32768)
    ref = jax_bench.lm_bench_config("tpu")
    assert cfg["prefill_tile"] == 1 and ref["prefill_tile"] == 4
    assert ({k: v for k, v in cfg.items() if k != "prefill_tile"}
            == {k: v for k, v in ref.items() if k != "prefill_tile"})


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_default_config_phases_fit_serving_limits(platform, monkeypatch):
    """The shipped defaults keep every phase admissible (the JAX test's
    guards, against the port's helpers)."""
    _clear_env(monkeypatch)
    cfg = lb.lm_bench_config(platform)
    assert cfg["prompt_len"] + cfg["max_new"] <= cfg["max_len"]
    assert lb.spec_max_new(cfg) > cfg["draft_len"] + 1
    assert (lb.spec_max_new(cfg) - 1
            > lb.spec_rounds(cfg) * (cfg["draft_len"] + 1))
    assert cfg["max_new"] >= 2 * cfg["decode_steps"] + 1
    assert cfg["heads"] % max(cfg["gqa_kv_heads"], 1) == 0
    assert cfg["dim"] % cfg["heads"] == 0
    assert lb.spec_rounds(cfg) == jax_bench.spec_rounds(cfg)
    assert lb.spec_max_new(cfg) == jax_bench.spec_max_new(cfg)


@pytest.mark.parametrize("suite", sorted(JAX_KEYS))
def test_suite_record_has_the_jax_keys(tiny_env, monkeypatch, suite):
    # fewer open-loop requests: their offered rates follow the measured
    # capacity, so the phases' wall time is requests / capacity
    monkeypatch.setenv("BENCH_LM_AS_REQUESTS", "8")
    monkeypatch.setenv("BENCH_LM_GW_REQUESTS", "12")
    rec = getattr(lb, suite)("cpu", "cpu", 1, None,
                             deadline=time.perf_counter() + 600)
    top, head, head_keys = JAX_KEYS[suite]
    assert top <= rec.keys(), top - rec.keys()
    assert head_keys <= rec[head].keys(), head_keys - rec[head].keys()
    assert not find_errors(rec), find_errors(rec)
    assert rec["platform"] == "cpu" and rec["n_params"] > 0
    assert rec["config"]["prefill_tile"] == 1
    value = rec[head].get("tokens_per_s")
    assert value is not None and value > 0, rec[head]


def test_lm_record_points(tiny_env):
    """The full lm record's points hold their JAX bounds: the zero-weight
    ceiling commits more than 1.5 tokens a round, the trained pair trains
    the JAX step counts, the slot-scaling pool is 4x, and the flash
    backward runs on the CPU through its plain versions."""
    rec = lb.run_lm_bench("cpu", "cpu", 1, None,
                          deadline=time.perf_counter() + 600)
    assert rec["flash_attention"] == "n/a (cpu)"
    assert rec["prefill"]["scan_tile"] == 1
    assert rec["flash_bwd"]["status"] == "plain (cpu)"
    assert rec["speculative"]["avg_commit_per_round"] > 1.5
    assert rec["gqa_decode"]["kv_heads"] == 1
    assert rec["decode_slots_scaling"]["slots"] == 8
    tr = rec["speculative_trained"]
    assert tr["train_steps"] == {"target": 6, "draft": 2}
    assert 1.0 <= tr["avg_commit_per_round"] <= tr["draft_len"] + 1
    # the K3 arm beside the contiguous headline
    assert rec["paged_k3"]["tokens_per_s"] > 0
    assert rec["paged_k3"]["kv_block_size"] == 4


@pytest.mark.parametrize("how", ["compact", "deadline"])
def test_compact_and_deadline_skip_the_optional_points(tiny_env, how):
    rec = lb.run_lm_bench(
        "cpu", "cpu", 1, None, compact=how == "compact",
        deadline=time.perf_counter() + (600 if how == "compact" else -1))
    for k in ("speculative", "int8_decode", "gqa_decode",
              "decode_slots_scaling", "speculative_trained"):
        assert k not in rec
    assert "xla_full_attention" not in rec["prefill"]
    assert rec["decode"]["tokens_per_s"] > 0


def test_prefix_suite_counts_equal_jax(tiny_env):
    """The cache-on and cache-off admissions prefill the same number of
    tokens, and the radix cache hits as often, as the JAX suite's on the
    same workload: they follow from the shared prompts and the cache, not
    from the weights."""
    mine = lb.run_lm_prefix_bench("cpu", "cpu", 1, None,
                                  deadline=time.perf_counter() + 600)
    ref = jax_bench.run_lm_prefix_bench("cpu", "cpu", 1, None,
                                        deadline=time.perf_counter() + 600)
    assert mine["workload"] == ref["workload"]
    assert mine["prefill_tokens_ratio"] == ref["prefill_tokens_ratio"] < 1
    for side in ("cache_on", "cache_off"):
        for k in ("prefill_tokens", "tokens_generated", "dispatches"):
            assert mine[side][k] == ref[side][k], (side, k)
    pc, rpc = mine["cache_on"]["prefix_cache"], ref["cache_on"]["prefix_cache"]
    for k in ("lookups", "hits", "cached_tokens_saved", "prefix_hit_rate"):
        assert pc[k] == rpc[k], k
    assert "prefix_cache" not in mine["cache_off"]
    # the K3 arm reads the same hits in place: the same admission work
    for k in ("prefill_tokens", "tokens_generated", "dispatches"):
        assert mine["paged_k3"][k] == mine["cache_on"][k], k
    assert mine["paged_k3"]["prefix_cache"]["hits"] == pc["hits"]


class _Stop(BaseException):
    """Ends a suite at its first pool (a BaseException, which the suites'
    ``except Exception`` recorders let through)."""


# the pool of each suite's headline: the first DecodeServer it builds
POOL_SUITES = ["run_lm_bench", "run_lm_slots_bench", "run_lm_prefix_bench",
               "run_lm_cluster_prefix_bench", "run_lm_gateway_bench",
               "run_lm_autoscale_bench", "run_lm_distserve_bench",
               "run_lm_gray_bench"]
POOL_KEYS = ("slots", "prompt_len", "max_len", "decode_steps",
             "prompt_buckets", "kv_block_size", "kv_cache_blocks",
             "paged_kernel", "quantize", "draft")


def _headline_pool(monkeypatch, module: str, suite) -> dict:
    """The pool keywords of the first ``DecodeServer`` that ``suite``
    builds, ``module``'s class replaced by a recorder that stops it."""
    seen = []

    def recorder(*args, **kw):
        seen.append(kw)
        raise _Stop

    monkeypatch.setattr(f"{module}.DecodeServer", recorder)
    with pytest.raises(_Stop):
        suite("cpu", "cpu", 1, None, deadline=time.perf_counter() + 600)
    pool = {k: seen[0].get(k) for k in POOL_KEYS}
    pool["kv_block_size"] = pool["kv_block_size"] or 0
    pool["kv_cache_blocks"] = pool["kv_cache_blocks"] or 0
    return pool


@pytest.mark.parametrize("suite", POOL_SUITES)
def test_headline_pool_equals_jax_suite(tiny_env, monkeypatch, suite):
    """Each suite's headline serves from the JAX suite's own pool: the
    contiguous cache, or a block pool whose radix hits are gathered (no
    ``paged_kernel``), with the same block size and block count; the K3
    pool is an extra arm (``paged_k3``), never the headline."""
    mine = _headline_pool(monkeypatch, "idunno_tpu_torch.engine.serve_lm",
                          getattr(lb, suite))
    ref = _headline_pool(monkeypatch, "idunno_tpu.engine.serve_lm",
                         getattr(jax_bench, suite))
    assert mine == ref
    assert mine["paged_kernel"] is None
    gathered = {"run_lm_prefix_bench", "run_lm_cluster_prefix_bench",
                "run_lm_distserve_bench"}
    assert (mine["kv_block_size"] > 0) == (suite in gathered)


def test_tp_suite_raises_naming_roadmap(tiny_env, monkeypatch):
    """The ``lm_tp`` suite, once a refusal naming ROADMAP.md, measures
    n_model 1 against 2 (a virtual mesh on the CPU) with the JAX suite's
    record keys and an exactness probe on every TP point."""
    monkeypatch.setenv("BENCH_LM_TP_GRID", "1:2,2:2")
    rec = lb.run_lm_tp_bench("cpu", "cpu", 1, None,
                             deadline=time.perf_counter() + 600)
    one, two = rec["points"]
    assert (one["n_model"], two["n_model"]) == (1, 2)
    # bf16 pools: the probe is reported, not promised (the row shards'
    # partial sums round apart from one whole product)
    assert isinstance(two["token_exact_vs_1"], bool)
    assert two["tp_collective_bytes"] > 0
    assert one["tp_collective_bytes"] == 0 and "speedup_vs_1" in two
    assert rec["best"]["n_model"] == 2
    assert lb.lm_tp_grid("cuda") == [(1, 2), (2, 2)]   # the env override


def test_bless_slots_equals_jax():
    curve = [{"slots": 16, "tokens_per_s": 3000.0},
             {"slots": 32, "tokens_per_s": 5200.0},
             {"slots": 64, "tokens_per_s": 9100.0}]
    for frac in (None, 0.3, 0.5, 0.9):
        assert lb.bless_slots(curve, frac) == jax_bench.bless_slots(curve,
                                                                    frac)


def test_predictive_record_equals_jax():
    """The scripted forecast runs the copied Holt filter: the same series
    and trigger ticks as the JAX package's."""
    assert (lb.predictive_scale_ahead_record()
            == jax_bench.predictive_scale_ahead_record())


def test_loadgen_schedule_equals_the_tool_and_probe_decides():
    """``utils/loadgen.py``'s Poisson schedule is the JAX tool's for the
    same seed; its repaired ``PolicyProbe`` lets the real autoscaler
    spawn at overload and drain at underload."""
    import sys

    sys.path.insert(0, jax_bench.__file__.rsplit("/idunno_tpu/", 1)[0])
    from tools.gateway_load import poisson_schedule as tool_schedule

    from idunno_tpu_torch.utils.loadgen import (poisson_schedule,
                                                probe_decisions)
    assert (poisson_schedule(7.5, 40, random.Random(3))
            == tool_schedule(7.5, 40, random.Random(3)))
    out = probe_decisions({"ramp": 0.01, "overload": 2.0,
                           "underload": 0.001}, slack_s=0.5)
    actions = [d["action"] for d in out["decisions"]]
    assert actions[0] == "spawn" and "retire_start" in actions
    assert "retire" in actions


def test_trace_hook_writes_one_traced_step(monkeypatch, tmp_path):
    """BENCH_TRACE=1 with a trace name runs one extra step under the
    profiler into ``.trace/<name>`` (here redirected to a scratch dir)."""
    import gzip
    import json
    import os

    import torch

    from idunno_tpu_torch.utils import train_bench

    monkeypatch.setenv("BENCH_TRACE", "1")
    monkeypatch.setattr(lb, "trace_dir",
                        lambda name: str(tmp_path / name))
    calls = []

    def step(state, x):
        calls.append(1)
        return {"loss": (x * 2).sum()}

    med, first, loss = train_bench._timed_steps(
        step, None, (torch.ones(3),), 2, trace_name="unit")
    assert len(calls) == 4 and loss == 6.0 and med >= 0 and first >= 0
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
               for f in fs]
    with gzip.open(path, "rt") as f:
        assert any(e.get("name") == "aten::mul"
                   for e in json.load(f)["traceEvents"])
    monkeypatch.setenv("BENCH_TRACE", "0")
    train_bench._timed_steps(step, None, (torch.ones(3),), 1,
                             trace_name="off")
    assert not (tmp_path / "off").exists()


def test_markov_corpus_equals_jax():
    a = lb._markov_corpus(np.random.default_rng(42), 4, 32, 97)
    b = jax_bench._markov_corpus(np.random.default_rng(42), 4, 32, 97)
    assert np.array_equal(a, b)
