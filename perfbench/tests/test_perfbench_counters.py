"""The counters of work, the peaks, the trace reduction and the readers
that turn them into per-layer metrics, on the CPU."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from perfbench import counters, peaks, readers, trace, weights
from perfbench.tests import tiny


def _cfg(name):
    return tiny.full({"vit-s16": "vit-s16.bulk",
                      "gpt2-medium": "gpt2-medium.decode"}[name]).config


def test_vit_s16_forward_is_the_literature_9_2_gflop():
    flops = counters.vit_forward_flops(_cfg("vit-s16"))
    assert flops == pytest.approx(9.2e9, rel=0.01)
    # patch embedding, 12 blocks of 197 tokens, head on the class token
    t, d = 197, 384
    block = 24 * t * d * d + 4 * t * t * d
    assert flops == 2 * 196 * 768 * d + 12 * block + 2 * d * 1000


def test_lm_counts_the_weights_that_enter_a_product():
    cfg = _cfg("gpt2-medium")
    n = counters.lm_matmul_params(cfg)
    assert n == 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 1024 * 50257
    matrices = sum(math.prod(s) for name, s, _ in weights.lm_shapes(cfg)
                   if len(s) == 2 and name != "embed.weight")
    assert n == matrices
    assert counters.decode_flops_per_token(cfg) == 2 * n
    assert counters.train_flops_per_token(cfg, 1024) == \
        6 * n + 6 * 1024 * 1024 * 24


def test_every_parameter_of_the_configurations_is_drawn():
    cfg = _cfg("gpt2-medium")
    total = sum(math.prod(s) for _, s, _ in weights.lm_shapes(cfg))
    assert total == 405_288_017
    vit = sum(math.prod(s) for _, s, _ in weights.vit_shapes(_cfg("vit-s16")))
    assert vit == 22_050_664


def test_k1_bytes_read_the_crop_and_write_bf16():
    assert counters.k1_bytes(256, 224) == 256 * 224 * 224 * 3 * 3


def test_attention_cost_halves_for_causal_and_triples_with_backward():
    f, b = counters.attention_cost(2, 64, 4, 32, causal=False)
    assert f == 4 * 2 * 4 * 64 * 64 * 32
    assert b == 4 * 2 * 64 * 4 * 32 * 2
    fc, bc = counters.attention_cost(2, 64, 4, 32, causal=True)
    assert fc == f / 2 and bc == b
    fb, bb = counters.attention_cost(2, 64, 4, 32, causal=True, backward=True)
    assert fb == 3 * fc and bb == 3 * b


def test_least_seconds_is_the_larger_bound():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert peaks.least_seconds(989e12, 0, p) == 1.0
    assert peaks.least_seconds(0, 6.7e12, p) == 2.0
    assert peaks.peaks_for("cpu") is None


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _doc():
    return {"traceEvents": [
        _ev(trace.SPIN_NAME, "kernel", 0, 5, correlation=1),
        _ev(trace.WINDOW_RANGE, "user_annotation", 100, 1000),
        _ev("aten::mm", "cpu_op", 100, 300),
        _ev("aten::copy_", "cpu_op", 400, 300),
        _ev("cudaLaunchKernel", "cuda_runtime", 150, 5, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 450, 5, correlation=3),
        _ev("cudaMemcpyAsync", "cuda_runtime", 460, 5, correlation=4),
        _ev("void flash_fwd_tc<64>(float)", "kernel", 200, 100,
            correlation=2),
        _ev("gemm_kernel(int)", "kernel", 250, 100, correlation=2),
        _ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 600, 200,
            correlation=3),
        _ev("void paged_fwd<bf16>(float)", "kernel", 1050, 100,
            correlation=4),
    ]}


def test_summary_clips_to_the_window_and_names_gaps():
    s = trace.summarize(_doc())
    assert s["window_s"] == pytest.approx(1000e-6)
    # [200, 350] and [600, 800] and [1050, 1100]: 150 + 200 + 50 µs
    assert s["busy_s"] == pytest.approx(400e-6)
    assert trace.SPIN_NAME not in str(s["kernels"])
    assert s["memcpy_s"]["HtoD"] == pytest.approx(200e-6)
    # 350 → 600 while aten::mm was open, 800 → 1050 with nothing open,
    # 100 → 200 from the window's start
    assert [(n, round(t * 1e6)) for n, t in s["idle_gaps"]] == [
        ("aten::mm", 250), ("_none_", 250), ("aten::mm", 100)]
    secs, calls = trace.kernel_seconds(s, readers.K2)
    assert (secs, calls) == (pytest.approx(100e-6), 1)
    secs, calls = trace.kernel_seconds(s, readers.K3)
    assert (secs, calls) == (pytest.approx(50e-6), 1)
    assert trace.top_ops(s, 1)[0][0].startswith("Memcpy HtoD")


def _readings(summary, **counters_):
    return SimpleNamespace(trace=summary, counters=counters_,
                           trace_counters={},
                           peaks=peaks.peaks_for("H100 SXM"))


def test_readers_share_of_window_and_roofline():
    s = trace.summarize(_doc())
    r = _readings(s, window_s=2.0)
    assert readers.idle_share(r) == pytest.approx(60.0)
    # one K2 call of 989e6 FLOPs: 1 µs least time over 100 µs
    assert readers.roofline(r, readers.K2, 989e6, 0.0) == pytest.approx(1.0)
    assert readers.mfu(r, 989e12) == pytest.approx(50.0)


def test_readers_find_nothing_and_say_nothing():
    empty = trace.summarize({"traceEvents": []})
    r = _readings(empty, window_s=1.0)
    assert readers.idle_share(r) is None
    assert readers.roofline(r, readers.K1, 1.0, 1.0) is None
    assert readers.roofline(_readings(None), readers.K1, 1.0, 1.0) is None
    assert readers.mfu(_readings(None, window_s=1.0), 0.0) is None
    assert readers.traced_delta(r, "generated") is None
