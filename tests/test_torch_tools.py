"""The port's tools (``idunno_tpu_torch/tools/``) on the CPU, against the
repository's ``tools/`` scripts and the JAX package where they share a
function.

- ``flash_sweep``: its paged grid is the JAX sweep's; its ``--cpu`` run
  writes one record a variant as it goes; its plain arms agree with the
  JAX package's ``flash_attention`` (interpret mode, as the JAX tests run
  it) and ``paged_attention_grouped`` (xla) on the sweep's own inputs;
- ``parse_trace``: exact sums, classes and gaps on a seeded synthetic
  Kineto trace (kernels, a replayed graph, a device-side annotation,
  memcpys, idle gaps), and a real CPU trace that ``trace`` wrote;
- ``mfu_roofline``: the layer geometry and FLOPs of ``tools/
  mfu_roofline.py`` and of the port bench's counters;
- ``trace_export`` and ``metrics_scrape``: the JAX tool's output on the
  same spans, and both self-tests;
- ``two_model_fairshare`` and ``spec_trace`` end to end at tiny sizes;
- every tool's refusal without a card and without ``--cpu``, and a
  ``--cpu`` record with no kernel arm.
"""
import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.ops.flash_attention import flash_attention as jax_flash
from idunno_tpu.ops.paged_attention import \
    paged_attention_grouped as jax_paged
from idunno_tpu.scheduler.fair import fair_shares as jax_fair_shares
from idunno_tpu_torch.bench import (alexnet_forward_flops,
                                    resnet_forward_flops)
from idunno_tpu_torch.scheduler.fair import fair_shares
from idunno_tpu_torch.tools import flash_sweep, mfu_roofline, parse_trace
from idunno_tpu_torch.tools import metrics_scrape, trace_export
from tests.torch_workers import share_cores  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


# -- flash_sweep ---------------------------------------------------------------

def _jax_paged_grids() -> tuple[list, list]:
    """The JAX sweep's native and int8 paged grids, read from its source:
    the ``for pbs`` loops of ``main`` and the ``kv_len``/``q_len`` loops
    inside them (``q_len`` 1 where the int8 section has none)."""
    with open(os.path.join(REPO, "tools", "flash_sweep.py")) as f:
        tree = ast.parse(f.read())

    def loops(node, name):
        return [n for n in ast.walk(node) if isinstance(n, ast.For)
                and isinstance(n.target, ast.Name) and n.target.id == name]

    grids = []
    for outer in loops(tree, "pbs"):
        grid = []
        for bs in ast.literal_eval(outer.iter):
            for kv_loop in loops(outer, "kv_len")[:1]:
                for kv in ast.literal_eval(kv_loop.iter):
                    qs = loops(kv_loop, "q_len")
                    for q in (ast.literal_eval(qs[0].iter) if qs else (1,)):
                        grid.append((bs, kv, q))
        grids.append(grid)
    assert len(grids) == 2
    return grids[0], grids[1]


def test_sweep_paged_grid_is_the_jax_sweeps():
    native, int8 = _jax_paged_grids()
    assert list(flash_sweep.PAGED_GRID) == native
    assert len(native) == 12
    # the JAX int8 section's block sizes, and block size 64 beside them
    assert set(int8) < set(flash_sweep.INT8_GRID)
    assert {bs for bs, _, _ in flash_sweep.INT8_GRID} == {16, 32, 64}
    labels = [v["variant"] for v in flash_sweep.paged_variants()]
    assert len(labels) == len(set(labels)) == 18
    k2 = flash_sweep.k2_variants()
    assert len(k2) == 16 and {(v["batch"], v["seq"]) for v in k2} == set(
        flash_sweep.K2_SHAPES)


class Cut(Exception):
    pass


def test_sweep_writes_each_variant_as_it_goes(tmp_path, monkeypatch):
    """A CPU sweep cut after k variants has written k records; the whole
    one writes every variant, each with the plain arm alone."""
    out = str(tmp_path / "sweep.json")
    variants = (flash_sweep.k2_variants(cpu=True)
                + flash_sweep.paged_variants(cpu=True))
    real, calls = flash_sweep.measure_k3, []

    def cut_after_k(v, dev):
        if len(calls) == 3:
            raise Cut
        calls.append(v)
        return real(v, dev)

    monkeypatch.setattr(flash_sweep, "measure_k3", cut_after_k)
    with pytest.raises(Cut):
        flash_sweep.sweep(variants, CPU, {}, out)
    with open(out) as f:
        got = json.load(f)["variants"]
    k = len(flash_sweep.k2_variants(cpu=True)) + 3
    assert len(got) == k
    assert [r["variant"] for r in got] == [v["variant"] for v in variants[:k]]
    monkeypatch.setattr(flash_sweep, "measure_k3", real)
    assert flash_sweep.main(["--cpu", "--out", out]) == 0
    with open(out) as f:
        rec = json.load(f)
    assert rec["device"] == "cpu" and rec["ok"] and not rec["failed"]
    assert len(rec["variants"]) == len(variants)
    for row in rec["variants"]:
        assert row["arms"] == ["plain"]
        assert not {"ms", "plain_ms", "library_ms", "bound_ms"} & set(row)


@pytest.mark.parametrize("causal", [True, False])
def test_sweep_k2_plain_arm_matches_jax_flash(causal):
    v = next(v for v in flash_sweep.k2_variants(cpu=True)
             if v["seq"] == 128 and v["head_dim"] == 64
             and v["causal"] == causal)
    q, k, w = (x.float() for x in flash_sweep.k2_inputs(v, CPU, seed=7))
    out, _ = flash_sweep.k2_plain(q, k, w, causal)
    want = np.asarray(jax_flash(*(jnp.asarray(x.numpy()) for x in (q, k, w)),
                                causal=causal, block_q=64, block_k=64,
                                interpret=True))
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("label", ["paged_bf16_bs16_kv512_q8",
                                   "paged_bf16_bs64_kv4096_q1",
                                   "paged_int8_bs32_kv512_q1"])
def test_sweep_k3_plain_arm_matches_jax_paged(label):
    v = next(v for v in flash_sweep.paged_variants(cpu=True)
             if v["variant"] == label)
    q5, kp, vp, ks, vs, tables, lengths = flash_sweep.paged_inputs(
        v, CPU, seed=3)
    kp, vp = kp[0], vp[0]
    scales = () if ks is None else (ks[0], vs[0])
    out, lse = flash_sweep.k3_plain(q5, kp, vp, tables, lengths, *scales)
    as_np = (lambda x: x.float().numpy() if x.dtype == torch.bfloat16
             else x.numpy())
    kw = ({} if ks is None else
          dict(k_scale_pages=jnp.asarray(ks[0].numpy()),
               v_scale_pages=jnp.asarray(vs[0].numpy())))
    want, want_lse = jax_paged(
        jnp.asarray(q5.numpy()), jnp.asarray(as_np(kp)),
        jnp.asarray(as_np(vp)), jnp.asarray(tables.numpy()),
        jnp.asarray(lengths.numpy()), kernel="xla", **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=0)


# -- parse_trace -----------------------------------------------------------------

KERNEL_NAMES = {
    "K1": "void (anonymous namespace)::crop_normalize_vec16(unsigned char "
          "const*, __nv_bfloat16*, int)",
    "K2": "void (anonymous namespace)::flash_fwd_tc(__nv_bfloat16 const*)",
    "K3": "void (anonymous namespace)::paged_fwd<__nv_bfloat16, 64>(float "
          "const*)",
    "K4": "void (anonymous namespace)::flash_bwd_dq_tc(Inputs, int)",
    "K5": "void (anonymous namespace)::flash_bwd_dkv<true>(Inputs, int)",
    "gemm": "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
    "elementwise_reduce": "void at::native::vectorized_elementwise_kernel"
                          "<4, at::native::AddFunctor<float> >(int)",
    "copy_cast": "void at::native::unrolled_elementwise_kernel<at::native::"
                 "direct_copy_kernel_cuda(at::TensorIteratorBase&)>(int)",
    "collective": "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)",
    "other": "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>"
             "(Flash_fwd_params)",
}
HOST, THREAD, DEVICE, STREAM = 4242, 17, 0, 7


def synthetic_trace(seed: int) -> tuple[dict, dict]:
    """A Kineto-shaped trace: one host thread launching a seeded mix of
    kernels (some through one replayed graph), memcpys, a device-side
    annotation over them, idle gaps, host operators; and what the
    apportioner must find. Times are multiples of 250 µs, so every sum
    in ms is exact."""
    rng = np.random.default_rng(seed)
    events, want_cls = [], dict.fromkeys(parse_trace.CLASSES, 0.0)
    counts = dict.fromkeys(parse_trace.KERNEL_SYMBOLS, 0)
    gaps = []
    t, corr = 10_000.0, 100
    host_ops = []
    classes = list(KERNEL_NAMES)
    for i in range(40):
        cls = classes[rng.integers(len(classes))]
        dur = 250.0 * int(rng.integers(1, 9))
        idle = 250.0 * int(rng.integers(0, 4)) if i else 0.0
        if idle:
            gaps.append((idle, t, f"host.op{i}"))
            # the host op open on the launching thread when the gap began
            host_ops.append({"ph": "X", "cat": "cpu_op", "name": f"host.op{i}",
                             "pid": HOST, "tid": THREAD, "ts": t - 100.0,
                             "dur": idle + 50.0})
            t += idle
        graph = cls == "K3" and i % 2 == 0
        launch_corr = 9 if graph else corr
        if not graph:
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "pid": HOST,
                           "tid": THREAD, "ts": t - 200.0, "dur": 5.0,
                           "args": {"correlation": corr}})
        name = KERNEL_NAMES[cls]
        cat = "kernel"
        if cls == "copy_cast" and i % 3 == 0:
            name, cat = "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"
        events.append({"ph": "X", "cat": cat, "name": name, "pid": DEVICE,
                       "tid": STREAM, "ts": t, "dur": dur,
                       "args": {"correlation": launch_corr,
                                "stream": STREAM}})
        want_cls[cls] += dur / 1e3
        if cls in counts:
            counts[cls] += 1
        corr += 1
        t += dur
    events.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaGraphLaunch", "pid": HOST, "tid": THREAD,
                   "ts": 9_000.0, "dur": 10.0, "args": {"correlation": 9}})
    # a device-side annotation spanning kernels already counted, an outer
    # host annotation, a flow event and a process name: none is device time
    events += [{"ph": "X", "cat": "gpu_user_annotation", "name": "step",
                "pid": DEVICE, "tid": STREAM, "ts": 10_000.0,
                "dur": t - 10_000.0},
               {"ph": "X", "cat": "user_annotation", "name": "step",
                "pid": HOST, "tid": THREAD, "ts": 9_000.0,
                "dur": t - 9_000.0},
               {"ph": "s", "cat": "ac2g", "id": 3, "pid": HOST,
                "tid": THREAD, "ts": 9_000.0},
               {"ph": "M", "name": "process_name", "pid": HOST,
                "args": {"name": "python"}}]
    # the spin kernels `trace` opens a CUDA window with, ahead of the
    # region: left out of every sum, counted apart
    events += [{"ph": "X", "cat": "kernel", "name": "void at::cuda::"
                "(anonymous namespace)::spin_kernel(long)", "pid": DEVICE,
                "tid": STREAM, "ts": 5_000.0 + 10.0 * i, "dur": 2.0,
                "args": {"correlation": 50 + i}} for i in range(7)]
    events += host_ops
    order = rng.permutation(len(events))
    doc = {"schemaVersion": 1, "traceEvents": [events[i] for i in order]}
    gaps.sort(key=lambda g: -g[0])
    return doc, {"classes": want_cls, "counts": counts, "gaps": gaps,
                 "total": sum(want_cls.values()),
                 "window": (t - 10_000.0) / 1e3}


@pytest.mark.parametrize("seed", [0, 1])
def test_apportion_synthetic_trace_exact(tmp_path, seed):
    doc, want = synthetic_trace(seed)
    path = str(tmp_path / "t.pt.trace.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    rep = parse_trace.apportion(path, steps=4, top=100)
    assert rep["source"] == path
    assert rep["device_total_ms"] == want["total"]
    assert rep["classes"] == want["classes"]
    assert rep["kernel_counts"] == want["counts"]
    assert rep["per_step_ms"] == want["total"] / 4
    assert rep["warmup_kernels"] == 7
    assert sum(r["count"] for r in rep["ops"]) == sum(
        1 for e in doc["traceEvents"] if e.get("cat") in ("kernel",
                                                           "gpu_memcpy")
        and "spin_kernel" not in e["name"])
    assert rep["window_ms"] == want["window"]
    assert rep["gap_count"] == len(want["gaps"])
    assert rep["idle_ms"] == sum(g[0] for g in want["gaps"]) / 1e3
    got = [(g["ms"], g["start_us"], g["host_op"]) for g in rep["gaps"]]
    assert sorted(got) == sorted((d / 1e3, s, n) for d, s, n in want["gaps"])
    assert [g["ms"] for g in rep["gaps"]] == sorted(
        (g["ms"] for g in rep["gaps"]), reverse=True)


def test_kernel_classes_of_the_ports_symbols():
    for cls, name in KERNEL_NAMES.items():
        assert parse_trace.kernel_class(name) == cls, name
    assert parse_trace.kernel_class("Memset (Device)", "gpu_memset") == \
        "copy_cast"
    assert set(parse_trace.LAUNCH_NAMES) == set(parse_trace.KERNEL_SYMBOLS)


def test_apportion_reads_a_cpu_trace_that_trace_wrote(tmp_path):
    from idunno_tpu_torch.utils.tracing import trace

    with trace(str(tmp_path)):
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    rep = parse_trace.apportion(str(tmp_path))
    assert rep["source"].endswith(".pt.trace.json.gz")
    assert rep["device_total_ms"] == 0.0 and rep["ops"] == []
    assert set(rep["classes"].values()) == {0.0}
    assert rep["gaps"] == [] and rep["gap_count"] == 0
    assert parse_trace.main(["--cpu", str(tmp_path)]) == 0


# -- mfu_roofline ---------------------------------------------------------------

@pytest.mark.parametrize("model", ["resnet18", "alexnet"])
def test_roofline_geometry_and_flops(model):
    import tools.mfu_roofline as jax_tool

    name = f"{model}_layers"
    ours = getattr(mfu_roofline, name)()
    assert ours == getattr(jax_tool, name)()
    rep = mfu_roofline.analyze(ours, 8)
    ref = jax_tool.analyze(ours, 8)
    assert rep["total_flops"] == ref["total_flops"]
    for row, layer in zip(rep["layers"], ours):
        assert row["flops"] == 2.0 * 8 * layer["oh"] * layer["ow"] * \
            layer["cout"] * layer["cin"] * layer["k"] * layer["k"]
        assert 0.0 < row["tile_fill"] <= 1.0
    bench = (resnet_forward_flops(224) if model == "resnet18"
             else alexnet_forward_flops(224))
    assert rep["total_flops"] == 8 * bench
    assert 0.0 < rep["mfu_ceiling_from_shape_and_bw"] <= 1.0


# -- trace_export and metrics_scrape ---------------------------------------------

def test_trace_export_equals_the_jax_tool():
    import tools.trace_export as jax_tool

    spans = [{"trace_id": "t:a:1", "span_id": "a:1", "parent": None,
              "name": "client.op", "node": "a", "t_start": 100.0,
              "t_end": 100.02, "attrs": {"k": 1}},
             {"trace_id": "t:a:1", "span_id": "b:1", "parent": "a:1",
              "name": "server.step", "node": "b", "t_start": 100.005,
              "t_end": None, "attrs": {}},
             {"trace_id": "t:a:2", "span_id": "a:2", "parent": None,
              "name": "other", "node": "a", "t_start": 99.0,
              "t_end": 99.5, "attrs": {}}]
    for tid in (None, "t:a:1"):
        doc = trace_export.to_chrome(spans, trace_id=tid)
        assert doc == jax_tool.to_chrome(spans, trace_id=tid)
        assert trace_export.from_chrome(doc) == jax_tool.from_chrome(doc)
    assert trace_export.waterfall("t:a:1", spans) == jax_tool.waterfall(
        "t:a:1", spans)
    assert trace_export.selftest() == jax_tool.selftest()
    assert trace_export.selftest()["selftest"] == "ok"


def test_metrics_scrape_selftest():
    import tools.metrics_scrape as jax_tool

    got = metrics_scrape.selftest()
    assert got["selftest"] == "ok" and got == jax_tool.selftest()
    assert metrics_scrape.main(["--selftest", "--cpu"]) == 0


# -- the end-to-end tools at tiny sizes ------------------------------------------

def test_two_model_fairshare_cpu_shares_equal_fair_shares(tmp_path):
    from idunno_tpu_torch.tools import two_model_fairshare as tool

    out = str(tmp_path / "fs.json")
    assert tool.main(["--cpu", "--heavy-images", "16", "--light-images",
                      "8", "--queries", "2", "--batch", "8",
                      "--image-size", "64", "--out", out]) == 0
    with open(out) as f:
        rec = json.load(f)
    assert rec["device"] == "cpu" and "launches" not in rec
    assert rec["both_live_snapshots"] > 0
    assert rec["shares_match_fair_shares"]
    for c in rec["share_checks"]:
        assert c["shares"] == fair_shares(c["avg_query_s"], 10, 3)
    assert rec["fair_shares"] == fair_shares(rec["avg_query_s"], 10, 3)
    for avg in (rec["avg_query_s"], {"a": 7.0, "b": 3.0},
                {"a": 0.0, "b": 2.5, "c": 1.0}, {}):
        for rate, workers in ((10, 3), (4, 10), (10, 0)):
            assert fair_shares(avg, rate, workers) == jax_fair_shares(
                avg, rate, workers)


def test_spec_trace_cpu_every_round_commits_the_chunk(tmp_path):
    from idunno_tpu_torch.tools import spec_trace
    from idunno_tpu_torch.utils.lm_bench import lm_bench_config

    cfg = lm_bench_config("cpu")
    assert cfg["depth"] == 2
    out = str(tmp_path / "st.json")
    assert spec_trace.main(["--cpu", "--out", out]) == 0
    with open(out) as f:
        rec = json.load(f)
    chunk = rec["config"]["draft_len"] + 1
    assert rec["every_round_commits_the_chunk"]
    assert rec["spec"]["tokens_per_row"] == [
        rec["rounds_per_dispatch"] * chunk] * cfg["slots"]
    assert rec["plain"]["tokens_per_row"] == [cfg["decode_steps"]] * \
        cfg["slots"]
    assert not {"launches", "apportion"} & (set(rec["plain"])
                                            | set(rec["spec"]))


# -- the device rule ---------------------------------------------------------------

TOOL_ARGS = {
    "flash_sweep": [], "parse_trace": ["x.json"], "mfu_roofline": [],
    "spec_trace": [], "two_model_fairshare": [],
    "metrics_scrape": ["--selftest"], "trace_export": ["--selftest"],
}


@pytest.mark.parametrize("name", sorted(TOOL_ARGS))
def test_tools_refuse_without_a_card_unless_cpu(name, monkeypatch, capsys):
    import importlib

    mod = importlib.import_module(f"idunno_tpu_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(TOOL_ARGS[name]) == 2
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "--cpu" in json.loads(line)["error"]


def test_mfu_roofline_cpu_record_has_no_measured_arm(capsys):
    assert mfu_roofline.main(["--cpu", "--batch", "16"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and "measured" not in rec
    assert rec["provenance"]["torch_version"] == torch.__version__
