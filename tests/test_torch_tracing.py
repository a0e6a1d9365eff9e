"""The port's tracing (``idunno_tpu_torch/utils/tracing.py``) against the
JAX package's (``idunno_tpu/utils/tracing.py``), and the port's ``profile``
control verb, on the CPU. The card cases (``device_timed`` waits for the
card, a trace holds K3 kernels of another thread) are in
``tests/test_torch_kernels.py`` under the ``gpu`` marker."""
import gzip
import json
import os
import threading

import numpy as np
import pytest
import torch

from idunno_tpu.utils.tracing import StepTimer as JaxStepTimer
from idunno_tpu_torch.utils.tracing import (StepTimer, annotate,
                                            device_timed, trace)
from tests.torch_workers import share_cores  # noqa: F401


def _profiler_off() -> bool:
    return str(torch._C._autograd._profiler_type()).endswith("NONE")


def _trace_events(log_dir) -> list[dict]:
    files = [os.path.join(d, f) for d, _, fs in os.walk(log_dir)
             for f in fs if f.endswith(".json.gz")]
    assert len(files) == 1, files
    with gzip.open(files[0], "rt") as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("n", [1, 2, 7, 40])
def test_step_timer_stats_equal_jax(n):
    """The same seeded durations give the JAX StepTimer's stats exactly."""
    durations = np.random.default_rng(n).exponential(0.05, size=n).tolist()
    mine, ref = StepTimer(), JaxStepTimer()
    for d in durations:
        mine.record(d)
        ref.record(d)
    assert mine.stats() == ref.stats()
    assert StepTimer().stats() is None is JaxStepTimer().stats()


def test_step_timer_measure_records_each_step():
    st = StepTimer()
    with st.measure() as out:
        out["result"] = {"x": [torch.ones(8) * 2]}
    with st.measure(result_to_block=torch.zeros(3)):
        pass
    assert len(st.durations_s) == 2 and all(d >= 0 for d in st.durations_s)


def test_device_timed_flags_first_call_of_each_shape():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x.shape)
        return x.sum() * scale

    timed = device_timed(fn)
    out1, t1 = timed(torch.ones(8, 8))
    out2, t2 = timed(torch.ones(8, 8), scale=1.0)
    _, t3 = timed(torch.ones(8, 8), scale=2.0)       # same key: a float leaf
    _, t4 = timed(torch.ones(4, 4))                  # new shape
    _, t5 = timed(torch.ones(8, 8, dtype=torch.float64))  # new dtype
    assert [t.compiled for t in (t1, t2, t3, t4, t5)] == [
        False, False, True, False, False]
    assert float(out1) == float(out2) == 64.0
    assert all(t.seconds >= 0 for t in (t1, t2, t3, t4, t5))
    # a second wrapper keeps its own first-seen shapes
    assert not device_timed(fn)(torch.ones(8, 8))[1].compiled


def test_trace_with_annotate_writes_the_annotated_range(tmp_path):
    log_dir = str(tmp_path / "prof")
    with trace(log_dir):
        with annotate("matmul-region"):
            x = torch.ones(128, 128)
            (x @ x).sum().item()
    assert _profiler_off()
    # the JAX test's artifact check accepts the file
    found = [f for _, _, files in os.walk(log_dir) for f in files
             if f.endswith((".pb", ".xplane.pb", ".json.gz", ".trace"))]
    assert found, f"no trace artifacts under {log_dir}"
    names = {e.get("name") for e in _trace_events(log_dir)}
    assert "matmul-region" in names and "aten::mm" in names


def test_nested_trace_raises_and_leaves_the_profiler_off(tmp_path):
    outer = str(tmp_path / "outer")
    with trace(outer):
        with pytest.raises(RuntimeError, match="outer"):
            with trace(str(tmp_path / "inner")):
                pass
    assert _profiler_off()
    assert not os.path.exists(tmp_path / "inner")
    # an exception in the body stops the profiler and frees the slot
    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path / "boom")):
            1 / 0
    assert _profiler_off() and not os.path.exists(tmp_path / "boom")
    with trace(None) as prof:                 # in memory: no file at all
        torch.ones(4).add_(1)
    assert _profiler_off() and any(
        e.name == "aten::add_" for e in prof.events())
    # a trace from another thread while one runs: refused, not nested
    errors = []

    def other():
        try:
            with trace(str(tmp_path / "other")):
                pass
        except RuntimeError as e:
            errors.append(str(e))

    with trace(str(tmp_path / "first")):
        th = threading.Thread(target=other)
        th.start()
        th.join(30)
    assert not th.is_alive() and len(errors) == 1 and "first" in errors[0]


class _Transport:
    def serve(self, *_a, **_k):
        pass


def _control():
    from idunno_tpu_torch.serve.control import ControlService
    node = type("NodeStub", (), {})()
    node.host, node.transport = "n0", _Transport()
    return ControlService(node)


def test_profile_control_verb_traces_a_busy_torch_thread(tmp_path):
    """The ``profile`` verb traces whatever the node runs during its window
    (here a torch thread other than the verb's) into the caller's
    directory, and replies ``{log_dir, seconds}``."""
    ctl = _control()
    stop = threading.Event()

    def busy():
        x = torch.ones(64, 64)
        while not stop.is_set():
            (x @ x).sum().item()

    th = threading.Thread(target=busy, daemon=True)
    th.start()
    try:
        log_dir = str(tmp_path / "prof")
        out = ctl._dispatch("profile", {"seconds": 0.5, "log_dir": log_dir})
        assert out == {"log_dir": log_dir, "seconds": 0.5}
        # the busy thread's operators (Kineto's all-threads mode)
        assert any(e.get("name") == "aten::mm"
                   for e in _trace_events(log_dir))
    finally:
        stop.set()
        th.join(timeout=5)
    assert not th.is_alive() and _profiler_off()


def test_profile_verb_default_dir_is_under_the_node_data_dir(tmp_path):
    ctl = _control()
    store = type("Store", (), {})()
    store.local = type("Local", (), {"data_dir": str(tmp_path)})()
    ctl.node.store = store
    out = ctl._dispatch("profile", {"seconds": 0.1})
    assert out["seconds"] == 0.1
    assert out["log_dir"].startswith(os.path.join(str(tmp_path), "profiles"))
    assert _trace_events(out["log_dir"])


@pytest.mark.parametrize("seconds", [0, 61, -1])
def test_profile_verb_refuses_a_window_outside_0_60(seconds):
    ctl = _control()
    with pytest.raises(ValueError, match="seconds"):
        ctl._dispatch("profile", {"seconds": seconds})
    assert _profiler_off()
