"""Processes and the dry run of the port, on the CPU.

- Two processes of ``python -m idunno_tpu_torch.dryrun`` join through
  ``parallel/mesh.py:initialize_distributed`` over gloo (the counterpart
  of the JAX package's ``tests/test_multiprocess_e2e.py::
  test_jax_distributed_two_process_mesh``): ``process_info``, a two-row
  ``global_mesh`` whose local rows are each process's own, the sum of the
  process-local rows (4 × 1 + 4 × 2 = 12), and one ResNet-18
  data-parallel step across the two processes (BatchNorm over the global
  batch) whose loss and running variance equal one process's step on the
  whole batch (rtol 1e-5).
- ``python -m idunno_tpu_torch.dryrun 4 --device cpu`` exits 0 with its
  ring-attention, pipeline and expert-parallel sections and no section
  it does not run; without ``--device`` the
  dry run and the two-process check run on the card, and raise where
  there is none.
- ``python -m idunno_tpu_torch --dist-*`` joins the group before the node
  is built.
"""
import os
import subprocess
import sys

import pytest

from idunno_tpu_torch import __main__ as entry
from idunno_tpu_torch.dryrun import two_process_check
from tests.torch_workers import share_cores  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_gloo_processes_share_a_mesh_and_a_step():
    outs = two_process_check("cpu", timeout=240)
    assert [o["process"] for o in outs] == [0, 1]
    for o in outs:
        assert o["processes"] == 2 and o["backend"] == "gloo", o
        assert o["global_mesh"] == {"data": 2, "model": 1}
        assert o["local_groups"] == [o["process"]]
        assert o["process_local_sum"] == 12.0
        assert o["rel_gap"] <= 1e-5 and o["ok"], o
    assert outs[0]["loss"] == outs[1]["loss"]
    assert outs[0]["running_var_sum"] == outs[1]["running_var_sum"]


def test_dryrun_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "idunno_tpu_torch.dryrun",
                          "4", "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("dryrun_multichip ok: mesh=(2x2)")
    assert "tp n_model=2 token-exact" in lines[-1]
    assert "ring seq=32" in lines[-1]
    assert "pp stages=4, pp-x-dp mesh=2x2" in lines[-1]
    assert "ep experts=4 (top-2)" in lines[-1]
    assert not [line for line in lines if "not ported" in line]


def test_dryrun_defaults_to_the_card(monkeypatch):
    import torch

    from idunno_tpu_torch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.two_process_check()


def test_dist_flags_join_before_the_node(monkeypatch):
    """The ``--dist-*`` flags reach ``initialize_distributed`` before any
    node is built (stopped there)."""
    from idunno_tpu_torch.parallel import mesh

    seen = {}

    def fake(addr, num_processes=None, process_id=None):
        seen.update(addr=addr, n=num_processes, pid=process_id)
        raise SystemExit(7)

    monkeypatch.setattr(mesh, "initialize_distributed", fake)
    monkeypatch.setattr(entry, "build_node", lambda *a, **k: pytest.fail(
        "the node was built before the group"))
    with pytest.raises(SystemExit) as ei:
        entry.main(["--host", "node0", "--cpu", "--dist-coordinator",
                    "127.0.0.1:29511", "--dist-num-processes", "2",
                    "--dist-process-id", "1"])
    assert ei.value.code == 7
    assert seen == {"addr": "127.0.0.1:29511", "n": 2, "pid": 1}
