"""The port's pinned error-class baseline, over ``idunno_tpu_torch/`` and
``chip_smoke.py`` (``analysis/errorlint.py:BASELINE_TARGETS``), stays at
zero.

``ruff.toml`` pins the selected classes (F / E9 / PLE — bug classes, not
style). When a ruff binary is on PATH the test runs it against the pinned
config; otherwise it falls back to the built-in subset linter
(idunno_tpu_torch/analysis/errorlint.py). Either way the tree must read ZERO —
the container must never need a pip install for this gate to hold.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_error_baseline_zero():
    from idunno_tpu_torch.analysis.errorlint import BASELINE_TARGETS, lint_paths
    ruff = shutil.which("ruff")
    if ruff:
        out = subprocess.run(
            [ruff, "check", "--config", os.path.join(ROOT, "ruff.toml"),
             *BASELINE_TARGETS],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, \
            f"ruff baseline regressed:\n{out.stdout}\n{out.stderr}"
        return
    problems = lint_paths(ROOT, BASELINE_TARGETS)
    assert problems == [], (
        "error-class baseline regressed (ruff.toml classes, fallback "
        "linter):\n" + "\n".join(
            f"  {p['code']} {p['file']}:{p['line']} {p['message']}"
            for p in problems))


def test_fallback_linter_catches_each_class(tmp_path):
    """The fallback is only a valid stand-in if it actually detects the
    classes it claims — one seeded violation per code, plus noqa."""
    from idunno_tpu_torch.analysis.errorlint import lint_paths

    cases = {
        "f401.py": ("import os\nimport json\nprint(json.dumps({}))\n",
                    "F401"),
        "f541.py": ('x = f"plain"\n', "F541"),
        "f632.py": ('y = 1\nok = y is "one"\n', "F632"),
        "f841.py": ("def f():\n    dead = 3\n    return 1\n", "F841"),
        "f821.py": ("def f():\n    return boguz_name\n", "F821"),
        "e999.py": ("def broken(:\n", "E999"),
    }
    for fname, (src, _) in cases.items():
        (tmp_path / fname).write_text(src)
    problems = lint_paths(str(tmp_path), sorted(cases))
    got = {(p["file"], p["code"]) for p in problems}
    for fname, (_, code) in cases.items():
        assert (fname, code) in got, f"fallback missed {code} in {fname}"

    # noqa (bare and coded) suppresses; format specs are not F541
    (tmp_path / "clean.py").write_text(
        'import os  # noqa: F401\n'
        'x = f"done"  # noqa\n'
        'v = 7\nz = f"{v:08x}"\nprint(os, z)\n')
    assert lint_paths(str(tmp_path), ["clean.py"]) == []


def test_fallback_driver_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "idunno_tpu_torch.analysis.errorlint"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["suite"] == "errorlint"
    assert d["problems_total"] == 0
    assert out.returncode == 0
