"""Finding a cell's parts by name.

``BENCHMARK.json`` names the cells (``workloads``), their configuration
and traffic mix, and the metrics; each part lives in a file of its own
under ``perfbench/``, so a new cell, mix, configuration or metric is a new
file and never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, config: str, traffic: str, *,
              end_to_end: list = (), per_layer: list = ()) -> Cell:
    """A cell from its files: ``configs/<config>.json``,
    ``traffic/<traffic>.json`` and ``limits/<name>.json``."""
    return Cell(name=name, chips=1, config_name=config, traffic_name=traffic,
                config=_load_json(os.path.join(HERE, "configs",
                                               f"{config}.json")),
                traffic=_load_json(os.path.join(HERE, "traffic",
                                                f"{traffic}.json")),
                limits=_load_json(os.path.join(HERE, "limits",
                                               f"{name}.json")),
                end_to_end=list(end_to_end), per_layer=list(per_layer))


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration and
    traffic files, its limits and the metrics it reports. A per-layer
    metric without a ``workloads`` key goes with every cell that reports
    the end-to-end metric it moves."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and _applies(m, name)]
    cell = load_cell(name, w["config"], w["traffic"], end_to_end=e2e,
                     per_layer=per_layer)
    cell.chips = int(w["chips"])
    return cell


def metric_reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
