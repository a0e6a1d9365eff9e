"""The port's counterparts of the repository's ``tools/`` scripts.

Each keeps its JAX script's name, runs as ``python -m
idunno_tpu_torch.tools.<name>`` and prints one JSON line:

- ``flash_sweep``: K2 and K3 over the shapes the LM's paths give them,
  each variant held against its plain version before it is timed;
- ``parse_trace``: device time of a Kineto trace (``utils/tracing.py:
  trace``) by kernel and by class, and the device's idle gaps;
- ``mfu_roofline``: the bench CNNs' per-layer roofline on the H100;
- ``spec_trace``: one speculative decode dispatch against one plain
  dispatch, each traced and apportioned;
- ``two_model_fairshare``: two models served at once by a three-node
  cluster under the fair-time arbiter;
- ``metrics_scrape``: a node's Prometheus exposition (``metrics_export``);
- ``trace_export``: span dumps to Chrome trace events and back, and one
  traced request through an LM pool.

A tool runs on the card. With ``--cpu`` it runs on the CPU and says so in
its record (``"device": "cpu"``, and no kernel arm); without a card and
without ``--cpu`` it prints an error line and exits non-zero. A tool that
writes a record writes it under ``chiprun_out/`` at the repository's root
unless given ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_out(name: str) -> str:
    """Where a tool writes its record without ``--out``."""
    return os.path.join(REPO, "chiprun_out", name)


def parser(description: str, out: str | None = None
           ) -> argparse.ArgumentParser:
    """An argument parser with ``--cpu`` and, for a tool that writes a
    record, ``--out`` (default ``chiprun_out/<out>``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the record says so)")
    if out is not None:
        ap.add_argument("--out", default=default_out(out))
    return ap


def device(cpu: bool):
    """The tool's device: the CPU with ``--cpu``, else the card; None
    (after printing the error line) where there is no card."""
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA card is present; pass --cpu "
                                   "to run on the CPU"}), flush=True)
        return None
    return torch.device("cuda")


def stamp(rec: dict, dev) -> dict:
    """``rec`` with the device it ran on and the bench's provenance block
    (torch, CUDA, commit and, on the card, its name and power limit)."""
    from idunno_tpu_torch.bench import provenance

    card = dev.type == "cuda"
    rec["device"] = "cuda" if card else "cpu"
    rec["provenance"] = provenance(card)
    return rec


def write(rec: dict, path: str) -> None:
    """Write ``rec`` as JSON to ``path`` (its directory made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
    os.replace(tmp, path)
