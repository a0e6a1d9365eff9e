"""Structured logging, mirroring the reference's logger taxonomy.

Reference (`mp4_machinelearning.py:62-80`): a rotating ``host.log`` (100 MB,
one backup) plus ERROR-level console, with six named loggers — receiver,
monitor, join, send, master, sdfs. We keep the taxonomy (plus scheduler /
engine / failover loggers) but tag records with the node name so in-process
multi-node test clusters produce readable interleaved logs.
"""
from __future__ import annotations

import json
import logging
import logging.handlers
import os

LOGGER_NAMES = (
    "receiver", "monitor", "join", "send", "master", "sdfs",
    "scheduler", "engine", "failover", "metrics", "grep",
)

_FMT = "%(asctime)s %(levelname)s [%(name)s] %(message)s"


class JsonLineFormatter(logging.Formatter):
    """One JSON object per record, tagged with node, component, the node's
    current epoch view and the active trace/span (utils/spans.py
    thread-local) — so grepping a request's trace id across node logs
    reconstructs the same story the span waterfall tells. Opt-in via
    ``setup_node_logging(..., json_lines=True)`` or ``IDUNNO_LOG_JSON=1``.

    ``epoch_fn`` is a zero-arg callable returning the node's current epoch
    number (serve/node.py can wire ``lambda: membership.epoch.view()[0]``);
    None leaves the field out — the formatter must never import the
    membership layer."""

    def __init__(self, node: str, epoch_fn=None) -> None:
        super().__init__()
        self.node = node
        self.epoch_fn = epoch_fn

    def format(self, record: logging.LogRecord) -> str:
        # component = logger-name suffix past "idunno.<node>."
        parts = record.name.split(".")
        component = parts[-1] if len(parts) > 1 else record.name
        out = {"ts": round(record.created, 6),
               "level": record.levelname,
               "node": self.node,
               "component": component,
               "msg": record.getMessage()}
        if self.epoch_fn is not None:
            try:
                out["epoch"] = int(self.epoch_fn())
            except Exception:  # noqa: BLE001 - logging must never raise
                pass
        from idunno_tpu_torch.utils.spans import current
        ctx = current()
        if ctx is not None:
            out["trace_id"], out["span_id"] = ctx[0], ctx[1]
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"))


def setup_node_logging(node_name: str, log_dir: str = ".",
                       console_level: int = logging.ERROR,
                       file_level: int = logging.INFO,
                       json_lines: bool | None = None,
                       epoch_fn=None) -> logging.Logger:
    """Configure the per-node rotating file log + console errors; returns the
    node's root logger. Loggers are namespaced ``idunno.<node>.<component>``.
    ``json_lines`` (default: the ``IDUNNO_LOG_JSON`` env var) switches the
    file handler to :class:`JsonLineFormatter`."""
    root = logging.getLogger(f"idunno.{node_name}")
    root.setLevel(min(console_level, file_level))
    target = os.path.abspath(os.path.join(log_dir, f"{node_name}.log"))
    for h in list(root.handlers):
        if (isinstance(h, logging.handlers.RotatingFileHandler)
                and h.baseFilename == target):
            return root     # already wired to this destination
        root.removeHandler(h)   # stale handler from an earlier log_dir
        h.close()
    os.makedirs(log_dir, exist_ok=True)
    if json_lines is None:
        json_lines = os.environ.get("IDUNNO_LOG_JSON", "") not in ("", "0")
    fh = logging.handlers.RotatingFileHandler(
        os.path.join(log_dir, f"{node_name}.log"),
        maxBytes=100 * 1024 * 1024, backupCount=1)
    fh.setLevel(file_level)
    fh.setFormatter(JsonLineFormatter(node_name, epoch_fn=epoch_fn)
                    if json_lines else logging.Formatter(_FMT))
    ch = logging.StreamHandler()
    ch.setLevel(console_level)
    ch.setFormatter(logging.Formatter(_FMT))
    root.addHandler(fh)
    root.addHandler(ch)
    root.propagate = False
    return root


def component_logger(node_name: str, component: str) -> logging.Logger:
    return logging.getLogger(f"idunno.{node_name}.{component}")
