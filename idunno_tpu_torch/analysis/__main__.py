"""Protocol-contract lint over the port: run the analyzer, ONE JSON line
out (the port's counterpart of ``tools/protocol_lint.py``).

Exactly one JSON object on stdout whatever the outcome; exit 0 only when
the port's tree is clean (zero findings after the justified allowlist,
zero *stale* allowlist entries included), 1 with findings, 2 when the
analyzer itself crashed. The findings list is capped; counts are not.

    python -m idunno_tpu_torch.analysis                 # all checkers
    python -m idunno_tpu_torch.analysis --checker fence --checker idem
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from idunno_tpu_torch.analysis import run_analysis
from idunno_tpu_torch.analysis.core import CHECKERS

MAX_LISTED = 50

# the checkout's root: the analyzer loads idunno_tpu_torch/ under it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m idunno_tpu_torch.analysis")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--checker", action="append", default=None,
                    help="run only these checkers (repeatable); default "
                         "all registered")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    try:
        out = run_analysis(args.root, checkers=args.checker)
    except Exception as e:  # noqa: BLE001 - ONE JSON line even on a crash
        print(json.dumps({"suite": "protocol_lint", "error":
                          f"{type(e).__name__}: {e}"[:300]}))
        return 2
    findings = out["findings"]
    print(json.dumps({
        "suite": "protocol_lint",
        "checkers": sorted(args.checker or CHECKERS),
        "files_scanned": out["files_scanned"],
        "findings_total": len(findings),
        "findings_by_checker": out["by_checker"],
        "findings": [f.to_wire() for f in findings[:MAX_LISTED]],
        "allowlist_size": out["allowlist_size"],
        "allowlisted": out["allowlisted"],
        "elapsed_s": round(time.monotonic() - t0, 3)}))
    return 0 if not findings else 1


if __name__ == "__main__":
    sys.exit(main())
