"""CLI: ``python -m repro_torch.check [--strict] [--json] [--out PATH]
[--root DIR] [--no-trace] [--device D]``.

Prints every violation as ``path:line: [rule] message`` plus the
dead-inheritance inventory summary. ``--strict`` exits non-zero on any
violation; without it the run is a report. ``--json`` additionally writes
``results/check_report_torch.json`` (the JAX package's report,
``results/check_report.json``, is never written), keyed by commit, with
the JAX package's schema: its ``meta`` names ``torch`` where the JAX
package's names ``jax``, and the GPU when the trace ran on the card. The
trace pass runs on ``--device`` (default: the card, an error where CUDA
is absent).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.check import repo_root, run_checks
from repro_torch.obs.clock import utc_stamp


def _meta(device=None):
    """Commit/env metadata: the JAX package's report's, ``torch`` for
    ``jax``, and ``gpu`` when the trace ran on a CUDA device."""
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=str(repo_root())).stdout.strip() or "unknown"
    except OSError:
        commit = "unknown"

    def ver(pkg):
        try:
            import importlib.metadata
            return importlib.metadata.version(pkg)
        except Exception:                           # noqa: BLE001
            return "unknown"

    meta = {"commit": commit, "python": platform.python_version(),
            "torch": torch.__version__, "numpy": ver("numpy"),
            "timestamp": utc_stamp()}
    if device is not None and torch.device(device).type == "cuda":
        meta["gpu"] = torch.cuda.get_device_name(torch.device(device))
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-check",
        description="Static contract checker of the PyTorch port")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any violation (tier-1 / CI mode)")
    ap.add_argument("--json", action="store_true", dest="json_out",
                    help="write the report to "
                         "results/check_report_torch.json")
    ap.add_argument("--out", type=Path, default=None,
                    help="override the --json report path")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root to check (default: this repo)")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the (slower) dispatch-trace checks")
    ap.add_argument("--device", default=None,
                    help="where the trace pass runs (default: cuda)")
    args = ap.parse_args(argv)

    report = run_checks(args.root, skip_trace=args.no_trace,
                        device=args.device)

    for v in report.violations:
        print(v.format())
    inv = report.inventory
    print("\ncheckers: " + ", ".join(
        f"{k}={'skipped' if n < 0 else n}"
        for k, n in report.per_checker.items()))
    print(f"dead-inheritance: {inv['n_dead']}/{inv['n_modules']} modules "
          f"unreachable from tests/examples/benchmarks/chip_smoke.py "
          f"({inv['dead_loc']} LoC): " + ", ".join(
              f"{pkg}={loc}" for pkg, loc in
              inv["dead_by_package"].items()))

    if args.json_out or args.out:
        out = args.out or (repo_root() / "results" /
                           "check_report_torch.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "check": "contracts",
            "meta": _meta(None if args.no_trace else
                          (args.device or "cuda")),
            "ok": report.ok,
            "per_checker": report.per_checker,
            "violations": [dataclasses.asdict(v)
                           for v in report.violations],
            "inventory": {k: inv[k] for k in
                          ("n_modules", "n_live", "n_dead", "dead_loc",
                           "dead_by_package", "dead")},
        }
        out.write_text(json.dumps(payload, indent=2) + "\n")
        print(f"wrote {os.path.relpath(out)}")

    if report.ok:
        print("contracts: clean")
        return 0
    print(f"contracts: {len(report.violations)} violation(s)")
    return 1 if args.strict else 0


if __name__ == "__main__":
    sys.exit(main())
