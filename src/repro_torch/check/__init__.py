"""repro_torch.check — the port's static contract checker.

Run as ``python -m repro_torch.check [--strict] [--json] [--device D]``
(or the ``repro-torch-check`` console script). It is the JAX package's
``repro.check`` pointed at ``src/repro_torch``, and is gated by
``tests/test_torch_check.py``: the suite fails if any checker reports a
violation on the port.

What is enforced (and why) lives in the rule modules' docstrings:

- ``lints``     — AST lints: oracle purity, host syncs on a kernel's
                  launch path, nondeterminism and the wall clock, dtype
                  discipline;
- ``registry``  — registry–test cross-referencing + kernel ``_ref``
                  twins, operators and tests;
- ``trace``     — dispatch-trace dtype pinning (through the K1 and K2
                  operators) + the tasks' hashability;
- ``inventory`` — dead-inheritance report (informational, never fails).

The trace pass runs the entries on a device: the card by default, which
raises where CUDA is absent; ``device="cpu"`` runs it on the CPU. The AST
passes need no device. Intentional exceptions are waived per line with
``# repro: allow(rule-name)`` (see ``common.parse_waivers``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List

from repro_torch.check.common import (CheckContext, SourceFile, Violation,
                                      make_context)
from repro_torch.check.inventory import build_inventory
from repro_torch.check.lints import (check_dtype, check_host_sync,
                                     check_nondeterminism,
                                     check_oracle_purity)
from repro_torch.check.registry import check_kernel_twins, check_registries
from repro_torch.check.trace import check_static_args, check_traces

# ordered: cheap AST passes first, the run-the-entries trace check last
CHECKERS: Dict[str, Callable[[CheckContext], List[Violation]]] = {
    "oracle-purity": check_oracle_purity,
    "host-sync": check_host_sync,
    "nondeterminism": check_nondeterminism,
    "dtype": check_dtype,
    "registry-coverage": check_registries,
    "kernel-ref-twin": check_kernel_twins,
    "static-args": check_static_args,
    "trace": check_traces,
}


@dataclasses.dataclass
class CheckReport:
    violations: List[Violation]
    inventory: Dict
    per_checker: Dict[str, int]

    @property
    def ok(self) -> bool:
        return not self.violations


def repo_root() -> Path:
    """The repo root: three parents up from this package
    (src/repro_torch/check -> repo)."""
    return Path(__file__).resolve().parents[3]


def run_checks(root: Path = None, skip_trace: bool = False,
               device=None) -> CheckReport:
    """Run every checker over ``root`` (default: this repo); the trace
    pass on ``device`` (default: the card, raising without CUDA)."""
    ctx = make_context(root or repo_root())
    violations: List[Violation] = []
    per: Dict[str, int] = {}
    for name, chk in CHECKERS.items():
        if name == "trace":
            if skip_trace:
                per[name] = -1
                continue
            vs = chk(ctx, device)
        else:
            vs = chk(ctx)
        per[name] = len(vs)
        violations.extend(vs)
    return CheckReport(violations=violations,
                       inventory=build_inventory(ctx), per_checker=per)


__all__ = ["CHECKERS", "CheckReport", "CheckContext", "SourceFile",
           "Violation", "make_context", "repo_root", "run_checks"]
