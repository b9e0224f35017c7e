"""Dispatch-trace contract checks of the port.

AST lints can't see through helper calls, so the dtype-pinning contract
is also enforced on what the key entry points actually run: each is run
under a ``TorchDispatchMode`` (``DtypeRecorder``) that records every
operator with the dtypes of its tensor inputs and outputs. The kernels are
operators of torch's dispatcher (``kernels/oplib.py``), so the trace sees
K1 as ``repro_torch.weighted_aggregate`` and K2 as
``repro_torch.robust_aggregate``: one operator each, on the card their
CUDA kernels, on the CPU their plain versions.

trace-f64
    The f32 data-plane programs — ``cohort_train``, ``cohort_eval``,
    ``fedavg_stacked``, the trimmed-mean and median aggregation through
    ``robust_aggregate``'s public wrapper, ``weighted_aggregate``,
    ``ModelAttack.apply_stacked`` — are run on float32 inputs, and no
    operator may take or make a float64 tensor (a ``_to_copy`` / ``to``
    to float64 shows as a float64 output). torch never narrows float64
    silently, so no switch like the JAX package's ``enable_x64`` is
    needed to make a stray promotion visible. NormClip's and Krum's
    float64 norms (core/defenses.py) are the documented exception and are
    not traced.

control-f64-pin
    The mirror contract: the control plane's device layout —
    ``core/control.py::_schedule_device`` and the float64 route of
    ``finalize_runs`` (``core/reputation.py::reputation_update_eq1``) —
    given float64 inputs must return float64 outputs: Eq. 1-3 and Eq. 9
    run in double precision, matching the host oracle's numpy dtype, or
    reputation streams fork.

static-args
    Every value the port groups runs by — the ``TASKS`` registry entries
    (``run_sweep`` buckets runs by task) — must be a hashable frozen
    dataclass. (The JAX package's half that requires literal
    ``static_argnames`` has no counterpart: the port has no jit.)

Any exception while building inputs or running an entry is itself
reported as a ``trace-error`` violation: a trace check that cannot run
must fail loudly, not pass silently.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.check.common import SRC_PREFIX, CheckContext, Violation

class DtypeRecorder(TorchDispatchMode):
    """Records ``(operator, input dtypes, output dtypes)`` for every
    operator dispatched under it, in order."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[str, tuple, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.calls.append((
            str(func.overloadpacket),
            tuple(t.dtype for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)),
            tuple(t.dtype for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor))))
        return out

    def ops(self) -> List[str]:
        """The operators run, each once, in order of first use."""
        return list(dict.fromkeys(name for name, _, _ in self.calls))

    def f64_sites(self) -> List[str]:
        """Human-readable descriptions of every float64 occurrence."""
        sites = []
        for name, ins, outs in self.calls:
            if torch.float64 in outs:
                sites.append(f"conversion to float64 <- {name}"
                             if name == "aten._to_copy"
                             and torch.float64 not in ins
                             else f"f64 intermediate <- {name}")
            elif torch.float64 in ins:
                sites.append(f"f64 input -> {name}")
        return sites


def record(fn: Callable[[], object]) -> Tuple[DtypeRecorder, object]:
    """Run ``fn()`` under a fresh ``DtypeRecorder``."""
    with DtypeRecorder() as rec:
        out = fn()
    return rec, out


def _trace_error(name: str, e: Exception) -> List[Violation]:
    return [Violation(rule="trace-error", path=name, line=0,
                      message=f"tracing `{name}` failed: {e!r}")]


def _no_f64(name: str, rec: DtypeRecorder) -> List[Violation]:
    return [Violation(
        rule="trace-f64", path=name, line=0,
        message=f"f32-path `{name}`: {site} — the data plane is "
                "f32-pinned") for site in rec.f64_sites()[:5]]


def _float_leaves(out) -> List[Tuple[str, object]]:
    """(description, dtype) of every floating tensor or array in ``out``."""
    leaves = tree_leaves(out)
    found = []
    for i, v in enumerate(leaves):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            found.append((f"output {i} ({v.dtype})", v.dtype))
        elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
            found.append((f"output {i} ({v.dtype})", v.dtype))
    return found


def _f64_outputs(name: str, out) -> List[Violation]:
    return [Violation(
        rule="control-f64-pin", path=name, line=0,
        message=f"control entry `{name}` {what} is not float64 — Eq. "
                "1-3/9 must match the host oracle's double precision")
        for what, dt in _float_leaves(out)
        if dt not in (torch.float64, np.dtype("float64"))]


def assert_no_f64(name: str, fn: Callable[[], object]) -> List[Violation]:
    """Run ``fn`` under the recorder and report every float64 site.
    Self-test entry point: any f32 program can be checked through this."""
    try:
        rec, _ = record(fn)
    except Exception as e:                          # noqa: BLE001
        return _trace_error(name, e)
    return _no_f64(name, rec)


def assert_f64_outputs(name: str, fn: Callable[[], object]
                       ) -> List[Violation]:
    """Run ``fn`` under the recorder; every floating output must be
    float64."""
    try:
        _, out = record(fn)
    except Exception as e:                          # noqa: BLE001
        return _trace_error(name, e)
    return _f64_outputs(name, out)


# --------------------------------------------------------------------- #
# repo entry points
# --------------------------------------------------------------------- #
N, S, U = 2, 8, 6          # clients, samples a client, evaluation units
R, K = 2, 4                # control runs, UEs a run


def trace_entries(device: torch.device) -> List[Tuple[str, str, Callable]]:
    """``(name, kind, fn)`` of every traced entry, in the JAX package's
    order; ``kind`` is "f32" (trace-f64) or "f64" (control-f64-pin).
    Each ``fn`` builds its inputs on ``device`` and runs the entry."""
    from repro_torch.configs.base import FeelConfig
    from repro_torch.core import control as ctl
    from repro_torch.core.attacks import ModelAttack
    from repro_torch.federated import cohort
    from repro_torch.federated.aggregation import fedavg_stacked
    from repro_torch.federated.task import TASKS
    from repro_torch.kernels.robust_aggregate import robust_aggregate
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate

    f32 = torch.float32
    task = TASKS["mnist_mlp"]

    def params():
        return task.init_params(
            torch.Generator(device=device).manual_seed(0), device)

    def stacked():
        return cohort.broadcast_params(params(), N)

    def train():
        data = {"x": torch.zeros((N, S, 784), dtype=f32, device=device),
                "y": torch.zeros((N, S), dtype=torch.int64, device=device)}
        mask = torch.ones((N, S), dtype=f32, device=device)
        return cohort.cohort_train(task, params(), data, mask, 0.1, 1, 4)

    def evaluate():
        ei = {"x": torch.zeros((U, 784), dtype=f32, device=device)}
        yu = torch.zeros((U,), dtype=torch.int64, device=device)
        masks = torch.ones((N, U), dtype=f32, device=device)
        return cohort.cohort_eval(task, stacked(), ei, yu, masks)

    def flat():
        return torch.zeros((4, 16), dtype=f32, device=device)

    def robust(mode, trim):
        return lambda: robust_aggregate(flat(), 4, trim=trim, mode=mode)

    cfg = FeelConfig(n_ues=K, n_malicious=0, min_selected=2)

    def state():
        full = lambda v: np.full((R, K), v, np.float64)   # noqa: E731
        return ctl.ControlState(
            policy_id=np.zeros(R, np.int32), sizes=full(100.0),
            divs=full(0.5), r_min=full(1e4), reputations=full(1.0),
            ages=full(1.0), cfg=cfg, device=device)

    def schedule():
        rank = np.tile(np.arange(K), (R, 1)).astype(np.float64)
        return ctl._schedule_device(state(), np.ones((R, K)), rank,
                                    np.full(R, 0.5), np.full(R, 0.5))[1:4]

    def finalize():
        st = state()
        ctl.finalize_runs(st, [np.array([0, 1]), np.array([2])],
                          [np.array([0.9, 0.8]), np.array([0.7])],
                          [np.array([0.85, 0.75]), np.array([0.6])],
                          penalties=[np.array([0.0, 0.1]), None],
                          kernel="device")
        return st.reputations, st.ages

    return [
        ("cohort.cohort_train", "f32", train),
        ("cohort.cohort_eval", "f32", evaluate),
        ("aggregation.fedavg_stacked", "f32",
         lambda: fedavg_stacked(stacked(), np.array([1.0, 3.0],
                                                    np.float32))),
        ("kernels.robust_aggregate[trimmed_mean]", "f32",
         robust("trimmed_mean", 1)),
        ("kernels.robust_aggregate[median]", "f32", robust("median", 0)),
        ("kernels.weighted_aggregate", "f32",
         lambda: weighted_aggregate(flat(), torch.ones(4, device=device))),
        ("attacks.ModelAttack.apply_stacked", "f32",
         lambda: ModelAttack(scale=-1.0).apply_stacked(
             stacked(), params(), np.array([True, False]))),
        ("control.finalize_runs[device]", "f64", finalize),
        ("control._schedule_device", "f64", schedule),
    ]


def trace_report(device) -> List[Dict]:
    """Run every entry of ``trace_entries`` on ``device``: for each, its
    name, kind, the operators it ran (in order of first use), the dtypes
    of its floating outputs and its violations."""
    out = []
    for name, kind, fn in trace_entries(torch.device(device)):
        try:
            rec, res = record(fn)
        except Exception as e:                      # noqa: BLE001
            out.append(dict(name=name, kind=kind, ops=[], outputs=[],
                            violations=_trace_error(name, e)))
            continue
        vs = _no_f64(name, rec) if kind == "f32" else _f64_outputs(name, res)
        out.append(dict(name=name, kind=kind, ops=rec.ops(),
                        outputs=[str(dt) for _, dt in _float_leaves(res)],
                        violations=vs))
    return out


def check_traces(ctx: CheckContext, device=None) -> List[Violation]:
    """The trace pass on ``device`` (default: the card; raises where CUDA
    is absent, before any entry runs)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return [v for e in trace_report(dev) for v in e["violations"]]


# --------------------------------------------------------------------- #
# static-arg discipline (the hashability half)
# --------------------------------------------------------------------- #
def check_static_args(ctx: CheckContext) -> List[Violation]:
    from repro_torch.federated.task import TASKS
    out: List[Violation] = []
    path = SRC_PREFIX + "federated/task.py"
    for name, t in sorted(TASKS.items()):
        try:
            hash(t)
        except TypeError:
            out.append(Violation(
                rule="static-args", path=path, line=1,
                message=f"task `{name}` is unhashable — the sweep groups "
                        "runs by task and must hash it"))
            continue
        if not (dataclasses.is_dataclass(t)
                and type(t).__dataclass_params__.frozen):
            out.append(Violation(
                rule="static-args", path=path, line=1,
                message=f"task `{name}` is not a frozen dataclass — a "
                        "mutable task silently splits or merges the "
                        "sweep's groups"))
    return out
