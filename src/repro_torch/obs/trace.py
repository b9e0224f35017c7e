"""Span tracer for the round pipeline.

A ``Span`` is a named, possibly nested phase of a round — schedule
(prefilter / pack / finalize), train (one span a size bucket), attack
apply, defense (aggregate / detect), eval — recorded on the monotonic
wall clock (``obs/clock.py``) and, while the async engine drives, on the
simulated event clock as well (``sim_t0`` / ``sim_t1``).

The hard contract is **zero semantic footprint**:

* telemetry never draws from the host RNG stream of record or a
  ``torch.Generator``, never reorders float64 accumulation, never reads
  or writes a tensor;
* telemetry never waits for the card: every attribute is a value the
  host already holds (numpy selections, Python ints, sizes), never an
  ``.item()``, ``.tolist()``, ``.cpu()`` or ``torch.cuda.synchronize()``.
  PyTorch returns before the card finishes, so on the card a span's wall
  time is host time up to the next point where the program itself waits
  (a numpy copy of accuracies, a scalar read), not the device time of
  the work it launched;
* the disabled tracer (``REPRO_TRACE=0``, the default) hands every call
  site the same shared ``_NullSpan`` singleton — no allocation, no clock
  read, no ring append;
* attributes are attached via ``span.set(key=value)`` inside an
  ``if trace.enabled()`` guard, so the hot path builds no keyword dicts
  while tracing is off.

The port has no jit cache; its one compile step is
``kernels/build.py::load``, a ``functools.cache`` over the nvcc-built
libraries. ``kernels_loaded()`` reads its size, which grows exactly when
a call built or loaded a kernel: a span that saw it grow carries
``compiled=True``.

Sinks: the in-memory ring (``tracer().spans``), a JSONL file keyed by
commit and environment (``flush_jsonl``), and a Chrome/Perfetto
``trace_event`` export (``to_trace_event``). Set ``REPRO_TRACE=1`` to
enable and ``REPRO_TRACE_FILE=/path.jsonl`` to flush the ring at
interpreter exit.
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import platform
import subprocess
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from repro_torch.kernels import build
from repro_torch.obs.clock import utc_stamp, wall_clock
from repro_torch.obs.metrics import MetricRegistry

_RING = 65536  # completed spans kept; oldest half dropped on overflow


class Span:
    """One timed phase. Use as a context manager; never reused."""

    __slots__ = ("name", "sid", "parent", "depth", "t0", "t1",
                 "sim_t0", "sim_t1", "attrs", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, sid: int,
                 parent: int, depth: int) -> None:
        self.name = name
        self.sid = sid
        self.parent = parent          # parent span's sid, -1 at root
        self.depth = depth
        self.t0 = self.t1 = 0.0       # wall clock (monotonic seconds)
        self.sim_t0 = self.sim_t1 = None  # simulated clock (async mode)
        self.attrs: Optional[Dict[str, Any]] = None
        self._tracer = tracer

    def set(self, **attrs: Any) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        tr._stack.append(self)
        if tr.sim_clock is not None:
            self.sim_t0 = tr.sim_clock()
        self.t0 = wall_clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = wall_clock()
        tr = self._tracer
        if tr.sim_clock is not None:
            self.sim_t1 = tr.sim_clock()
        if not tr._stack or tr._stack[-1] is not self:
            raise RuntimeError(f"span {self.name!r} closed out of order")
        tr._stack.pop()
        ring = tr.spans
        if len(ring) >= tr.ring_size:
            del ring[: tr.ring_size // 2]
        ring.append(self)
        return False

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": "span", "name": self.name,
                             "sid": self.sid, "parent": self.parent,
                             "depth": self.depth, "t0": self.t0,
                             "t1": self.t1, "dur": self.t1 - self.t0}
        if self.sim_t0 is not None:
            d["sim_t0"] = self.sim_t0
            d["sim_t1"] = self.sim_t1
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NullSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + ring + metric registry + optional sim clock."""

    def __init__(self, enabled: bool = False, path: Optional[str] = None,
                 ring_size: int = _RING) -> None:
        self.enabled = enabled
        self.path = path
        self.ring_size = ring_size
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self.sim_clock: Optional[Callable[[], float]] = None
        self.metrics = MetricRegistry()
        self._next_sid = 0

    def span(self, name: str) -> Union[Span, _NullSpan]:
        if not self.enabled:
            return NULL_SPAN
        sid = self._next_sid
        self._next_sid += 1
        parent = self._stack[-1].sid if self._stack else -1
        return Span(self, name, sid, parent, len(self._stack))

    def reset(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self.sim_clock = None
        self.metrics.reset()
        self._next_sid = 0


# --------------------------------------------------------------------- #
# module singleton — configured from the environment at import
# --------------------------------------------------------------------- #
_TRACER = Tracer(
    enabled=os.environ.get("REPRO_TRACE", "0") not in ("", "0"),
    path=os.environ.get("REPRO_TRACE_FILE") or None)
_ATEXIT_ARMED = False


def tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str) -> Union[Span, _NullSpan]:
    return _TRACER.span(name)


def traced(name: str):
    """Decorator form: time every call of ``fn`` as a span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _TRACER.enabled:
                return fn(*a, **kw)
            with _TRACER.span(name):
                return fn(*a, **kw)
        return wrapper
    return deco


def counter_inc(name: str, n: int = 1) -> None:
    if _TRACER.enabled:
        _TRACER.metrics.counter(name).inc(n)


def gauge_set(name: str, v: float) -> None:
    if _TRACER.enabled:
        _TRACER.metrics.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    if _TRACER.enabled:
        _TRACER.metrics.observation(name).add(v)


def set_sim_clock(fn: Optional[Callable[[], float]]) -> None:
    """Install (or clear, with None) the simulated-clock read used to
    dual-stamp spans. The async engine passes ``lambda: self.t_sim`` for
    the duration of its event loop."""
    if _TRACER.enabled:
        _TRACER.sim_clock = fn


def kernels_loaded() -> int:
    """Kernel libraries built or loaded so far in this process (the size
    of ``kernels/build.py::load``'s cache): it grows by one exactly when
    a call built or loaded a kernel."""
    return build.load.cache_info().currsize


def configure(enabled: Optional[bool] = None, path: Optional[str] = None,
              ring_size: Optional[int] = None, reset: bool = True) -> Tracer:
    """Reconfigure the singleton (tests, drivers). Resets the ring by
    default so runs do not bleed spans into each other."""
    if enabled is not None:
        _TRACER.enabled = enabled
    if path is not None:
        _TRACER.path = path or None
    if ring_size is not None:
        _TRACER.ring_size = ring_size
    if reset:
        _TRACER.reset()
    if _TRACER.enabled and _TRACER.path:
        _arm_atexit()
    return _TRACER


# --------------------------------------------------------------------- #
# sinks
# --------------------------------------------------------------------- #
def _meta() -> Dict[str, Any]:
    """Commit + environment key of a trace file: the commit, Python,
    torch, its CUDA version and numpy, and the card's name when the run
    used one."""
    import numpy
    import torch

    meta: Dict[str, Any] = {"kind": "meta", "commit": "unknown",
                            "python": platform.python_version(),
                            "timestamp": utc_stamp(),
                            "torch": torch.__version__,
                            "cuda": torch.version.cuda,
                            "numpy": numpy.__version__}
    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           capture_output=True, text=True, timeout=10,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        if r.returncode == 0 and r.stdout.strip():
            meta["commit"] = r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    if torch.cuda.is_initialized():
        meta["gpu"] = torch.cuda.get_device_name(torch.cuda.current_device())
    return meta


def flush_jsonl(path: Optional[str] = None) -> str:
    """Write the ring + metric snapshot as JSONL: one meta record, one
    record per span, one trailing metrics record."""
    tr = _TRACER
    path = path or tr.path
    if not path:
        raise ValueError("no trace path: pass one or set REPRO_TRACE_FILE")
    with open(path, "w") as f:
        f.write(json.dumps(_meta()) + "\n")
        for s in tr.spans:
            f.write(json.dumps(s.to_dict()) + "\n")
        f.write(json.dumps({"kind": "metrics",
                            **tr.metrics.snapshot()}) + "\n")
    return path


def load_jsonl(path: str):
    """Read a trace file back: (meta, span dicts, metrics dict)."""
    meta: Dict[str, Any] = {}
    spans: List[Dict[str, Any]] = []
    metrics: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "meta":
                meta = rec
            elif kind == "span":
                spans.append(rec)
            elif kind == "metrics":
                metrics = rec
    return meta, spans, metrics


def to_trace_event(spans: Optional[Sequence[Union[Span, Dict]]] = None
                   ) -> Dict[str, Any]:
    """Chrome/Perfetto ``trace_event`` JSON (complete 'X' events, µs).
    Accepts live ``Span`` objects or span dicts from ``load_jsonl``."""
    recs = [s.to_dict() if isinstance(s, Span) else s
            for s in (_TRACER.spans if spans is None else spans)]
    base = min((r["t0"] for r in recs), default=0.0)
    evs = []
    for r in recs:
        ev: Dict[str, Any] = {"name": r["name"], "ph": "X",
                              "ts": (r["t0"] - base) * 1e6,
                              "dur": max(r["t1"] - r["t0"], 0.0) * 1e6,
                              "pid": 0, "tid": 0}
        args = dict(r.get("attrs") or {})
        if r.get("sim_t0") is not None:
            args["sim_t0"] = r["sim_t0"]
            args["sim_t1"] = r["sim_t1"]
        if args:
            ev["args"] = args
        evs.append(ev)
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def phase_summary(spans: Optional[Sequence[Union[Span, Dict]]] = None
                  ) -> Dict[str, Dict[str, float]]:
    """Per-phase (span name) wall-time summary: count/total/p50/p95.
    Works on the live ring or on span dicts from ``load_jsonl``."""
    recs = [s.to_dict() if isinstance(s, Span) else s
            for s in (_TRACER.spans if spans is None else spans)]
    by_name: Dict[str, List[float]] = {}
    for r in recs:
        by_name.setdefault(r["name"], []).append(r["t1"] - r["t0"])
    out: Dict[str, Dict[str, float]] = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        out[name] = {"count": len(durs), "total_s": sum(durs),
                     "p50_s": _pct(durs, 0.50), "p95_s": _pct(durs, 0.95)}
    return out


def _flush_at_exit() -> None:
    if _TRACER.enabled and _TRACER.path:
        flush_jsonl(_TRACER.path)


def _arm_atexit() -> None:
    global _ATEXIT_ARMED
    if not _ATEXIT_ARMED:
        atexit.register(_flush_at_exit)
        _ATEXIT_ARMED = True


if _TRACER.enabled and _TRACER.path:
    _arm_atexit()
