"""Observability plane of the port.

Structured telemetry for the round pipeline: a span tracer with a
context-manager API (``obs/trace.py``), a counter/gauge/observation
registry (``obs/metrics.py``) and the package's ONLY wall-clock site
(``obs/clock.py``). The hard contract is **zero semantic footprint**:
telemetry never touches the host RNG stream of record, a
``torch.Generator``, the float64 accumulation order or a tensor, adds no
host read of a device value, and the disabled tracer (``REPRO_TRACE=0``,
the default) is a shared-singleton no-op.

Sinks: the in-memory ring, a JSONL trace file keyed by commit and
environment, a Chrome/Perfetto ``trace_event`` export, and
``python -m repro_torch.obs.report TRACE.jsonl`` for per-phase p50/p95
and roofline context against the H100.
"""
from repro_torch.obs import trace  # noqa: F401

__all__ = ["trace"]
