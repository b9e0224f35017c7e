"""The port's only wall-clock site.

Everything under ``src/repro_torch`` that wants real time goes through
``wall_clock()``: ``tests/test_torch_hygiene.py`` rejects an import of
``time``, ``datetime`` or ``timeit`` in any other module of the package.
The clock is monotonic: telemetry measures durations, never calendar
time, so suspend or NTP steps cannot produce negative spans.

``utc_stamp()`` exists for sink *metadata only* (a trace file is keyed by
commit, environment and timestamp); it must never feed a traced value or
a simulation input.
"""
from __future__ import annotations

import datetime
import time


def wall_clock() -> float:
    """Monotonic wall-clock seconds (arbitrary epoch, durations only)."""
    return time.monotonic()


def utc_stamp() -> str:
    """ISO-8601 UTC timestamp for sink metadata records."""
    return datetime.datetime.now(datetime.timezone.utc).isoformat()
