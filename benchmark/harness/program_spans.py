"""Readings of the program's own measurement in a traced run: its spans,
named ``bre.<layer>.<what>`` (``bre_tpu_torch.utils.stats.profile_phase``),
and its counters (``stats.counters()``).  The program emits both only
while the profiler records.  Each reading is None where the program has
no such span or counter, as a program without them has none."""

from __future__ import annotations

import bisect

from .profiling import _merge


def intervals(rd, name: str) -> list:
    """The host intervals of the spans named ``name``, merged; [] where
    the trace holds none."""
    return _merge([e["ts"], e["ts"] + e["dur"]] for e in rd.spans
                  if e["name"] == name)


def count(rd, name: str) -> int | None:
    n = sum(1 for e in rd.spans if e["name"] == name)
    return n or None


def idle_s(rd, name: str) -> float | None:
    """Device-idle seconds inside the spans named ``name``: their host
    time less the device's busy time within it."""
    spans = intervals(rd, name)
    if not spans:
        return None
    busy = rd.busy_intervals
    starts = [a for a, _ in busy]
    idle = 0.0
    for a, b in spans:
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        idle += (b - a) - covered
    return idle * 1e-6


def counter(name: str):
    """The program's counter ``name``; None where the program keeps no
    such counter."""
    from bre_tpu_torch.utils import stats
    read = getattr(stats, "counters", None)
    return None if read is None else read().get(name)
