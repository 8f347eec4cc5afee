"""Statistics and profiling, the same surface as ``bre_tpu/utils/stats.py``.

pbrt's stats (stats.{h,cpp}): STAT_* counters printed grouped by
"Category/Title" (StatsAccumulator::Print, stats.cpp:105-187), named
profiler phases (ProfilePhase, stats.h:138-189) and the SIGPROF sampling
profiler (stats.cpp:204-233).

Counters are plain entries of the metrics dicts that the renders return;
``StatsAccumulator`` sums them and prints pbrt's report.  ``profile_phase``
is a ``torch.profiler.record_function`` range, and ``trace_to`` records a
``torch.profiler`` trace (the card's kernels too on a CUDA device) and
writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
from collections import defaultdict
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..scene.scene import resolve_device


class StatsAccumulator:
    """Accumulate "Category/Title" -> value counters across iterations
    (StatsAccumulator, stats.cpp:105-187)."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = defaultdict(float)

    def add(self, metrics: Dict[str, object], prefix: str = "") -> None:
        for k, v in metrics.items():
            if isinstance(v, dict):
                self.add(v, prefix=f"{prefix}{k}/")
            else:
                try:
                    self._counters[prefix + k] += float(v)
                except (TypeError, ValueError, RuntimeError):
                    pass  # not a scalar (a multi-element tensor raises this)

    def report(self) -> str:
        """Grouped category report (the pbrt stats block format)."""
        groups: Dict[str, Dict[str, float]] = defaultdict(dict)
        for key, val in sorted(self._counters.items()):
            cat, _, title = key.rpartition("/")
            groups[cat or "General"][title or key] = val
        lines = ["Statistics:"]
        for cat in sorted(groups):
            lines.append(f"  {cat}")
            for title, val in sorted(groups[cat].items()):
                if val == int(val):
                    lines.append(f"    {title:<42}{int(val):>16,d}")
                else:
                    lines.append(f"    {title:<42}{val:>16.3f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self._counters)


@contextlib.contextmanager
def profile_phase(name: str):
    """Named trace range (the ProfilePhase analog): a ``record_function``
    range in the trace that ``trace_to`` writes."""
    with record_function(name):
        yield


@contextlib.contextmanager
def trace_to(log_dir: str, device="cuda"):
    """Record a torch.profiler trace of the block (the SIGPROF profiler's
    analog): CPU and CUDA activities on a CUDA device, the CPU's alone on
    ``device="cpu"``.  Writes ``log_dir/trace.json`` (a Chrome trace) when
    the block ends; yields the profiler."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
