"""Statistics and profiling, the same surface as ``bre_tpu/utils/stats.py``.

pbrt's stats (stats.{h,cpp}): STAT_* counters printed grouped by
"Category/Title" (StatsAccumulator::Print, stats.cpp:105-187), named
profiler phases (ProfilePhase, stats.h:138-189) and the SIGPROF sampling
profiler (stats.cpp:204-233).

Counters are plain entries of the metrics dicts that the renders return;
``StatsAccumulator`` sums them and prints pbrt's report.  ``trace_to``
records a ``torch.profiler`` trace (the card's kernels too on a CUDA
device) and writes it as a Chrome trace.

The program's own measurement is gated on the profiler: ``profile_phase``
opens a ``record_function`` range (a Kineto range, on the clock of the
device operations in the same trace) and ``count`` adds to a module-level
counter only while a profiler records; otherwise each costs one flag
check.  Program spans are named ``bre.<layer>.<what>``.
"""

from __future__ import annotations

import contextlib
import functools
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

    def count(self, name: str, value) -> None:
        """Add ``value`` to counter ``name``; a tensor is added where it
        lives, with no host read."""
        self._counters[name] = self._counters.get(name, 0) + value

    def reset(self) -> None:
        self._counters.clear()

    def as_dict(self) -> Dict[str, float]:
        """The counters as numbers; a tensor counter is read here, once."""
        return {k: v.item() if isinstance(v, torch.Tensor) else v
                for k, v in self._counters.items()}


_profiling = torch._C._autograd._profiler_enabled
_NULL_PHASE = contextlib.nullcontext()
_COUNTERS = StatsAccumulator()


def profile_phase(name: str):
    """Named trace range (the ProfilePhase analog): a ``record_function``
    range while a profiler records, else one shared null context."""
    return record_function(name) if _profiling() else _NULL_PHASE


def traced(name: str):
    """Decorator: the whole call runs inside ``profile_phase(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with profile_phase(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, value) -> None:
    """Add ``value`` to the module's counter ``name`` while a profiler
    records, so a traced run counts exactly what it profiled.  A tensor
    is added on its device; a callable is called only while recording
    (for a value that costs device work to compute)."""
    if _profiling():
        _COUNTERS.count(name, value() if callable(value) else value)


def counters() -> Dict[str, float]:
    """The module's counters, each tensor read once (call it after the
    profiler has stopped)."""
    return _COUNTERS.as_dict()


def reset_counters() -> None:
    _COUNTERS.reset()


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
