"""The ``--trace 1`` run's instrumentation and the reading of its trace.

``Tracer`` puts ``record_function`` spans around the port's public
entries that ``render_photonbeam`` calls (``trace_photon_beams``,
``camera_pass``), by wrapping them in the ``photonbeam`` module for the
run, and runs ``torch.profiler`` (CPU and CUDA) over a fixed few
iterations of one job inside the window.  It also keeps, for those
iterations, what the roofline yardstick counts from: each iteration's
beams and each gather sweep's segments (``gather_beams_packed``'s
inputs).  The trace is exported to a file under ``TMPDIR``, read, and
deleted.

``FitTracer`` does the same for a few steps of a fit's window: the step
is the span, and the walk's beams and the gathers' inputs are kept for
the yardstick of the forward and backward sweeps.

``Readings`` is what the metric readers see: spans with their device
ends, device operations, runtime calls, the profiled window, the
device's busy time in it, and the device time of what the autograd
engine's backward functions launched.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

SPAN_ITER = "bench.iteration"
SPANS = ("trace_photon_beams", "camera_pass")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function"
MAX_GAPS = 20000  # the longest idle gaps that the breakdown names
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuCtxSynchronize",
              "cuStreamSynchronize", "cuEventSynchronize")


class Tracer:
    """Profiles iterations ``first..last`` (0-based, inclusive) of window
    job ``job``."""

    def __init__(self, photonbeam, job: int, first: int, last: int):
        self.pb, self.job, self.first, self.last = photonbeam, job, first, last
        self.cur_job, self.it = -1, -1
        self.prof = None
        self.iter_span = None
        self.trace_file = None
        self.captures = []  # per profiled iteration: beams and sweeps
        self._orig = {}
        self.cuda = torch.cuda.is_available()

    def install(self) -> None:
        for name, wrap in (("trace_photon_beams", self._trace),
                           ("camera_pass", self._camera_pass),
                           ("gather_beams_packed", self._gather)):
            self._orig[name] = getattr(self.pb, name)
            setattr(self.pb, name, wrap)

    def uninstall(self) -> None:
        self._stop()
        for name, fn in self._orig.items():
            setattr(self.pb, name, fn)
        self._orig = {}

    def job_start(self, k: int) -> None:
        self.cur_job, self.it = k, -1

    def job_done(self) -> None:
        self._stop()

    # the wrappers -----------------------------------------------------
    def _trace(self, *args, **kw):
        self.it += 1
        if self.cur_job == self.job and self.it == self.first:
            self._start()
        elif self.prof is not None and self.it > self.last:
            self._stop()
        if self.prof is not None:
            self._close_iter_span()
            self.iter_span = torch.autograd.profiler.record_function(SPAN_ITER)
            self.iter_span.__enter__()
        with torch.autograd.profiler.record_function("trace_photon_beams"):
            beams, stats = self._orig["trace_photon_beams"](*args, **kw)
        if self.prof is not None:
            self.captures.append(dict(beams=beams, sweeps=[]))
        return beams, stats

    def _camera_pass(self, *args, **kw):
        with torch.autograd.profiler.record_function("camera_pass"):
            return self._orig["camera_pass"](*args, **kw)

    def _gather(self, beams_packed, n_valid, media, seg_a0, seg_a1, seg_dir,
                seg_medium, *args, **kw):
        if self.prof is not None and self.captures:
            cam_radius = args[1] if len(args) > 1 else kw["cam_radius"]
            self.captures[-1]["sweeps"].append(dict(
                a0=seg_a0.detach(), a1=seg_a1.detach(),
                medium=seg_medium.detach(), cam_radius=float(cam_radius)))
        return self._orig["gather_beams_packed"](
            beams_packed, n_valid, media, seg_a0, seg_a1, seg_dir, seg_medium,
            *args, **kw)

    # the profiler -----------------------------------------------------
    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _start(self) -> None:
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def _close_iter_span(self) -> None:
        if self.iter_span is not None:
            self.iter_span.__exit__(None, None, None)
            self.iter_span = None

    def _stop(self) -> None:
        if self.prof is None:
            return
        self._close_iter_span()
        self._sync()
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(path)
        self.trace_file = path
        self.prof = None

    def readings(self, hetero: bool, extras: bool = False) -> "Readings":
        """Read and delete the exported trace; ``hetero`` says whether the
        scene's medium is a density grid and ``extras`` whether the
        backward computes the extra cotangents (the yardstick's
        operations)."""
        if self.trace_file is None:
            raise RuntimeError("the traced iterations never ran: the window "
                               "ended before them")
        try:
            with open(self.trace_file) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(self.trace_file)
            self.trace_file = None
        return Readings(events, self.captures, hetero, extras)


class FitTracer(Tracer):
    """Profiles steps ``first..last`` (0-based, inclusive) of a fit's
    window.  ``install`` is called just before window step 0 and
    ``step_done(k)`` when window step k has ended."""

    def __init__(self, mesh, photonbeam, first: int, last: int):
        super().__init__(photonbeam, 0, first, last)
        self.mesh = mesh

    def install(self) -> None:
        self._orig["gather_beams_packed"] = self.pb.gather_beams_packed
        self.pb.gather_beams_packed = self._gather
        self._orig_walk = self.mesh.trace_photon_beams_by_index
        self.mesh.trace_photon_beams_by_index = self._walk
        self._boundary(0)

    def uninstall(self) -> None:
        super().uninstall()
        if getattr(self, "_orig_walk", None) is not None:
            self.mesh.trace_photon_beams_by_index = self._orig_walk
            self._orig_walk = None

    def step_done(self, k: int) -> None:
        self._boundary(k + 1)

    def _boundary(self, nxt: int) -> None:
        """Window step ``nxt`` is about to start."""
        if nxt == self.first:
            self._start()
        elif nxt > self.last:
            self._stop()
        if self.prof is not None:
            self._close_iter_span()
            self.iter_span = torch.autograd.profiler.record_function(SPAN_ITER)
            self.iter_span.__enter__()

    def _walk(self, *args, **kw):
        beams, stats = self._orig_walk(*args, **kw)
        if self.prof is not None:
            self.captures.append(dict(beams=beams, sweeps=[]))
        return beams, stats


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace tag and
    argument list."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:160]


class Readings:
    """The profiled window of a traced run, in seconds.  Built from the
    Chrome trace's events (timestamps in microseconds, host and device on
    one clock)."""

    def __init__(self, events: list, captures: list, hetero: bool = False,
                 extras: bool = False):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        for e in xs:
            e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
        cat = lambda e: e.get("cat", "")  # noqa: E731
        iters = [e for e in xs if cat(e) == "user_annotation"
                 and e["name"] == SPAN_ITER]
        if not iters:
            raise RuntimeError("no profiled iteration in the trace")
        self.n_iterations = len(iters)
        self.t0 = min(e["ts"] for e in iters)
        self.t1 = max(e["ts"] + e["dur"] for e in iters)
        inside = lambda e: self.t0 <= e["ts"] <= self.t1  # noqa: E731
        self.device = [e for e in xs if cat(e) in DEVICE_CATS and inside(e)]
        self.runtime = [e for e in xs if cat(e) in RUNTIME_CATS and inside(e)]
        self.host = [e for e in xs if cat(e) in HOST_CATS and inside(e)]
        self.spans = [e for e in xs if cat(e) == "user_annotation"
                      and inside(e)]
        self.captures, self.hetero, self.extras = captures, hetero, extras
        dev_by_corr = defaultdict(float)
        self._dev_ops_by_corr = defaultdict(list)
        for e in self.device:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                dev_by_corr[c] = max(dev_by_corr[c], e["ts"] + e["dur"])
                self._dev_ops_by_corr[c].append(e)
        self._backward = defaultdict(list)
        for e in self.host:
            if e["name"].startswith(BACKWARD):
                self._backward[e.get("tid")].append(
                    [e["ts"], e["ts"] + e["dur"]])
        self._backward = {t: _merge(v) for t, v in self._backward.items()}
        # each runtime call's launch time and the end of what it launched
        corr = lambda e: e.get("args", {}).get("correlation")  # noqa: E731
        self._launch = sorted((e["ts"], dev_by_corr[corr(e)])
                              for e in self.runtime if corr(e) in dev_by_corr)
        self._launch_ts = [t for t, _ in self._launch]
        self.busy_intervals = _merge(
            [max(self.t0, e["ts"]), min(self.t1, e["ts"] + e["dur"])]
            for e in self.device if e["ts"] + e["dur"] > self.t0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) * 1e-6

    def span_s(self, name: str) -> float | None:
        """The spans' total time, each from its host start to the later of
        its host end and the end of the last device operation launched
        inside it; None where the trace holds no such span."""
        found = [e for e in self.spans if e["name"] == name]
        if not found:
            return None
        total = 0.0
        for e in found:
            a, b = e["ts"], e["ts"] + e["dur"]
            lo = bisect.bisect_left(self._launch_ts, a)
            hi = bisect.bisect_right(self._launch_ts, b)
            end = max([b] + [d for _, d in self._launch[lo:hi]])
            total += end - a
        return total * 1e-6

    def device_s(self, names) -> float | None:
        """Device time of the operations whose names contain any of
        ``names``; None where none ran."""
        found = [e["dur"] for e in self.device
                 if any(n in e["name"] for n in names)]
        return sum(found) * 1e-6 if found else None

    def backward_ops(self) -> list:
        """The device operations launched from inside the autograd
        engine's backward functions."""
        out = []
        for e in self.runtime:
            iv = self._backward.get(e.get("tid"))
            if not iv:
                continue
            i = bisect.bisect_right([a for a, _ in iv], e["ts"]) - 1
            if i >= 0 and e["ts"] <= iv[i][1]:
                out.extend(self._dev_ops_by_corr.get(
                    e.get("args", {}).get("correlation"), []))
        return out

    def backward_s(self, names=None) -> float | None:
        """Device time of what the backward functions launched (only the
        operations whose names contain one of ``names``, where given);
        None where nothing was."""
        found = [e["dur"] for e in self.backward_ops()
                 if names is None or any(n in e["name"] for n in names)]
        return sum(found) * 1e-6 if found else None

    def host_syncs(self) -> int:
        return sum(1 for e in self.runtime if e["name"] in SYNC_CALLS)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing in them."""
        per_op = defaultdict(float)
        for e in self.device:
            per_op[short_name(e["name"])] += e["dur"] * 1e-6
        gaps = []
        prev = self.t0
        for a, b in self.busy_intervals:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        spans = sorted((e for e in self.spans if e["name"] in SPANS),
                       key=lambda e: e["ts"])
        per_gap = defaultdict(float)
        for a, b in gaps[:MAX_GAPS]:
            mid = 0.5 * (a + b)
            what = "host"
            i = bisect.bisect_right(starts, mid) - 1
            for e in host[max(0, i - 100):i + 1][::-1]:
                if e["ts"] + e["dur"] >= mid and e["name"] not in SPANS \
                        and e["name"] != SPAN_ITER:
                    what = e["name"]
                    break
            outer = [s["name"] for s in spans
                     if s["ts"] <= mid <= s["ts"] + s["dur"]]
            key = f"{outer[-1]}/{what}" if outer else what
            per_gap[key] += (b - a) * 1e-6
        rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                                key=lambda kv: -kv[1])[:top]
        return dict(device_ops=rank(per_op), idle_gaps=rank(per_gap))
