"""The readers of the program's own spans and counters, on synthetic
Chrome traces with known spans, device busy time and counters; and the
program's span names against the harness's own."""

import re

import pytest

from harness import profiling, spec

ROOT = spec.ROOT
NEW = ("track_trips_per_iter.render", "walk_idle_ms.render",
       "camera_idle_ms.render", "pack_ms.render",
       "fwd_live_block_pct.render", "walk_ms.fit", "camera_pass_ms.fit",
       "optimizer_ms.fit", "camera_intersect_idle_ms.render",
       "camera_gather_idle_ms.render", "camera_light_idle_ms.render",
       "fwd_sparse_pick_pct.render")
COUNTERS = ("fwd_live_block_pct.render", "fwd_sparse_pick_pct.render")


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py", name)


def _span(name, ts, dur, tid=1):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur,
                tid=tid)


def _kernel(ts, dur, corr):
    return dict(ph="X", cat="kernel", name="k", ts=ts, dur=dur,
                args=dict(correlation=corr))


def _launch(ts, corr):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts,
                dur=2, tid=1, args=dict(correlation=corr))


def _trace(program=True):
    """Two iterations of 1000 us.  In each: a walk [100, 400) with three
    tracking trips and 100 us (then 50 us) of device work, a camera pass
    [500, 900) holding a pack [520, 560) that launches a kernel running
    [540, 600) and the depth steps' intersect [570, 620), gather
    [620, 700) and light sampling [700, 850), and an optimizer [950, 990)
    that launches one running [960, 1000)."""
    ev = []
    corr = 0
    for k, base in enumerate((0.0, 1000.0)):
        ev.append(_span(profiling.SPAN_ITER, base, 1000))
        busy_walk = 100 if k == 0 else 50
        for ts, dur in ((base + 150, busy_walk), (base + 540, 60),
                        (base + 960, 40)):
            corr += 1
            ev.append(_launch(ts - 10, corr))
            ev.append(_kernel(ts, dur, corr))
        if not program:
            continue
        ev.append(_span("bre.walk", base + 100, 300))
        for t in (110, 200, 300):
            ev.append(_span("bre.track.trip", base + t, 50))
        ev.append(_span("bre.camera_pass", base + 500, 400))
        ev.append(_span("bre.pack", base + 520, 40))
        ev.append(_span("bre.camera.intersect", base + 570, 50))
        ev.append(_span("bre.camera.gather", base + 620, 80))
        ev.append(_span("bre.camera.light", base + 700, 150))
        ev.append(_span("bre.optimizer", base + 950, 40))
    return ev


def _readings(program=True):
    return profiling.Readings(_trace(program), [])


def test_span_readers_read_the_synthetic_trace():
    rd = _readings()
    assert rd.n_iterations == 2
    got = {n: _reader(n).read(rd) for n in NEW if n not in COUNTERS}
    assert got["track_trips_per_iter.render"] == 3.0
    # walk: 300 us less 100 and 50 us busy; camera pass: 400 less 60
    assert got["walk_idle_ms.render"] == pytest.approx((200 + 250) / 2e3)
    assert got["camera_idle_ms.render"] == pytest.approx(340 / 1e3)
    # each span runs to the end of its last kernel
    assert got["pack_ms.render"] == pytest.approx(80 / 1e3)
    assert got["optimizer_ms.fit"] == pytest.approx(50 / 1e3)
    assert got["walk_ms.fit"] == pytest.approx(300 / 1e3)
    assert got["camera_pass_ms.fit"] == pytest.approx(400 / 1e3)
    # the depth steps: intersect 50 us less the kernel's last 30, the
    # gather and the light sampling with no device work
    assert got["camera_intersect_idle_ms.render"] == pytest.approx(20 / 1e3)
    assert got["camera_gather_idle_ms.render"] == pytest.approx(80 / 1e3)
    assert got["camera_light_idle_ms.render"] == pytest.approx(150 / 1e3)
    steps = sum(got[f"camera_{s}_idle_ms.render"]
                for s in ("intersect", "gather", "light"))
    assert steps <= got["camera_idle_ms.render"]
    idle_ms = (rd.window_s - rd.busy_s) * 1e3 / rd.n_iterations
    assert got["walk_idle_ms.render"] + got["camera_idle_ms.render"] \
        <= idle_ms


def test_span_readers_find_nothing_in_a_program_without_spans():
    rd = _readings(program=False)
    for n in NEW:
        if n not in COUNTERS:
            assert _reader(n).read(rd) is None, n


def test_live_block_share_reads_the_program_counters(monkeypatch):
    from bre_tpu_torch.utils import stats
    reader = _reader("fwd_live_block_pct.render")
    rd = _readings()
    monkeypatch.setattr(stats, "counters", lambda: {
        "gather.blocks": 200, "gather.live_blocks": 50})
    assert reader.read(rd) == pytest.approx(25.0)
    monkeypatch.setattr(stats, "counters", lambda: {})
    assert reader.read(rd) is None
    # a program that keeps no counters
    monkeypatch.delattr(stats, "counters")
    assert reader.read(rd) is None


def test_sparse_pick_share_reads_the_program_counters(monkeypatch):
    from bre_tpu_torch.utils import stats
    reader = _reader("fwd_sparse_pick_pct.render")
    rd = _readings()
    monkeypatch.setattr(stats, "counters", lambda: {
        "gather.sweeps": 8, "gather.sparse_picks": 2})
    assert reader.read(rd) == pytest.approx(25.0)
    # sweeps that never took the sparse kernel read 0, not nothing
    monkeypatch.setattr(stats, "counters", lambda: {
        "gather.sweeps": 8, "gather.sparse_picks": 0})
    assert reader.read(rd) == 0.0
    monkeypatch.setattr(stats, "counters", lambda: {})
    assert reader.read(rd) is None
    monkeypatch.delattr(stats, "counters")
    assert reader.read(rd) is None


def test_program_spans_never_reuse_a_harness_name():
    """Readings.span_s sums every span of a name: a program span named as
    one of the harness's would double its metric."""
    harness = set(profiling.SPANS) | {profiling.SPAN_ITER,
                                      "gather_beams_packed"}
    pat = re.compile(r"""(?:profile_phase|traced)\(\s*["']([^"']+)["']""")
    names = set()
    for p in (ROOT / "bre_tpu_torch").rglob("*.py"):
        names |= set(pat.findall(p.read_text()))
    assert {"bre.walk", "bre.camera_pass", "bre.pack", "bre.track.trip",
            "bre.optimizer", "bre.camera.intersect", "bre.camera.gather",
            "bre.camera.light"} <= names
    for n in names:
        assert n.startswith("bre.") and n not in harness, n
