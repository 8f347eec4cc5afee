"""The port's own spans and counters (``bre_tpu_torch.utils.stats``): off,
``profile_phase`` is one shared null context and ``count`` records
nothing; under a profiler, a tiny grid-medium render on the packed route
shows the walk, camera-pass, pack, per-step and tracking-trip spans, and
counts the gather's blocks.  The render's stats dict keeps the ints that
a host read per iteration gave.  Imports no JAX; about 5 s on one core."""

import contextlib
import json
import os

import pytest
import torch

from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene.builder import SceneBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera
from bre_tpu_torch.utils import stats as TS
from torch_parity import SMOKE_LOOK, smoke_density, smoke_hetero

WH, PHOTONS = 16, 256
SPANS = ("bre.walk", "bre.camera_pass", "bre.pack", "bre.camera.intersect",
         "bre.camera.gather", "bre.camera.light", "bre.track.trip")


def _render(iterations=1, **cfg):
    scene = smoke_hetero(SceneBuilder(), density=smoke_density(4),
                         device="cpu")
    cam = make_perspective_camera(ttfm.look_at(*SMOKE_LOOK), 50.0, WH, WH,
                                  device="cpu")
    pcfg = tpb.PhotonBeamConfig(
        iterations=iterations, maxdepth=3, photonsperiteration=PHOTONS,
        initialbeamradius=0.15, gather="pallas", grad_geometry=False,
        grad_extras=False, **cfg)
    return tpb.render_photonbeam(scene, cam, WH, WH, pcfg)


def test_off_phase_is_shared_null_and_count_records_nothing():
    assert not torch._C._autograd._profiler_enabled()
    a, b = TS.profile_phase("bre.walk"), TS.profile_phase("bre.pack")
    assert a is b and isinstance(a, contextlib.nullcontext)
    TS.reset_counters()

    def never():
        raise AssertionError("a count's callable ran with tracing off")
    TS.count("gather.blocks", 3)
    TS.count("gather.live_blocks", never)
    assert TS.counters() == {}


@pytest.mark.parametrize("sparse_cap", [0, 1 << 20])
def test_traced_render_shows_spans_and_counts_blocks(tmp_path, sparse_cap):
    TS.reset_counters()
    with TS.trace_to(str(tmp_path), device="cpu"):
        _render(gather_sparse_cap=sparse_cap)
    got = TS.counters()
    TS.reset_counters()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for name in SPANS:
        assert by_name.get(name), name
    assert len(by_name["bre.walk"]) == len(by_name["bre.camera_pass"]) == 1
    outer = by_name["bre.walk"] + by_name["bre.camera_pass"]
    for a, b in by_name["bre.track.trip"]:
        assert any(lo <= a and b <= hi for lo, hi in outer)
    assert got["gather.blocks"] >= got["gather.live_blocks"] > 0
    assert isinstance(got["gather.blocks"], int)
    assert isinstance(got["gather.live_blocks"], int)
    # each packed sweep's rays, and those in the medium (a device sum)
    assert got["gather.rays"] >= got["gather.rays_in_medium"] > 0
    assert isinstance(got["gather.rays"], int)
    # every sweep counts itself and its pick, 0 or 1; only the full-film
    # sweeps take the cap, the ray budgets' take none
    sweeps, picks = got["gather.sweeps"], got["gather.sparse_picks"]
    assert 1 <= sweeps <= len(by_name["bre.camera.gather"])
    if sparse_cap == 0:
        assert picks == 0
    else:
        assert 1 <= picks <= sweeps


def test_render_stats_hold_the_ints_of_a_read_per_iteration(monkeypatch):
    """Each iteration's walk and camera-pass stats, read on the host as the
    render read them before it kept device sums, add up to the returned
    dict, whose values are Python ints."""
    seen = []
    real_trace, real_pass = tpb.trace_photon_beams, tpb.camera_pass

    def trace(*a, **kw):
        beams, st = real_trace(*a, **kw)
        seen.append(st)
        return beams, st

    def camera_pass(*a, **kw):
        Ld, st = real_pass(*a, **kw)
        seen.append(st)
        return Ld, st
    monkeypatch.setattr(tpb, "trace_photon_beams", trace)
    monkeypatch.setattr(tpb, "camera_pass", camera_pass)
    _, st = _render(iterations=2)
    want = {}
    for s in seen:
        for k, v in s.items():
            want[k] = want.get(k, 0) + int(v)
    assert len(seen) == 4
    assert {k: v for k, v in st.items() if k != "final_radius"} == want
    assert all(type(v) is int for k, v in st.items() if k != "final_radius")
    assert want["n_beams"] > 0 and want["n_medium_scatter"] > 0
