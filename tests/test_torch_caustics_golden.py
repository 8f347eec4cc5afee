"""The glass-caustics golden gate (BASELINE config 4, cut to 64x64) through
bre_tpu_torch on the CPU: the port's counterpart of
tests/test_reference_golden_caustics.py, with its scenes, sizes and bounds.
``tests/data/caustics_golden{,8}.pfm`` were rendered by the C++ reference
(refbuild/build.sh, one thread): a glass sphere in fog lit by two point
lights, 64x64, {1, 8} iterations x 20,000 photons, maxdepth 6; reference
statistics 13,695 medium interactions and 41,381 beams at 1 iteration,
111,394 interactions at 8.

- The 1-iteration compat photon pass: its totals within 0.5% of the
  reference's, and per photon against bre_tpu's compat walk on the first
  2,048 photons (bre_tpu's walk on all 20,000 runs in the reference's own
  test).  The photons whose medium or surface counts differ are bounded by
  the ULP flips bre_tpu's walk shows against the C++ reference on all
  20,000 photons: 1 medium and 7 surface.
- The camera pass against caustics_golden.pfm: channel means within 6%
  and the 75th percentile of the 8x8 region means of R within 25%.
- The 8-iteration progressive render against caustics_golden8.pfm
  (``slow``, ~7 minutes on one core: ``RUN_SLOW=1``; on a card it runs in
  chip_smoke.py phase 34): interactions within 0.2%, channel means within
  1.5%, region p90 under 0.12 and max under 0.5.
- The compat pair cull (``beam_gather._compat_contrib``), which lets the
  camera pass run in about a minute on one core, equals the dense pair sum
  bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from bre_tpu_torch.accel import beam_gather as tbg
from bre_tpu_torch.integrators.photon_trace import trace_photon_beams_compat
from bre_tpu_torch.integrators.photonbeam import (PhotonBeamConfig,
                                                  camera_pass,
                                                  render_photonbeam)
from bre_tpu_torch.io.image import read_image
from bre_tpu_torch.lights import light_power_distribution
from bre_tpu_torch.scene.parser import parse_file
from torch_parity import to_np

DATA = Path(__file__).parent / "data"
GOLDEN_PBRT = str(DATA / "caustics_golden.pbrt")
PHOTONS = 20000
# bre_tpu's walk against the C++ reference on all 20,000 photons
# (tests/test_reference_golden_caustics.py): photons whose counts differ
ULP_FLIPS = dict(lane_medium=1, lane_surface=7)


def _regions(img):
    return img.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3))[..., 0]


def _region_rel(img, golden):
    rg, ro = _regions(golden), _regions(img)
    return np.abs(ro - rg) / np.maximum(rg, rg.max() * 0.1)


def caustics_pass(device):
    """The 1-iteration compat photon pass and camera pass on ``device``,
    held to the reference test's bounds.  Returns (image, stats)."""
    ps = parse_file(GOLDEN_PBRT, device=device)
    scene = ps.build(device=device)
    beams, stats = trace_photon_beams_compat(
        scene, light_power_distribution(scene),
        torch.arange(PHOTONS, device=scene.device), 6, 0.15)
    assert abs(int(stats["n_medium_scatter"]) - 13695) / 13695 < 0.005, stats
    assert abs(int(stats["n_beams"]) - 41381) / 41381 < 0.005, stats
    cfg = PhotonBeamConfig(iterations=1, maxdepth=6,
                           photonsperiteration=PHOTONS,
                           initialbeamradius=0.15, kernel="compat")
    Ld, _ = camera_pass(scene, ps.camera, 64, 64, beams, 0.15, 0, cfg,
                        PHOTONS)
    img = Ld.cpu().numpy().reshape(64, 64, 3)
    golden = np.asarray(read_image(str(DATA / "caustics_golden.pfm")))
    assert img.shape == golden.shape and np.isfinite(img).all()
    for c in range(3):
        gm, om = golden[..., c].mean(), img[..., c].mean()
        assert abs(om - gm) / gm < 0.06, (c, gm, om)
    rel = _region_rel(img, golden)
    assert float(np.percentile(rel, 75)) < 0.25, rel
    return img, stats


def caustics_gate(device, iterations=8):
    """test_compat_caustics_8iter_matches_reference_golden on ``device``.
    Returns (image, stats)."""
    ps = parse_file(str(DATA / "caustics_golden8.pbrt"), device=device)
    scene = ps.build(device=device)
    cfg = PhotonBeamConfig(iterations=iterations, maxdepth=6,
                           photonsperiteration=PHOTONS,
                           initialbeamradius=0.15, alpha=0.5, kernel="compat")
    img, stats = render_photonbeam(scene, ps.camera, 64, 64, cfg)
    img = img.cpu().numpy()
    golden = np.asarray(read_image(str(DATA / "caustics_golden8.pfm")))
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert abs(int(stats["n_medium_scatter"]) - 111394) / 111394 < 0.002, stats
    for c in range(3):
        gm, om = golden[..., c].mean(), img[..., c].mean()
        assert abs(om - gm) / gm < 0.015, (c, gm, om)
    rel = _region_rel(img, golden)
    assert float(np.percentile(rel, 90)) < 0.12, rel
    assert float(rel.max()) < 0.5, rel
    return img, stats


def test_compat_caustics_walk_matches_jax_per_photon():
    # bre_tpu is imported here only: chip_smoke.py imports this module for
    # caustics_pass and caustics_gate on a machine without JAX
    import jax.numpy as jnp
    from bre_tpu.integrators.photon_trace import \
        trace_photon_beams_compat as jtrace
    from bre_tpu.lights import light_power_distribution as jlpd
    from bre_tpu.scene.parser import parse_file as jparse

    P = 2048
    js = jparse(GOLDEN_PBRT).build()
    ts = parse_file(GOLDEN_PBRT, device="cpu").build(device="cpu")
    ids = np.arange(P, dtype=np.uint32)
    _, sj = jtrace(js, jlpd(js), jnp.asarray(ids), 6, jnp.float32(0.15),
                   per_photon_stats=True)
    _, st = trace_photon_beams_compat(
        ts, light_power_distribution(ts), torch.from_numpy(ids.astype(np.int64)),
        6, 0.15, per_photon_stats=True)
    for k, bound in ULP_FLIPS.items():
        diff = int((to_np(st[k]) != np.asarray(sj[k])).sum())
        assert diff <= bound, (k, diff)
    assert int((to_np(st["lane_beam"]) != np.asarray(sj["lane_beam"])).sum()) \
        <= sum(ULP_FLIPS.values())
    for k in ("n_medium_scatter", "n_surface", "n_beams"):
        assert abs(int(st[k]) - int(sj[k])) <= sum(ULP_FLIPS.values()), k
    # the specular branch is on this path: photons bounce off the sphere
    assert int(st["n_surface"]) > P


def test_compat_caustics_photon_pass_matches_reference():
    caustics_pass("cpu")


@pytest.mark.slow
def test_compat_caustics_8iter_matches_reference_golden():
    caustics_gate("cpu")


def test_compat_pair_cull_is_the_dense_sum():
    """_compat_contrib (pairs culled by their boxes) against the dense sum
    of _compat_terms over every pair: the same bits, on segments crossing
    long beams, axis-aligned rays and beams, and invalid beams."""
    rs = np.random.RandomState(3)
    R, C = 300, 257
    a0 = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d[:20] = [0.0, 0.0, 1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ln = rs.uniform(0.1, 4.0, R).astype(np.float32)
    a1 = a0 + ln[:, None] * d
    start = rs.uniform(-2, 2, (C, 3)).astype(np.float32)
    bd = rs.normal(size=(C, 3)).astype(np.float32)
    bd[:16] = [-1.0, 0.0, 0.0]
    end = start + rs.uniform(0.05, 3.0, (C, 1)).astype(np.float32) * bd
    T = torch.from_numpy
    cb = dict(start=T(start), end=T(end),
              power_end=T(rs.uniform(0.1, 3, (C, 3)).astype(np.float32)),
              radius=torch.full((C,), 0.15), valid_f=T(
                  (rs.rand(C) < 0.9).astype(np.float32)))
    seg = dict(a0=T(a0), a1=T(a1), dir=T(d),
               len=T(np.linalg.norm(a1 - a0, axis=-1)),
               cam_radius=torch.tensor(0.15))
    c = lambda k: cb[k][None]  # noqa: E731
    out = tbg._compat_contrib(cb, seg, c("start"), c("end"), c("radius"),
                              c("valid_f"))
    dense = tbg._compat_terms(
        seg["a0"][:, None], seg["a1"][:, None], seg["dir"][:, None],
        seg["len"][:, None], seg["cam_radius"], c("start"), c("end"),
        c("radius"), c("valid_f"), c("power_end")).sum(1)
    assert (to_np(dense) > 0).any(-1).mean() > 0.3
    assert torch.equal(out, dense)
