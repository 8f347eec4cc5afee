"""The golden gates against the reference renderer's own images, through
bre_tpu_torch on the CPU: tests/test_reference_golden.py (the fog gate,
BASELINE config 1 cut to 32x32, 2 iterations x 2000 photons) and
tests/test_reference_golden_smoke.py (the 32^3 grid smoke at 64x64, one
iteration of 20,000 photons), with their scenes, sizes and assertions
unchanged.  ``tests/data/*.pfm`` were rendered by the reference binary
(refbuild/build.sh) and are read with the port's ``io.image.read_image``.

The smoke gate runs 20,000 photons' beams against 4,096 camera rays over
17 camera steps through the plain chunk scan: about 250 s on one CPU core,
so it is marked ``slow``; on a card it runs in chip_smoke.py and in
tests/test_torch_cuda.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from bre_tpu_torch.integrators.photon_trace import trace_photon_beams_compat
from bre_tpu_torch.integrators.photonbeam import (PhotonBeamConfig,
                                                  camera_pass,
                                                  render_photonbeam)
from bre_tpu_torch.io.image import read_image
from bre_tpu_torch.lights import light_power_distribution
from bre_tpu_torch.scene.parser import parse_file

DATA = Path(__file__).parent / "data"


def fog_gate(device):
    """test_compat_matches_reference_golden on ``device``: its assertions
    (channel means within 10%, 4x4 region means of R within 25%, 1.8-2.6
    beams per photon).  Returns (image, stats)."""
    golden = np.asarray(read_image(str(DATA / "fog_golden.pfm")))
    ps = parse_file(str(DATA / "fog_golden.pbrt"), device=device)
    scene = ps.build(device=device)
    cfg = PhotonBeamConfig(
        iterations=2, maxdepth=3, photonsperiteration=2000,
        initialbeamradius=0.25, alpha=0.5, kernel="compat",
    )
    img, stats = render_photonbeam(scene, ps.camera, 32, 32, cfg)
    img = img.cpu().numpy()

    assert img.shape == golden.shape
    for c in range(3):
        gm, om = golden[..., c].mean(), img[..., c].mean()
        assert abs(om - gm) / gm < 0.10, (c, gm, om)
    rg = golden.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))[..., 0]
    ro = img.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))[..., 0]
    rel = np.abs(ro - rg) / np.maximum(rg, 0.02)
    assert float(rel.max()) < 0.25, rel
    assert 1.8 < stats["n_beams"] / (2 * 2000) < 2.6
    return img, stats


def smoke_gate(device):
    """test_compat_hetero_matches_reference_golden_smoke on ``device``: trace
    and camera pass for one iteration, its assertions (medium interactions
    within 10% of the reference's 1,497, channel means within 5%, 4x4
    region means of R within 25%).  Returns (image, stats)."""
    golden = np.asarray(read_image(str(DATA / "smoke_golden.pfm")))
    ps = parse_file(str(DATA / "smoke_golden.pbrt"), device=device)
    scene = ps.build(device=device)
    beams, stats = trace_photon_beams_compat(
        scene, light_power_distribution(scene),
        torch.arange(20000, device=scene.device), 5, 0.15)
    cfg = PhotonBeamConfig(iterations=1, maxdepth=5,
                           photonsperiteration=20000,
                           initialbeamradius=0.15, kernel="compat")
    Ld, _ = camera_pass(scene, ps.camera, 64, 64, beams, 0.15, 0, cfg, 20000)
    img = Ld.cpu().numpy().reshape(64, 64, 3)
    assert img.shape == golden.shape
    assert abs(int(stats["n_medium_scatter"]) - 1497) / 1497 < 0.10, stats
    for c in range(3):
        gm, om = golden[..., c].mean(), img[..., c].mean()
        assert abs(om - gm) / gm < 0.05, (c, gm, om)
    rg = golden.reshape(4, 16, 4, 16, 3).mean(axis=(1, 3))[..., 0]
    ro = img.reshape(4, 16, 4, 16, 3).mean(axis=(1, 3))[..., 0]
    rel = np.abs(ro - rg) / np.maximum(rg, rg.max() * 0.1)
    assert float(rel.max()) < 0.25, rel
    return img, stats


def test_compat_matches_reference_golden():
    fog_gate("cpu")


@pytest.mark.slow
def test_compat_hetero_matches_reference_golden_smoke():
    smoke_gate("cpu")
