"""The vsppm golden gates against the reference renderer's own images,
through bre_tpu_torch alone (no JAX), on the CPU:
tests/test_vsppm_golden.py's 8- and 32-iteration gates with its scene
(``tests/data/vsppm_golden.pbrt``: 32x32, 2,000 photons per iteration,
maxdepth 3, radius 0.25, ``kernel="compat"``), identities and bounds
unchanged.  The 64-iteration gate (bounds 0.5% / 3% / 10%) is
``vsppm_gate(device, 64)``: it runs on the card, in chip_smoke.py.

Bounds, as the reference package sets them: the combined medium
interactions (photon pass + medium visible points, the reference's counter
sums both) within 1.5% of 11,073 at 8 iterations, 0.5% of 44,273 at 32 and
88,525 at 64; visible points within 2% of 3,219 (medium) and 4,973
(surface) and 16,000 photon paths at 8; channel means within 12% (8: the
Ld tail is undersampled at 8 PCG32 camera samples) or 3%; 4x4 region means
of R within 30%, 15% and 10%.
"""

from pathlib import Path

import numpy as np

from bre_tpu_torch.integrators.vsppm import VSPPMConfig, render_vsppm
from bre_tpu_torch.io.image import read_image
from bre_tpu_torch.scene.parser import parse_file

DATA = Path(__file__).parent / "data"
# iterations: (golden file, combined interactions, its bound, channel-mean
# bound, region bound)
GATES = {8: ("vsppm_golden8.pfm", 11073, 0.015, 0.12, 0.30),
         32: ("vsppm_golden32.pfm", 44273, 0.005, 0.03, 0.15),
         64: ("vsppm_golden64.pfm", 88525, 0.005, 0.03, 0.10)}


def _region_means(img):
    return img.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))[..., 0]


def vsppm_gate(device, iterations):
    """render_vsppm(kernel="compat") on the golden scene at ``iterations``
    (8, 32 or 64) on ``device``, held to the gate's identities and bounds.
    Returns (image, stats, the measured relative errors)."""
    name, comb_ref, comb_tol, mean_tol, region_tol = GATES[iterations]
    golden = np.asarray(read_image(str(DATA / name)))
    ps = parse_file(str(DATA / "vsppm_golden.pbrt"), device=device)
    scene = ps.build(device=device)
    cfg = VSPPMConfig(iterations=iterations, maxdepth=3,
                      photonsperiteration=2000, radius=0.25, kernel="compat")
    img, stats = render_vsppm(scene, ps.camera, 32, 32, cfg)
    img = img.cpu().numpy()
    assert img.shape == golden.shape
    comb = stats["medium_interactions"] + stats["vp_medium"]
    rel = dict(combined=comb / comb_ref - 1.0)
    assert abs(rel["combined"]) < comb_tol, comb
    if iterations == 8:
        assert abs(stats["vp_medium"] - 3219) / 3219 < 0.02, stats
        assert abs(stats["vp_surface"] - 4973) / 4973 < 0.02, stats
        assert stats["photon_paths"] == 16000
    rel["means"] = [float(img[..., c].mean() / golden[..., c].mean() - 1.0)
                    for c in range(3)]
    for c, r in enumerate(rel["means"]):
        assert abs(r) < mean_tol, (c, rel)
    reg = np.abs(_region_means(img) - _region_means(golden)) / np.maximum(
        _region_means(golden), 0.02)
    rel["region_max"] = float(reg.max())
    assert rel["region_max"] < region_tol, reg
    return img, stats, rel


def test_vsppm_compat_matches_reference_golden():
    vsppm_gate("cpu", 8)


def test_vsppm_compat_matches_reference_golden_32():
    vsppm_gate("cpu", 32)
