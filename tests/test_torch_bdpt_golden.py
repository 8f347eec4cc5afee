"""The BDPT golden gate against the C++ reference renderer's own image,
through bre_tpu_torch alone (no JAX), on the CPU: tests/test_bdpt_golden.py's
gate with its scene (``tests/data/bdpt_golden.pbrt``: a closed box with a
ceiling area light, 32x32, maxdepth 4, 64 samples per pixel) and its
bounds: channel means within 1.5% and 4x4 region means within 6% of
``tests/data/bdpt_golden.pfm`` (relative to max(golden region, 0.02)).
The gate is statistical, as there: the reference's halton samples cannot be
matched by BDPT's random streams.  ``bdpt_gate_check`` is what
chip_smoke.py phase 32 holds the card's render to.
"""

from pathlib import Path

import numpy as np

from bre_tpu_torch.integrators.bdpt import BDPTConfig, render_bdpt
from bre_tpu_torch.io.image import read_image
from bre_tpu_torch.scene.parser import parse_file

DATA = Path(__file__).parent / "data"
GOLDEN_PBRT = DATA / "bdpt_golden.pbrt"


def bdpt_gate_check(img):
    """Holds a (32, 32, 3) image to the gate's bounds.  Returns the
    relative errors {"means": [3], "region_max": float}."""
    golden = np.asarray(read_image(str(DATA / "bdpt_golden.pfm")))
    assert img.shape == golden.shape and np.isfinite(img).all()
    means = [float(img[..., c].mean() / golden[..., c].mean() - 1.0)
             for c in range(3)]
    rg = golden.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))
    ro = img.reshape(4, 8, 4, 8, 3).mean(axis=(1, 3))
    region = float((np.abs(ro - rg) / np.maximum(rg, 0.02)).max())
    assert all(abs(m) < 0.015 for m in means), means
    assert region < 0.06, region
    return dict(means=means, region_max=region)


def test_bdpt_golden_gate_on_cpu():
    ps = parse_file(str(GOLDEN_PBRT), device="cpu")
    assert ps.integrator_name == "bdpt" and (ps.width, ps.height) == (32, 32)
    img = render_bdpt(ps.build(device="cpu"), ps.camera, 32, 32,
                      BDPTConfig(maxdepth=4, spp=64))
    # measured on the CPU: channel means +0.15%, +0.13%, +0.00%; region
    # max 1.97%
    bdpt_gate_check(img.numpy())
