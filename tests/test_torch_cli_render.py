"""One real render through both CLIs: tests/test_parser.py's FOG_SCENE (a
fog box, a point light in it and a matte sphere behind it; 16x16, 2
iterations of 200 photons) with ``python -m bre_tpu.cli`` and with
``bre_tpu_torch.cli --device cpu``.  In its own file because of the JAX
compile.

Tolerance (tests/test_torch_default_route.py's render tolerances): the two
renders share bit-identical PCG32 streams and differ only where a float-ulp
difference flips a photon or camera-path decision, so the image means
agree within 0.5% and 99% of pixels within rtol 1e-3 (atol 1e-6)."""

import numpy as np

from bre_tpu import cli as jcli
from bre_tpu_torch import cli as tcli
from bre_tpu_torch.io.image import read_pfm
from test_parser import FOG_SCENE


def test_fog_scene_renders_alike_through_both_clis(tmp_path):
    scene = tmp_path / "fog.pbrt"
    scene.write_text(FOG_SCENE)
    out_t, out_j = tmp_path / "t.pfm", tmp_path / "j.pfm"
    assert tcli.main([str(scene), "--device", "cpu", "-o", str(out_t),
                      "--quiet"]) == 0
    assert jcli.main([str(scene), "-o", str(out_j), "--quiet"]) == 0
    it, ij = read_pfm(out_t), read_pfm(out_j)
    assert it.shape == ij.shape == (16, 16, 3)
    assert np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 5e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
