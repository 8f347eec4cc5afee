"""bre_tpu_torch.render_volpath against bre_tpu's through a realistic
camera (the singlet lens file written beside the scene, the rays traced
through its stack and weighed 0 where it vignettes them) on
cornell_fog.pbrt's box and fog with a subsurface and a kdsubsurface sphere
in it (torch_parity.SSS_WORLD: the BSSRDF branch, its probe chain and its
next-event estimation), parsed by each package at 16x16, 4 spp, maxdepth
3.  In its own file because of the reference's compile (about 60 s cold
on one core: the BSSRDF branch's four re-intersections and nine profile
splines).

Tolerances (tests/test_torch_volpath.py's: the same PCG32 streams, so the
two differ only where an ulp flips a path decision): the image mean within
0.5%, 99% of the pixels within rtol 1e-3 / atol 1e-6."""

import numpy as np

from bre_tpu.integrators import volpath as jvp
from bre_tpu.scene import parser as jparser
from bre_tpu_torch.integrators import volpath as tvp
from bre_tpu_torch.scene import parser as tparser
from torch_parity import (SSS_WORLD, cornell_fog_text, to_np,
                          write_fiber_assets)

W = 16


def test_realistic_camera_and_subsurface_render_as_reference(tmp_path):
    write_fiber_assets(tmp_path)
    text = cornell_fog_text("realistic", W, world=SSS_WORLD)
    ps_t = tparser.parse_string(text, tmp_path, device="cpu")
    ps_j = jparser.parse_string(text, tmp_path)
    assert ps_t.camera.ctype == 3 and len(ps_t.camera.lens_curv) == 3
    ts, js = ps_t.build(device="cpu"), ps_j.build()
    it = tvp.render_volpath(ts, ps_t.camera, W, W,
                            tvp.VolPathConfig(maxdepth=3, spp=4))
    ij = jvp.render_volpath(js, ps_j.camera, W, W,
                            jvp.VolPathConfig(maxdepth=3, spp=4))
    it, ij = to_np(it), np.asarray(ij)
    assert np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 5e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
