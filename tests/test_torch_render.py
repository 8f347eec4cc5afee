"""bre_tpu_torch.render_photonbeam end to end vs bre_tpu on the Cornell fog
scene (BASELINE config 2 cut to 32x32, 4,000 photons, 2 iterations), both
scenes from their own package's SceneBuilder.

Tolerances and their reasons: the two renders share bit-identical PCG32
streams, so they differ only where a float-ulp difference flips a photon or
camera-path decision.  One flipped photon path moves the image mean by about
1/8,000 of itself, so the image mean must agree within 0.5%; per pixel, 99%
of pixels agree to rtol 1e-3 (measured: every pixel within 4e-6)."""

import numpy as np
import pytest
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from torch_parity import cornell_fog

W = 32
CFG = dict(iterations=2, maxdepth=5, photonsperiteration=4000,
           initialbeamradius=0.12, alpha=0.7, gather="auto",
           grad_geometry=False)
LOOK = ((0, 0, -2.2), (0, 0, 1), (0, 1, 0))


def test_render_photonbeam_matches():
    ij, sj = jpb.render_photonbeam(
        cornell_fog(JBuilder()), jcam(jtfm.look_at(*LOOK), 50.0, W, W), W, W,
        jpb.PhotonBeamConfig(grad_extras=False, **CFG))
    writes = []
    it, st = tpb.render_photonbeam(
        cornell_fog(TBuilder(), device="cpu"), tcam(ttfm.look_at(*LOOK), 50.0, W, W, device="cpu"), W, W,
        tpb.PhotonBeamConfig(imagewritefrequency=1, **CFG),
        write_callback=lambda i, img: writes.append((i, img)))
    ij, it = np.asarray(ij), it.numpy()
    assert it.shape == (W, W, 3) and np.isfinite(it).all()
    assert ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 5e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert st["final_radius"] == pytest.approx(sj["final_radius"])
    assert [i for i, _ in writes] == [0, 1]
    torch.testing.assert_close(writes[-1][1], torch.from_numpy(it))


@pytest.mark.parametrize("over,match", [
    (dict(gather="lbvh"), "lbvh"),
])
def test_unported_options_raise(over, match, tmp_path):
    """The name is from when these options raised NotImplementedError;
    gather="lbvh", the last of them, is ported and now renders, as a plain
    render and with a checkpoint written at its end, the same image both
    ways (against gather="brute": tests/test_torch_lbvh_gather.py)."""
    cfg = tpb.PhotonBeamConfig(**{**CFG, **over})
    assert getattr(cfg, "gather") == match
    scene = cornell_fog(TBuilder(), device="cpu")
    cam = tcam(ttfm.look_at(*LOOK), 50.0, 8, 8, device="cpu")
    img, stats = tpb.render_photonbeam(scene, cam, 8, 8, cfg)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    # 4,000 photons' beams pass the 4,096 candidates of a tile: counted
    assert float(img.mean()) > 0 and stats["lbvh_overflow"] > 0
    ck = tmp_path / "ck.npz"
    img_ck, _ = tpb.render_photonbeam(scene, cam, 8, 8, cfg,
                                      checkpoint_path=str(ck))
    assert ck.exists() and torch.equal(img_ck, img)
