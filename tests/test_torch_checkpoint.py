"""Checkpoint and resume in bre_tpu_torch: the ``.npz`` layout loads across
the two packages with equal fields, a split port render (2 + 2 iterations,
``imagewritefrequency=2``) equals the uninterrupted 4-iteration render bit
for bit, a render that one package checkpoints after 2 iterations resumes
in the other, and an absent checkpoint starts fresh (tests/test_checkpoint.py's
scene and sizes, on the CPU).  Within the port every comparison is exact:
the resumed run adds the same float32 iterations in the same order.  Across
the packages the resumed image is held to the reference's uninterrupted
render with test_torch_render.py's tolerances (image mean within 0.5%, 99%
of pixels within rtol 1e-3: a float-ulp difference may flip a photon or
camera-path decision), and the final radius, a Python float carried by the
checkpoint's JSON and the same recurrence in both packages, exactly."""

import numpy as np
import pytest
import torch

from bre_tpu import checkpoint as jck
from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch import checkpoint as tck
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators.photonbeam import (PhotonBeamConfig,
                                                  render_photonbeam)
from bre_tpu_torch.scene.camera import make_perspective_camera
from bre_tpu_torch.scene.scene import scene_from_jax
from test_photonbeam import fog_cube_scene

WH = 12
BASE = dict(maxdepth=3, photonsperiteration=300, initialbeamradius=0.3,
            gather_chunk=256)


@pytest.mark.parametrize("writer", ["bre_tpu", "bre_tpu_torch"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    save, load = ((jck.save_checkpoint, tck.load_checkpoint)
                  if writer == "bre_tpu" else
                  (tck.save_checkpoint, jck.load_checkpoint))
    Ld = np.random.RandomState(0).rand(WH * WH, 3).astype(np.float32)
    p = tmp_path / "state.npz"
    save(p, 6, 0.123456789012345, {"Ld": Ld, "n": np.arange(4)})
    ck = load(p)
    assert ck["iteration"] == 6 and ck["radius"] == 0.123456789012345
    assert sorted(ck["buffers"]) == ["Ld", "n"]
    assert ck["buffers"]["Ld"].dtype == np.float32
    assert np.array_equal(ck["buffers"]["Ld"], Ld)
    assert np.array_equal(ck["buffers"]["n"], np.arange(4))


def _scene_cam():
    scene = scene_from_jax(fog_cube_scene().build(), device="cpu")
    cam = make_perspective_camera(
        ttfm.look_at((0, 0, -3.5), (0, 0, 0), (0, 1, 0)), 40.0, WH, WH,
        device="cpu")
    return scene, cam


def test_resume_matches_uninterrupted(tmp_path):
    scene, cam = _scene_cam()
    full, st_full = render_photonbeam(scene, cam, WH, WH,
                                      PhotonBeamConfig(iterations=4, **BASE))
    ck = tmp_path / "state.npz"
    render_photonbeam(scene, cam, WH, WH, PhotonBeamConfig(
        iterations=4, enditeration=2, imagewritefrequency=2, **BASE),
        checkpoint_path=str(ck))
    saved = tck.load_checkpoint(ck)
    assert saved["iteration"] == 2 and saved["radius"] == 0.3 * 0.5 * 0.75
    resumed, st = render_photonbeam(scene, cam, WH, WH,
                                    PhotonBeamConfig(iterations=4, **BASE),
                                    checkpoint_path=str(ck))
    assert full.abs().sum() > 0
    assert torch.equal(resumed, full)
    assert st["final_radius"] == st_full["final_radius"]
    assert tck.load_checkpoint(ck)["iteration"] == 4


@pytest.fixture(scope="module")
def jax_scene_cam():
    cam = jcam(jtfm.look_at((0, 0, -3.5), (0, 0, 0), (0, 1, 0)), 40.0, WH, WH)
    return fog_cube_scene().build(), cam


@pytest.mark.parametrize("writer", ["bre_tpu", "bre_tpu_torch"])
def test_resume_across_packages(tmp_path, jax_scene_cam, writer):
    jscene, jcamera = jax_scene_cam
    scene, cam = _scene_cam()

    def render(package, ck=None, **over):
        if package == "bre_tpu":
            img, st = jpb.render_photonbeam(
                jscene, jcamera, WH, WH,
                jpb.PhotonBeamConfig(iterations=4, **BASE, **over),
                checkpoint_path=ck)
            return np.asarray(img), st
        img, st = render_photonbeam(
            scene, cam, WH, WH, PhotonBeamConfig(iterations=4, **BASE, **over),
            checkpoint_path=ck)
        return img.numpy(), st

    full, st_full = render("bre_tpu")
    ck = str(tmp_path / "state.npz")
    render(writer, ck, enditeration=2, imagewritefrequency=2)
    assert tck.load_checkpoint(ck)["iteration"] == 2
    resumer = "bre_tpu_torch" if writer == "bre_tpu" else "bre_tpu"
    resumed, st = render(resumer, ck)
    assert jck.load_checkpoint(ck)["iteration"] == 4
    assert resumed.shape == full.shape == (WH, WH, 3)
    assert np.isfinite(resumed).all() and full.mean() > 0
    assert abs(resumed.mean() / full.mean() - 1.0) < 5e-3
    close = np.isclose(resumed, full, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert st["final_radius"] == st_full["final_radius"]


def test_absent_checkpoint_starts_fresh(tmp_path):
    scene, cam = _scene_cam()
    cfg = PhotonBeamConfig(iterations=2, **BASE)
    plain, _ = render_photonbeam(scene, cam, WH, WH, cfg)
    ck = tmp_path / "none_yet.npz"
    img, _ = render_photonbeam(scene, cam, WH, WH, cfg, checkpoint_path=str(ck))
    assert torch.equal(img, plain)
    saved = tck.load_checkpoint(ck)
    assert saved["iteration"] == 2
    assert np.array_equal(saved["buffers"]["Ld"],
                          (plain * 2).reshape(-1, 3).numpy())


def test_checkpoint_of_another_film_raises(tmp_path):
    scene, cam = _scene_cam()
    ck = tmp_path / "other.npz"
    tck.save_checkpoint(ck, 1, 0.3, {"Ld": np.zeros((5, 3), np.float32)})
    with pytest.raises(ValueError, match="Ld"):
        render_photonbeam(scene, cam, WH, WH,
                          PhotonBeamConfig(iterations=2, **BASE),
                          checkpoint_path=str(ck))
