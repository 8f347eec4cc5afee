"""bre_tpu_torch.scene.camera's camera kinds against bre_tpu's, on the
same numpy inputs from a seed.

- Every ``make_*_camera``: the matrices to 1e-6 (numpy float32 with the
  reference's expressions, inverted by LAPACK on both sides), the kind and
  the lens host values equal to the reference's float32 values; the
  realistic camera's autofocused ``lens_thick[-1]`` (a 46-step float64
  bisection on the host) bit for bit.
- ``generate_rays`` of every kind, with and without lens samples (the
  thin lens): origins and unit directions to atol 2e-6 of max(|x|, 1)
  (XLA:CPU contracts multiply-adds in the matrix products, ROADMAP
  Queue 3).
- ``generate_rays_weighted`` of a realistic camera through the lens stack:
  the vignetting weights exactly, the rays to atol 2e-5 of max(|x|, 1)
  (five refracting interfaces, each with a square root near grazing).
- ``generate_ray_differentials``, ``camera_from_jax``, ``camera_to``.
- The reference's behaviours kept on purpose (ROADMAP Queue 3): a
  realistic camera under plain ``generate_rays`` takes the orthographic
  branch; only a lens sample makes a thin lens; ``pdf_we`` and
  ``sample_wi`` are the pinhole perspective camera's for every kind.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu.scene import camera as jc
from bre_tpu_torch.core import transform as tfm
from bre_tpu_torch.scene import camera as tc
from torch_parity import to_np

W, H = 24, 16
# biconvex singlet and a stop (tests/test_realistic_camera.py), and a
# doublet with its stop between the elements: [radius, thickness, ior,
# aperture] in mm
SINGLET = [[50.0, 5.0, 1.5, 30.0], [0.0, 2.0, 0.0, 6.0],
           [-50.0, 45.0, 1.0, 30.0]]
DOUBLET = [[35.0, 4.0, 1.6, 24.0], [-60.0, 2.0, 1.0, 24.0],
           [0.0, 3.0, 0.0, 8.0], [40.0, 3.0, 1.5, 20.0],
           [-40.0, 38.0, 1.0, 20.0]]
C2W = np.asarray(tfm.look_at((0.5, 1.0, -4.0), (0.0, 0.2, 0.0),
                             (0.0, 1.0, 0.0)).numpy())


def _pair(kind):
    """(port camera, reference camera) of a kind."""
    if kind == "perspective":
        return (tc.make_perspective_camera(C2W, 50.0, W, H, device="cpu"),
                jc.make_perspective_camera(C2W, 50.0, W, H))
    if kind == "thin_lens":
        return (tc.make_perspective_camera(C2W, 50.0, W, H, lens_radius=0.1,
                                           focal_distance=3.0, device="cpu"),
                jc.make_perspective_camera(C2W, 50.0, W, H, lens_radius=0.1,
                                           focal_distance=3.0))
    if kind == "orthographic":
        return (tc.make_orthographic_camera(C2W, W, H, screen_scale=1.5,
                                            device="cpu"),
                jc.make_orthographic_camera(C2W, W, H, screen_scale=1.5))
    if kind == "environment":
        return (tc.make_environment_camera(C2W, W, H, device="cpu"),
                jc.make_environment_camera(C2W, W, H))
    rows = SINGLET if kind == "realistic" else DOUBLET
    kw = dict(aperture_diameter=4.0, focus_distance=2.5, film_diag=0.035)
    return (tc.make_realistic_camera(C2W, rows, W, H, device="cpu", **kw),
            jc.make_realistic_camera(C2W, rows, W, H, **kw))


KINDS = ("perspective", "thin_lens", "orthographic", "environment",
         "realistic", "realistic_doublet")


def _lanes(seed, n=4096):
    rs = np.random.RandomState(seed)
    p = rs.uniform(0, 1, (n, 2)) * np.array([W, H])
    return p.astype(np.float32), rs.uniform(0, 1, (n, 2)).astype(np.float32)


def _close(a, b, atol):
    b = np.asarray(b)
    np.testing.assert_allclose(to_np(a), b, rtol=0,
                               atol=atol * max(float(np.abs(b).max()), 1.0))


@pytest.mark.parametrize("kind", KINDS)
def test_make_camera_matches_jax(kind):
    mine, ref = _pair(kind)
    for name in ("camera_to_world", "raster_to_camera"):
        _close(getattr(mine, name), getattr(ref, name), 1e-6)
    assert mine.ctype == int(np.asarray(ref.ctype))
    for name in ("lens_radius", "focal_distance", "rear_radius", "rear_z",
                 "lens_curv", "lens_thick", "lens_eta", "lens_aperture"):
        want = np.asarray(getattr(ref, name), np.float32).reshape(-1)
        got = np.asarray(getattr(mine, name), np.float32).reshape(-1)
        np.testing.assert_array_equal(got, want, err_msg=name)
    if kind.startswith("realistic"):
        assert len(mine.lens_thick) == len(SINGLET if kind == "realistic"
                                           else DOUBLET)
        assert mine.lens_thick[-1] > 0.01  # a physical rear gap


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lens", [False, True])
def test_generate_rays_match_jax(kind, lens):
    mine, ref = _pair(kind)
    p, u = _lanes(1 + lens)
    T, J = torch.from_numpy, jnp.asarray
    ul = (T(u), J(u)) if lens else (None, None)
    o, d = tc.generate_rays(mine, T(p), ul[0])
    jo, jd = jc.generate_rays(ref, J(p), ul[1])
    _close(o, jo, 2e-6)
    _close(d, jd, 2e-6)
    np.testing.assert_allclose(to_np(d.norm(dim=-1)), 1.0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_generate_rays_weighted_and_differentials_match_jax(kind):
    mine, ref = _pair(kind)
    p, u = _lanes(3)
    T, J = torch.from_numpy, jnp.asarray
    got = tc.generate_ray_differentials(mine, T(p), T(u))
    want = jc.generate_ray_differentials(ref, J(p), J(u))
    w = to_np(got[2])
    np.testing.assert_array_equal(w, np.asarray(want[2]))
    atol = 2e-5 if kind.startswith("realistic") else 2e-6
    ok = w > 0
    for a, b in zip(got[:2], want[:2]):
        # vignetted lanes are the far sentinel ray in both
        np.testing.assert_array_equal(to_np(a)[~ok], np.asarray(b)[~ok])
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        _close(a, b, atol)
    if kind.startswith("realistic"):
        assert 20 < w.sum() < w.size  # the stop vignettes some lanes
    else:
        assert (w == 1.0).all()


def test_camera_from_jax_and_camera_to():
    for kind in KINDS:
        mine, ref = _pair(kind)
        got = tc.camera_from_jax(ref, device="cpu")
        for name in mine._fields:
            a, b = getattr(mine, name), getattr(got, name)
            if isinstance(a, torch.Tensor):
                _close(a, to_np(b), 1e-6)
            else:
                assert a == b, name
        moved = tc.camera_to(mine, "cpu")
        assert moved.ctype == mine.ctype and moved.lens_curv == mine.lens_curv


# ---- the reference's behaviours kept on purpose (ROADMAP Queue 3) ----

def test_realistic_camera_under_generate_rays_is_orthographic():
    """ctype 3 is neither perspective nor environment: plain
    generate_rays (every integrator but volpath) leaves the film
    rectangle along +z, and neither the stack nor the vignetting
    applies."""
    mine, ref = _pair("realistic")
    p, _ = _lanes(4)
    o, d = tc.generate_rays(mine, torch.from_numpy(p))
    jo, jd = jc.generate_rays(ref, jnp.asarray(p))
    _close(o, jo, 2e-6)
    _close(d, jd, 2e-6)
    film = tfm.apply_point(mine.raster_to_camera, torch.cat(
        [torch.from_numpy(p), torch.zeros(p.shape[0], 1)], -1))
    _close(o, to_np(tfm.apply_point(mine.camera_to_world, film)), 1e-6)
    z = to_np(mine.camera_to_world[:3, 2])
    _close(d, np.broadcast_to(z / np.linalg.norm(z), d.shape), 1e-6)


def test_thin_lens_needs_a_lens_sample():
    """Without a lens sample (photonbeam, vsppm, bdpt, mlt, photonmap and
    the extra integrators' camera passes) a lensradius > 0 camera is the
    pinhole, bit for bit."""
    lens, _ = _pair("thin_lens")
    pin, _ = _pair("perspective")
    p, u = _lanes(5)
    for a, b in zip(tc.generate_rays(lens, torch.from_numpy(p)),
                    tc.generate_rays(pin, torch.from_numpy(p))):
        assert torch.equal(a, b)
    o, _ = tc.generate_rays(lens, torch.from_numpy(p), torch.from_numpy(u))
    assert float((o - tc.camera_position(lens)).norm(dim=-1).max()) > 0.05


@pytest.mark.parametrize("kind", ["orthographic", "environment",
                                  "realistic"])
def test_pdf_we_and_sample_wi_are_the_pinholes(kind):
    """pdf_we and sample_wi read the camera's matrices as a pinhole
    perspective camera's whatever its kind, as the reference's do (BDPT
    reads them)."""
    from bre_tpu_torch.core.math import normalize

    mine, ref = _pair(kind)
    rs = np.random.RandomState(6)
    d = normalize(torch.from_numpy(rs.normal(size=(2048, 3)).astype(
        np.float32)))
    pts = torch.from_numpy(rs.uniform(-2, 2, (2048, 3)).astype(np.float32))
    got = tc.pdf_we(mine, W, H, d)
    want = jc.pdf_we(ref, W, H, jnp.asarray(to_np(d)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-6)
    got = tc.sample_wi(mine, W, H, pts)
    want = jc.sample_wi(ref, W, H, jnp.asarray(to_np(pts)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)
