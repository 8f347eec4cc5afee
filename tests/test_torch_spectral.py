"""The 60-bin spectral mode in bre_tpu_torch against bre_tpu, on the CPU:
the SampledSpectrum tables and functions (``core/sampled_spectrum``), the
lift and white balance of the band-sliced render, ``slice_scene``'s fields
(on a plastic and mix scene too: ks lifted, the lifted mix amounts
clipped to [0, 1]; on image-mapped lights: their image means lifted, the
light atlas left RGB), and one ``render_volpath_spectral`` at 4x4, 2
samples per pixel, maxdepth 2 on tests/test_spectral.py's gray fog
scene.

bre_tpu's ``render_volpath_spectral`` compiles its volpath pass once per
slice (the pass closes over the slice's scene): 20 compiles, about 125 s
on one core at this size.  So the render is held to bre_tpu piece by
piece: slices 0 and 19 of the port's spectral image against bre_tpu's
``render_volpath`` of bre_tpu's ``slice_scene`` (the other 18 slices take
the same code), and the port's RGB against bre_tpu's integration
(``to_xyz``, ``xyz_to_rgb``, the white balance) of the port's spectral
image.

Tolerances and their reasons:
- the float64 tables (wavelengths, matching functions, the metamer and
  lift matrices, the white balance): exact, the same numpy expressions;
- float32 functions: rtol 1e-6 (the 60-term products add in another
  order in torch and XLA:CPU);
- ``slice_scene``: rtol 1e-6;
- the slices: as tests/test_torch_volpath.py's renders, the mean within
  1e-4 and 99% of the pixels within rtol 1e-4, atol 1e-6;
- the integration: rtol 1e-5, atol 1e-7.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu.core import sampled_spectrum as jss
from bre_tpu.core import spectrum as jspec
from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import spectral as jsp
from bre_tpu.integrators import volpath as jvp
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as j_camera
from bre_tpu_torch.core import sampled_spectrum as tss
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import spectral as tsp
from bre_tpu_torch.integrators.volpath import VolPathConfig
from bre_tpu_torch.scene.builder import SceneBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import pixels_close, to_np


def gray_fog(b, **build_kw):
    """tests/test_spectral.py:19-29: a gray fog box before a matte wall, a
    point light in the fog."""
    fog = b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.0)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-3, -3, 3), (-3, 3, 3), (3, 3, 3), (3, -3, 3),
           material=b.matte((0.5, 0.5, 0.5)))
    b.point_light((0, 0.3, 0), (1.0, 1.0, 1.0), medium=fog)
    return b.build(**build_kw)


def _colored(b, **build_kw):
    """A chromatic scene for the lift: colored media, walls and lights."""
    fog = b.homogeneous_medium((0.05, 0.3, 0.8), (0.1, 0.2, 0.05), 0.3)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-3, -3, 3), (-3, 3, 3), (3, 3, 3), (3, -3, 3),
           material=b.matte((0.7, 0.2, 0.1)))
    b.area_light_sphere((0.5, 0.5, 0.0), 0.2, (4.0, 1.0, 0.5),
                        material=b.matte((0.1, 0.9, 0.3)), medium=fog)
    b.point_light((0, 0.3, 0), (0.2, 1.0, 3.0), medium=fog)
    return b.build(**build_kw)


def test_tables_equal_the_reference():
    for name in ("LAMBDAS", "_CMF", "_RGB_TO_SPECTRUM"):
        np.testing.assert_array_equal(getattr(tss, name), getattr(jss, name),
                                      err_msg=name)
    assert tss.CIE_Y_INTEGRAL == jss.CIE_Y_INTEGRAL
    assert tss.N_SAMPLES == 60 and tss._DLAM == jss._DLAM
    np.testing.assert_array_equal(tsp._LIFT, jsp._LIFT)
    np.testing.assert_array_equal(tsp._WB, jsp._WB)
    for k in (0, 7, 19):
        np.testing.assert_array_equal(to_np(tsp._slice_lift_matrix(k)),
                                      np.asarray(jsp._slice_lift_matrix(k)))
    assert tsp.N_SLICES == jsp.N_SLICES == 20


def test_spectrum_functions_match_jax():
    rs = np.random.RandomState(31)
    rgb = rs.uniform(-0.2, 1.5, (50, 3)).astype(np.float32)
    spec = rs.uniform(0, 2, (4, 5, 60)).astype(np.float32)
    pairs = [
        (tss.from_rgb(torch.from_numpy(rgb)), jss.from_rgb(rgb)),
        (tss.to_xyz(torch.from_numpy(spec)), jss.to_xyz(jnp.asarray(spec))),
        (tss.to_rgb(torch.from_numpy(spec)), jss.to_rgb(jnp.asarray(spec))),
        (tss.y_lum(torch.from_numpy(spec)), jss.y_lum(jnp.asarray(spec))),
        (tss.from_sampled([650.0, 400.0, 520.0], [0.2, 1.0, 3.0]),
         jss.from_sampled([650.0, 400.0, 520.0], [0.2, 1.0, 3.0])),
        (tss.blackbody(torch.linspace(380.0, 720.0, 35), 5500.0),
         jss.blackbody(jnp.linspace(380.0, 720.0, 35), 5500.0)),
        (tss.blackbody_normalized(torch.linspace(380.0, 720.0, 35), 3000.0),
         jss.blackbody_normalized(jnp.linspace(380.0, 720.0, 35), 3000.0)),
        (tss.blackbody_spectrum(6500.0), jss.blackbody_spectrum(6500.0)),
    ]
    for k, (a, b) in enumerate(pairs):
        b = np.asarray(b)
        np.testing.assert_allclose(to_np(a), b, rtol=1e-6,
                                   atol=1e-7 * np.abs(b).max(),
                                   err_msg=str(k))


@pytest.mark.parametrize("k", [0, 7, 19])
def test_slice_scene_matches_jax(k):
    js = _colored(JBuilder())
    ts = _colored(SceneBuilder(), device="cpu")
    ref = scene_from_jax(jsp.slice_scene(js, k), device="cpu")
    mine = tsp.slice_scene(ts, k)
    for part, field in (("materials", "kd"), ("lights", "emit"),
                        ("media", "sigma_a"), ("media", "sigma_s")):
        a = getattr(getattr(mine, part), field)
        b = getattr(getattr(ref, part), field)
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-6, atol=1e-7,
                                   err_msg=f"{part}.{field}")
    # geometry and every other field untouched
    np.testing.assert_array_equal(to_np(mine.triangles.p0),
                                  to_np(ts.triangles.p0))
    np.testing.assert_array_equal(to_np(mine.media.g), to_np(ts.media.g))
    assert (to_np(mine.lights.emit) >= 0).all()


def _plastic(b, **build_kw):
    """A plastic and a mix of plastic and matte with chromatic ks and mix
    amounts, so the lift of ks and the clip of the lifted amounts show."""
    fog = b.homogeneous_medium((0.05,) * 3, (0.3,) * 3, 0.0)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    plastic = b.plastic((0.6, 0.3, 0.1), (0.1, 0.5, 0.9), 0.2)
    matte = b.matte((0.2, 0.7, 0.3))
    mix = b.mix(plastic, matte, (0.95, 0.05, 1.0))
    b.sphere((0, 0, 0), 0.5, material=plastic, medium_outside=fog)
    b.quad((-3, -3, 3), (-3, 3, 3), (3, 3, 3), (3, -3, 3), material=mix)
    b.point_light((0, 0.6, -0.5), (1.0, 0.8, 0.6), medium=fog)
    return b.build(**build_kw)


@pytest.mark.parametrize("k", [0, 10, 19])
def test_slice_scene_lifts_ks_and_mix_amount(k):
    """The reference lifts ks and clips the lifted mix amounts to [0, 1]
    (spectral.py:100-105) on a plastic scene."""
    js = _plastic(JBuilder())
    ts = _plastic(SceneBuilder(), device="cpu")
    ref = scene_from_jax(jsp.slice_scene(js, k), device="cpu")
    mine = tsp.slice_scene(ts, k)
    for field in ("kd", "ks", "mix_amount"):
        a = getattr(mine.materials, field)
        b = getattr(ref.materials, field)
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-6, atol=1e-7,
                                   err_msg=field)
    assert not torch.equal(mine.materials.ks, ts.materials.ks)
    amt = to_np(mine.materials.mix_amount)
    assert amt.min() >= 0.0 and amt.max() <= 1.0
    for field in ("eta", "roughness", "metal_eta", "metal_k", "mix_m1"):
        assert torch.equal(getattr(mine.materials, field),
                           getattr(ts.materials, field)), field


@pytest.mark.parametrize("k", [0, 10, 19])
def test_slice_scene_lifts_img_mean(k):
    """The reference lifts each light's image mean (spectral.py:107-110),
    which Power() reads, and leaves the light atlas RGB, on an env map and
    a goniometric and a projection light."""
    from torch_parity import lights_scene

    kinds = ("envmap", "goniometric", "projection", "point")
    js = lights_scene(JBuilder(), kinds)
    ts = lights_scene(SceneBuilder(), kinds, device="cpu")
    ref = scene_from_jax(jsp.slice_scene(js, k), device="cpu")
    mine = tsp.slice_scene(ts, k)
    for field in ("emit", "img_mean"):
        np.testing.assert_allclose(to_np(getattr(mine.lights, field)),
                                   to_np(getattr(ref.lights, field)),
                                   rtol=1e-6, atol=1e-7, err_msg=field)
    assert not torch.equal(mine.lights.img_mean, ts.lights.img_mean)
    assert (to_np(mine.lights.img_mean) >= 0).all()
    for field in ("atlas", "env_func", "env_cond_cdf", "img_off"):
        assert torch.equal(getattr(mine.lights, field),
                           getattr(ts.lights, field)), field


def test_render_volpath_spectral_matches_jax():
    wh = 4
    look = ((0, 0, -3.5), (0, 0, 0), (0, 1, 0))
    cfg_t = VolPathConfig(maxdepth=2, spp=2)
    cfg_j = jvp.VolPathConfig(maxdepth=2, spp=2)
    ts = gray_fog(SceneBuilder(), device="cpu")
    js = gray_fog(JBuilder())
    cam_t = make_perspective_camera(ttfm.look_at(*look), 40.0, wh, wh,
                                    device="cpu")
    cam_j = j_camera(jtfm.look_at(*look), 40.0, wh, wh)
    rgb, spec = tsp.render_volpath_spectral(ts, cam_t, wh, wh, cfg_t,
                                            return_spectrum=True)
    assert rgb.shape == (wh, wh, 3) and spec.shape == (wh, wh, 60)
    assert torch.isfinite(rgb).all() and spec.mean() > 0
    for k in (0, 19):
        ref = np.asarray(jvp.render_volpath(jsp.slice_scene(js, k), cam_j, wh,
                                            wh, cfg_j))
        got = to_np(spec[..., 3 * k:3 * k + 3])
        np.testing.assert_allclose(got.mean(), ref.mean(), rtol=1e-4)
        pixels_close(got, ref, rtol=1e-4)
    want = np.asarray(jspec.xyz_to_rgb(jss.to_xyz(jnp.asarray(to_np(spec))))
                      * jnp.asarray(jsp._WB, jnp.float32))
    np.testing.assert_allclose(to_np(rgb), want, rtol=1e-5, atol=1e-7)
    # a gray scene stays gray: the spectral render is the RGB one to 2%
    rgb_plain = tsp.render_volpath(ts, cam_t, wh, wh, cfg_t)
    assert abs(float(rgb.mean() / rgb_plain.mean()) - 1.0) < 0.02
