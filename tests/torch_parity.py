"""Shared pieces of the bre_tpu_torch parity tests (tests/test_torch_*.py):
the Cornell fog scene on either package's builder and tensor -> numpy.

Torch runs single-threaded in every test process: the suite runs under
several pytest-xdist workers on a shared CPU."""

import numpy as np
import torch

torch.set_num_threads(1)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pixels_close(a, b, rtol=1e-3, atol=1e-6, frac=0.99):
    """The parity tests' per-pixel check: ``frac`` of the pixels within
    rtol, atol in every channel."""
    close = np.isclose(to_np(a), to_np(b), rtol=rtol, atol=atol).all(-1)
    assert close.mean() >= frac, close.mean()


def region_means(img, n=4):
    """Means over an n x n grid of regions of an (H, W, 3) image."""
    img = to_np(img)
    H, W = img.shape[:2]
    return img.reshape(n, H // n, n, W // n, 3).mean(axis=(1, 3))


def pcg_state(s):
    """The 64-bit state of a bre_tpu PCG32State (uint32 hi, lo) as the
    port's int64 bit pattern."""
    v = (np.asarray(s.state_hi, np.uint64) << np.uint64(32)) | np.asarray(
        s.state_lo, np.uint64)
    return v.view(np.int64)


SMOKE_W2M = np.array([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5],
                      [0, 0, 0.5, 0.5], [0, 0, 0, 1]], np.float32)
SMOKE_LOOK = ((0, 0, -3.2), (0, 0, 0), (0, 1, 0))


def smoke_density(n=32):
    """examples/smoke_hetero.py's procedural density: an elongated puff
    with swirls on an n^3 grid."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    d = np.exp(-2.0 * (x**2 + 2 * y**2 + z**2))
    d *= 1.0 + 0.5 * np.sin(4 * x) * np.cos(3 * z)
    return np.clip(d, 0.0, None).astype(np.float32)


def smoke_hetero(b, density=None, g=0.4, **build_kw):
    """examples/smoke_hetero.py's scene (BASELINE config 3) on either
    package's SceneBuilder: the grid smoke in [-1,1]^3 lit from inside, a
    wall behind it."""
    dens = smoke_density() if density is None else density
    smoke = b.grid_medium(dens, SMOKE_W2M, sigma_a=(0.02,) * 3,
                          sigma_s=(0.6,) * 3, g=g)
    wall = b.matte((0.5, 0.5, 0.6))
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=smoke,
          medium_outside=-1)
    b.quad((-4, -4, 2.5), (-4, 4, 2.5), (4, 4, 2.5), (4, -4, 2.5),
           material=wall)
    b.point_light((0.0, 0.8, -0.5), (2.0, 1.9, 1.7), medium=smoke)
    return b.build(**build_kw)


def cornell_fog(b, point_light=False, **build_kw):
    """examples/cornell_fog.py's scene (BASELINE config 2) on either
    package's SceneBuilder; optionally one extra point light in the fog.
    ``build_kw`` goes to ``build`` (the port's takes ``device="cpu"``)."""
    fog = b.homogeneous_medium((0.02,) * 3, (0.35,) * 3, g=0.0)
    white = b.matte((0.73, 0.73, 0.73))
    red = b.matte((0.63, 0.065, 0.05))
    green = b.matte((0.14, 0.45, 0.09))
    b.box((-1, -1, 0), (1, 1, 2), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-1, -1, 2), (-1, 1, 2), (1, 1, 2), (1, -1, 2), material=white)
    b.quad((-1, -1, 0), (-1, -1, 2), (-1, 1, 2), (-1, 1, 0), material=red)
    b.quad((1, -1, 0), (1, 1, 0), (1, 1, 2), (1, -1, 2), material=green)
    b.quad((-1, -1, 0), (1, -1, 0), (1, -1, 2), (-1, -1, 2), material=white)
    b.quad((-1, 1, 0), (-1, 1, 2), (1, 1, 2), (1, 1, 0), material=white)
    b.area_light_quad((-0.3, 0.98, 0.7), (0.3, 0.98, 0.7),
                      (0.3, 0.98, 1.3), (-0.3, 0.98, 1.3),
                      (6.0, 5.5, 4.5), medium=fog)
    if point_light:
        b.point_light((0.2, -0.4, 1.1), (0.8, 0.9, 1.0), medium=fog)
    return b.build(**build_kw)


SURFACE_LOOK = ((0, 0.4, -4.5), (0, 0, 0), (0, 1, 0))
SURFACE_FOV = 42.0


def surface_scene(b, textured=True, **build_kw):
    """tests/test_photonbeam_vs_volpath.py's glass_caustic_scene (BASELINE
    config 4's shape: a glass sphere in fog, two point lights) with a
    mirror floor, a metal and a plastic sphere in the fog, and (with
    ``textured``) a checkerboard texture on the back wall, on either
    package's SceneBuilder.  Camera: SURFACE_LOOK, SURFACE_FOV."""
    fog = b.homogeneous_medium((0.02,) * 3, (0.35,) * 3, 0.0)
    b.box((-2, -2, -2), (2, 2, 2), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.sphere((0, 0, 0), 0.6, material=b.glass(eta=1.5), medium_outside=fog)
    mirror = b.mirror((0.9, 0.85, 0.8))
    b.quad((-1.8, -1.5, -1.8), (-1.8, -1.5, 1.8), (1.8, -1.5, 1.8),
           (1.8, -1.5, -1.8), material=mirror, medium_inside=fog,
           medium_outside=fog)
    b.sphere((1.1, -0.9, 0.6), 0.4, material=b.metal(roughness=0.15),
             medium_inside=fog, medium_outside=fog)
    b.sphere((-1.1, -0.9, 0.5), 0.45,
             material=b.plastic((0.5, 0.3, 0.2), (0.3, 0.3, 0.3), 0.2),
             medium_inside=fog, medium_outside=fog)
    tex = (b.tex_checkerboard((1, 1, 1), (0.2, 0.3, 0.5), scale=1.5)
           if textured else -1)
    wall = b.matte((0.6, 0.55, 0.5), kd_tex=tex)
    b.quad((-5, -5, 3.5), (-5, 5, 3.5), (5, 5, 3.5), (5, -5, 3.5),
           material=wall)
    b.point_light((1.5, 1.5, -1.5), (3.0, 2.8, 2.5), medium=fog)
    b.point_light((-1.5, 1.0, -1.0), (1.0, 1.2, 1.8), medium=fog)
    return b.build(**build_kw)


def every_material(b):
    """Every ported material, two of some, a mix of two diffuse and a mix
    of two specular ones, and a textured matte and plastic, on either
    package's SceneBuilder (a sphere holds material 0).  Returns their
    ids by name."""
    ids = dict(
        matte=b.matte((0.6, 0.5, 0.4)),
        mirror=b.mirror((0.9, 0.8, 0.7)),
        glass=b.glass(),
        glass_tinted=b.glass((0.9, 0.95, 1.0), (0.8, 0.9, 1.0), eta=1.33),
        metal=b.metal(roughness=0.01),
        metal_rough=b.metal(eta=(1.5, 0.9, 0.4), k=(2.0, 3.0, 4.0),
                            roughness=0.3, tint=(0.9, 0.8, 1.0)),
        plastic=b.plastic((0.4, 0.3, 0.2), (0.3, 0.3, 0.3), 0.2),
        uber=b.uber((0.2, 0.4, 0.3), (0.5, 0.4, 0.3), 0.05, eta=1.7),
        substrate=b.substrate((0.5, 0.4, 0.3), (0.2, 0.2, 0.2), 0.15),
        translucent=b.translucent((0.3, 0.4, 0.5), (0.4, 0.3, 0.2)),
    )
    ids["mix"] = b.mix(ids["matte"], ids["plastic"], (0.3, 0.6, 0.2))
    ids["mix_specular"] = b.mix(ids["glass"], ids["metal"], 0.5)
    t = b.tex_checkerboard((1, 1, 1), (0.2, 0.3, 0.4), scale=3.0)
    ids["matte_tex"] = b.matte(kd_tex=t)
    ids["plastic_tex"] = b.plastic(kd_tex=b.tex_fbm(scale=2.0))
    b.sphere((0, 0, 0), 1.0, material=0)
    return ids


IMAGE_LOOK = ((0, 0, 0), (0, 0, 4), (0, 1, 0))  # fov 40


def image_scene(b, **build_kw):
    """A minified image-checker plane (tests/test_ewa.py), an image-mapped
    plastic sphere and a uv-textured matte one, lit by a point light, on
    either package's SceneBuilder.  Camera: IMAGE_LOOK, fov 40."""
    n = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(n))
    img = np.zeros((n, n, 3), np.float32)
    img[((xx // 2 + yy // 2) % 2) == 0] = (1.0, 0.9, 0.7)
    checker = b.matte((1, 1, 1), kd_tex=b.tex_imagemap(img, uscale=3.0,
                                                       vscale=3.0))
    L = 6.0
    b.quad((-L, -L, 8), (L, -L, 8), (L, L, 8), (-L, L, 8), material=checker)
    photo = np.random.RandomState(0).rand(16, 32, 3).astype(np.float32)
    b.sphere((-1.0, 0.0, 4.0), 0.8,
             material=b.plastic(kd_tex=b.tex_imagemap(photo)))
    b.sphere((1.0, 0.3, 4.5), 0.7, material=b.matte(kd_tex=b.tex_uv()))
    b.point_light((0, 2, 0), (40, 40, 40))
    return b.build(**build_kw)
