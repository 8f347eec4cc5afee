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
