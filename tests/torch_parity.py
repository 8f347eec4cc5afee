"""Shared pieces of the bre_tpu_torch parity tests (tests/test_torch_*.py):
the Cornell fog scene on either package's builder and tensor -> numpy.

Torch runs single-threaded in every test process: the suite runs under
several pytest-xdist workers on a shared CPU."""

import numpy as np
import torch

torch.set_num_threads(1)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cornell_fog(b, point_light=False):
    """examples/cornell_fog.py's scene (BASELINE config 2) on either
    package's SceneBuilder; optionally one extra point light in the fog."""
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
    return b.build()
