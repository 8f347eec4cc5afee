"""Scene recipe of ``cornell_fog.json`` (``examples/cornell_fog.py``): a
Cornell box filled with homogeneous fog, lit by an area light in the
ceiling.

``build_scene(kit, cfg, light_scale, device)`` builds it with ``kit``'s
``SceneBuilder``: the program's or the reference's, which share the API.
"""

import numpy as np


def build_scene(kit, cfg, light_scale, device):
    med = cfg["medium"]
    b = kit.SceneBuilder()
    fog = b.homogeneous_medium(tuple(med["sigma_a"]), tuple(med["sigma_s"]),
                               g=med["g"])
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
    radiance = np.asarray(cfg["light"]["radiance"], np.float64) * light_scale
    b.area_light_quad((-0.3, 0.98, 0.7), (0.3, 0.98, 0.7),
                      (0.3, 0.98, 1.3), (-0.3, 0.98, 1.3),
                      tuple(float(v) for v in radiance), medium=fog)
    return b.build(device=device)
