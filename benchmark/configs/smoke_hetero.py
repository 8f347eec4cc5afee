"""Scene recipe of ``smoke_hetero.json`` (``examples/smoke_hetero.py``): a
procedural 32^3 grid density in the box [-1, 1]^3 with anisotropic HG
scattering, a point light inside it and a wall behind.

``build_scene(kit, cfg, light_scale, device)`` builds it with ``kit``'s
``SceneBuilder``: the program's or the reference's, which share the API.
"""

import numpy as np


def density_grid(n):
    """The example's elongated puff with swirls, (n, n, n) float32."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    dens = np.exp(-2.0 * (x**2 + 2 * y**2 + z**2))
    dens *= 1.0 + 0.5 * np.sin(4 * x) * np.cos(3 * z)
    return np.clip(dens, 0.0, None).astype(np.float32)


def build_scene(kit, cfg, light_scale, device):
    med, light = cfg["medium"], cfg["light"]
    b = kit.SceneBuilder()
    # world [-1,1]^3 -> medium [0,1]^3
    w2m = np.array(
        [[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5], [0, 0, 0.5, 0.5], [0, 0, 0, 1]],
        np.float32)
    smoke = b.grid_medium(density_grid(med["resolution"]), w2m,
                          sigma_a=tuple(med["sigma_a"]),
                          sigma_s=tuple(med["sigma_s"]), g=med["g"])
    wall = b.matte((0.5, 0.5, 0.6))
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=smoke,
          medium_outside=-1)
    b.quad((-4, -4, 2.5), (-4, 4, 2.5), (4, 4, 2.5), (4, -4, 2.5),
           material=wall)
    intensity = np.asarray(light["intensity"], np.float64) * light_scale
    b.point_light(tuple(light["position"]),
                  tuple(float(v) for v in intensity), medium=smoke)
    return b.build(device=device)
