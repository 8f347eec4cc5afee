"""The stock integrators path, whitted, directlighting, sppm and ao
(counterpart of ``bre_tpu/integrators/extra.py``; pbrt
src/integrators/{path,whitted,directlighting,ao,sppm}.cpp), as
configurations of the shared machinery:

- ``path``: volpath (on a scene without media the two coincide);
- ``whitted``: specular-only continuations, light-sampling-only NEE over
  every light (whitted.cpp:49-108);
- ``directlighting``: specular-only continuations, EstimateDirect's
  two-sample MIS (directlighting.cpp), over every light or one;
- ``sppm``: vsppm with ``rendermedia=False``;
- ``ao``: the cosine-weighted unoccluded fraction (ao.cpp:52-96).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import coordinate_system, dot, normalize, offset_ray_origin
from ..core.rng import pcg32_init, pcg32_next_f32
from ..core.sampling import cosine_sample_hemisphere
from ..scene.camera import Camera, generate_rays, pixel_centers
from ..scene.intersect import intersect, intersect_p
from ..scene.scene import Scene
from .volpath import VolPathConfig, render_volpath
from .vsppm import VSPPMConfig, render_vsppm

# shadow rays traced at once by render_ao
AO_LANES = 1 << 20


def render_path(scene: Scene, camera: Camera, width: int, height: int,
                cfg: VolPathConfig = VolPathConfig()):
    """src/integrators/path.cpp (volpath, its media-aware superset)."""
    return render_volpath(scene, camera, width, height, cfg)


def render_whitted(scene: Scene, camera: Camera, width: int, height: int,
                   maxdepth: int = 5, spp: int = 16):
    """whitted.cpp:49-108: light-sampling-only direct light from every
    light and the specular recursion."""
    return render_volpath(scene, camera, width, height, VolPathConfig(
        maxdepth=maxdepth, spp=spp, indirect="specular",
        samplealllights=True, nee_mis=False))


def render_directlighting(scene: Scene, camera: Camera, width: int,
                          height: int, maxdepth: int = 5, spp: int = 16,
                          strategy: str = "all"):
    """directlighting.cpp: EstimateDirect's two-sample MIS at every hit and
    the specular recursion; ``strategy`` "all" (every light, the
    reference's default) or "one"."""
    return render_volpath(scene, camera, width, height, VolPathConfig(
        maxdepth=maxdepth, spp=spp, indirect="specular",
        samplealllights=(strategy == "all"), nee_mis=True))


def render_sppm(scene: Scene, camera: Camera, width: int, height: int,
                cfg: VSPPMConfig = VSPPMConfig()):
    """src/integrators/sppm.cpp: surface-only progressive photon mapping."""
    return render_vsppm(scene, camera, width, height,
                        dataclasses.replace(cfg, rendermedia=False))


@dataclasses.dataclass(frozen=True)
class AOConfig:
    nsamples: int = 64  # ao.cpp "nsamples"
    maxdistance: float = 1e30  # ao.cpp "maxdistance"
    cossample: bool = True


def render_ao(scene: Scene, camera: Camera, width: int, height: int,
              cfg: AOConfig = AOConfig()) -> torch.Tensor:
    """Ambient occlusion (ao.cpp:52-96; extra.py:77-107): pixel i draws its
    samples' directions in order from ``RNG(i)``; the shadow rays of all
    samples are traced as one batch (up to ``AO_LANES`` at a time) and
    counted per pixel.  Returns the (H, W, 3) image on the scene's device."""
    R = width * height
    dev = scene.device
    o, d = generate_rays(camera, pixel_centers(width, height, dev))
    h = intersect(scene, o, d)
    n = torch.where((dot(h.ns, -d) < 0)[:, None], -h.ns, h.ns)
    vx, vy = coordinate_system(n)
    rng = pcg32_init(torch.arange(R, dtype=torch.int64, device=dev))
    us = []
    for _ in range(cfg.nsamples):
        rng, u0 = pcg32_next_f32(rng)
        rng, u1 = pcg32_next_f32(rng)
        us.append(torch.stack([u0, u1], -1))
    u = torch.stack(us, 0).reshape(-1, 2)  # sample-major: (S * R, 2)
    rep = lambda x: x.repeat(cfg.nsamples, 1)  # noqa: E731
    wl = cosine_sample_hemisphere(u)
    nn = rep(n)
    wi = normalize(wl[:, 0:1] * rep(vx) + wl[:, 1:2] * rep(vy)
                   + wl[:, 2:3] * nn)
    o_sh = offset_ray_origin(rep(h.p), nn, wi)
    occ = torch.cat([intersect_p(
        scene, o_sh[i:i + AO_LANES], wi[i:i + AO_LANES],
        torch.full((min(AO_LANES, wi.shape[0] - i),), cfg.maxdistance,
                   dtype=torch.float32, device=dev))
        for i in range(0, wi.shape[0], AO_LANES)])
    hits = (h.valid.repeat(cfg.nsamples) & ~occ).reshape(cfg.nsamples, R)
    ao = hits.sum(0).to(torch.float32) / cfg.nsamples
    return ao[:, None].expand(R, 3).reshape(height, width, 3)
