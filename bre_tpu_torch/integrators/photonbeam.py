"""Progressive Photon Beams (counterpart of
``bre_tpu/integrators/photonbeam.py``; pbrt photonbeam.cpp:328-611).

Per iteration: shoot photons into the fixed-capacity beam list, then walk
the camera paths; every in-medium segment gathers beam radiance; then the
radius shrinks, radius <- radius*(i+alpha)/(i+1) (photonbeam.cpp:562).
The gather takes the reference's route (photonbeam.py:168-205):
``gather="auto"``/``"pallas"`` with ``grad_geometry=False`` packs the beams
once per pass for the packed kernels (``accel/beam_gather.
gather_beams_packed``); every other setting, the defaults among them,
validity-sorts the beams once per pass (``compact_beams``) and gathers each
depth step through ``gather_beams_bruteforce``, with the forward kernel
(``"auto"``/``"pallas"``) or the plain chunk scan (``"brute"``).
``camera_pass`` is differentiable in the medium parameters and, with
``grad_geometry``, through the beam and segment geometry.

The reference's ``lax.scan`` over iterations and over camera depth steps are
Python loops here, and its ``lax.cond`` ray-budget tiers are Python branches
on a count read from the device (one host sync per depth step).

``kernel="compat"`` is the reference renderer's own estimator, for image
matching against it: the splitting photon walk
(``trace_photon_beams_compat``), the unnormalized conical kernel through the
plain chunk scan of ``gather_beams_bruteforce`` on every device (the
reference keeps it dense XLA, photonbeam.py:181-182), a gather on every
intersected segment, in a medium or not, the raw kernel sum added without
the camera throughput, Russian roulette after boundary hops too, and
``3 * maxdepth + 2`` camera steps.  ``gather="lbvh"`` raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..accel.beam_gather import (CHUNK, KERNEL_BRE, KERNEL_COMPAT, TILE,
                                 compact_beams, gather_beams_bruteforce,
                                 gather_beams_packed, medium_interval_poly,
                                 pack_beams_compact, permute_rows,
                                 validity_order)
from ..checkpoint import load_checkpoint, save_checkpoint
from ..core.math import absdot, dot, offset_ray_origin
from ..core.rng import pcg32_init, pcg32_next_f32
from ..core.spectrum import luminance
from ..lights import area_light_emitted, escaped_radiance, light_power_distribution
from ..materials import MODE_RADIANCE, sample_bsdf
from ..scene.camera import Camera, generate_rays, pixel_centers
from ..scene.intersect import intersect
from ..scene.scene import Scene, check_slice, world_span
from .common import default_tr_crossings, sample_one_light, segment_transmittance_det
from .photon_trace import trace_photon_beams, trace_photon_beams_compat

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PhotonBeamConfig:
    """Parameter names match CreatePhotonBeamIntegrator
    (photonbeam.cpp:589-604) and the reference's config."""

    iterations: int = 64
    startiteration: int = 0
    enditeration: Optional[int] = None
    maxdepth: int = 5
    photonsperiteration: int = -1  # -1 -> number of pixels
    imagewritefrequency: int = 1 << 31
    initialbeamradius: float = 1.0
    alpha: float = 0.5
    rendersurfaces: bool = True
    rendermedia: bool = True
    kernel: str = "bre"  # "bre" | "compat"
    # beams per chunk of the non-packed route's chunk loop (its recompute
    # backward holds rays x gather_chunk pairs); the kernels take 256-beam
    # chunks of the same buffer
    gather_chunk: int = 2048
    # "auto" = "pallas": the kernels (packed with grad_geometry=False), or
    # for kernel="compat" "brute"; "brute": the plain chunk scan; "lbvh":
    # not ported
    gather: str = "auto"
    tile: int = 128  # gather="lbvh" only
    max_candidates: int = 4096  # gather="lbvh" only
    grad_geometry: bool = True  # False: the packed route (medium fitting)
    grad_extras: bool = True  # False: skip the radius and HG g cotangents
    # >0: cap on live (chunk x tile) blocks for the sparse-block kernel;
    # 0 with gather="auto": a quarter of the block grid, clamped to 128k
    gather_sparse_cap: int = 0
    # shadow-ray boundary crossings; None = resolve from the scene
    tr_crossings: Optional[int] = None
    # the reference's choice of XLA loop form for the depth steps (scan or
    # unrolled); accepted for the same configs, no effect here (the depth
    # loop is a Python loop)
    depth_scan: Optional[bool] = None


def _check_config(cfg: PhotonBeamConfig) -> None:
    if cfg.kernel not in ("bre", "compat"):
        raise ValueError(f"unknown kernel {cfg.kernel!r}")
    if cfg.gather == "lbvh":
        raise NotImplementedError(
            'gather="lbvh" is not ported (ROADMAP Queue 1: breadth, '
            "accel/lbvh)")
    if cfg.gather not in ("auto", "pallas", "brute"):
        raise ValueError(f"unknown gather backend {cfg.gather!r}")


def camera_pass(scene: Scene, camera: Camera, width: int, height: int, beams,
                beam_radius, iter_idx: int, cfg: PhotonBeamConfig,
                photons_per_iter: int = 1):
    """One camera pass over the full film.  Returns (Ld (H*W,3), stats)."""
    R = width * height
    pix = torch.arange(R, dtype=torch.int64, device=scene.device)
    stream_ids = (int(iter_idx) * R + pix) & _U32
    return camera_pass_by_pixels(
        scene, camera, pixel_centers(width, height, scene.device), stream_ids,
        beams, beam_radius, cfg, photons_per_iter)


def camera_pass_by_pixels(scene: Scene, camera: Camera,
                          p_raster_base: torch.Tensor,
                          stream_ids: torch.Tensor, beams, beam_radius,
                          cfg: PhotonBeamConfig, photons_per_iter: int = 1):
    """Camera paths for the given pixels (photonbeam.cpp:442-557): per
    segment, gather beam radiance; direct lighting + BSDF continuation.
    Returns (Ld contribution (R,3), stats)."""
    _check_config(cfg)
    check_slice(scene)
    R = p_raster_base.shape[0]
    dev = scene.device
    # None means 0 here, as in the reference; render_photonbeam resolves it
    # from the scene before the first pass
    tr_crossings = cfg.tr_crossings or 0
    compat = cfg.kernel == "compat"
    kern = KERNEL_COMPAT if compat else KERNEL_BRE
    # grid media: the normalized estimate's tables; compat never takes them
    hetero = scene.media.density.numel() > 1 and not compat
    if cfg.gather == "auto":
        gather = "brute" if compat else "pallas"
    else:
        gather = cfg.gather
    # the packed route serves the kernels with the geometry detached
    # (photonbeam.py:189-190); everything else takes gather_beams_bruteforce
    use_packed = (gather == "pallas" and not cfg.grad_geometry and not compat
                  and cfg.rendermedia)
    if use_packed:
        # grid media: the beams' polynomial tables, once per pass, packed
        # beside them (photonbeam.py:196-202)
        d_poly = sigma_t = None
        if hetero:
            d_poly, _, sigma_t = medium_interval_poly(
                scene.media, beams.medium, beams.start, beams.end)
        beams_packed, n_valid_beams = pack_beams_compact(beams, d_poly=d_poly,
                                                         sigma_t=sigma_t)
    elif cfg.rendermedia:
        # one validity sort serves every depth step's gather
        beams = compact_beams(beams)
    power_scale = 1.0 / float(photons_per_iter)

    sparse_cap = cfg.gather_sparse_cap
    if cfg.gather == "auto" and use_packed and sparse_cap == 0:
        n_chunks_est = max(1, beams.capacity // CHUNK)
        total_blocks = n_chunks_est * max(1, R // TILE)
        sparse_cap = min(total_blocks // 4, 1 << 17)
    # compacted-ray budgets: one kernel tile, then R/4 (the reference's
    # off-TPU tiers, photonbeam.py:341-350)
    budgets = sorted({min(TILE, R), max(TILE, R // 4)})

    def gather_rays(o_, e_, d_, med_, tr_, cap=0):
        if use_packed:
            return gather_beams_packed(
                beams_packed, n_valid_beams, scene.media, o_, e_, d_, med_,
                tr_, beam_radius, power_scale=power_scale,
                grad_extras=cfg.grad_extras, sparse_cap=cap)
        return gather_beams_bruteforce(
            beams, scene.media, o_, e_, d_, med_, tr_, beam_radius,
            kernel=kern, chunk=cfg.gather_chunk,
            power_scale=power_scale, backend=gather,
            grad_geometry=cfg.grad_geometry, grad_extras=cfg.grad_extras,
            assume_compacted=True, hetero=hetero)

    rng = pcg32_init(stream_ids)
    rng, jx = pcg32_next_f32(rng)
    rng, jy = pcg32_next_f32(rng)
    p_raster = p_raster_base + (torch.stack([jx, jy], -1) - 0.5)
    o, d = generate_rays(camera, p_raster)

    beta = torch.ones((R, 3), dtype=torch.float32, device=dev)
    medium = scene.camera_medium.expand(R).clone()
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    specular = torch.zeros((R,), dtype=torch.bool, device=dev)
    first = torch.ones((R,), dtype=torch.bool, device=dev)
    Ld = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    span = world_span(scene)
    zero3 = torch.zeros((), dtype=torch.float32, device=dev)

    # null-boundary hops use no depth (photonbeam.cpp:515-517): compat
    # budgets two hops per real bounce, since its raw kernel sum does not
    # decay with the camera throughput (photonbeam.py:479-492)
    n_cam_steps = 3 * cfg.maxdepth + 2 if compat else cfg.maxdepth + 2
    for _depth in range(n_cam_steps):
        h = intersect(scene, o, d)
        miss = alive & ~h.valid
        Ld = Ld + torch.where(miss[:, None], beta * escaped_radiance(scene, d),
                              zero3)
        # clamp the 1e30 miss sentinel to world scale before the gather
        t_seg = torch.minimum(h.t, span)
        p_seg_end = o + t_seg[:, None] * d
        tr_seg = segment_transmittance_det(scene, medium, o, d, t_seg)

        # gather on in-medium segments; compat gathers on every
        # intersected segment, as the reference does (photonbeam.cpp:494);
        # rendermedia False gathers nothing (photonbeam.py:247)
        if cfg.rendermedia:
            seg_valid = alive & h.valid
            if not compat:
                seg_valid = seg_valid & (medium >= 0)
            n_valid = int(seg_valid.sum())
            gathered = torch.zeros((R, 3), dtype=torch.float32, device=dev)
            if n_valid > 0:
                budget = next((b for b in budgets if b < R and n_valid <= b),
                              None)
                if budget is None:
                    gathered = gather_rays(o, p_seg_end, d, medium, tr_seg,
                                           cap=sparse_cap)
                else:
                    # valid rays first (stable), then the smallest budget;
                    # the rows move by a permutation, whose backward is a
                    # gather (indexing's would accumulate)
                    order, inv_order = validity_order(seg_valid)
                    take = order[:budget]

                    def lead(x):
                        return permute_rows(x, order, inv_order)[:budget]
                    g = gather_rays(lead(o), lead(p_seg_end), lead(d),
                                    medium[take], lead(tr_seg))
                    gathered.index_copy_(0, take, g)
            # compat adds the raw kernel sum (photonbeam.cpp:504)
            add = gathered if compat else beta * gathered
            Ld = Ld + torch.where(seg_valid[:, None], add, zero3)

        beta = beta * tr_seg  # photonbeam.cpp:510
        surf = alive & h.valid
        is_boundary = surf & (h.material < 0)
        entering = dot(d, h.n) < 0.0
        medium_after_boundary = torch.where(entering, h.medium_inside,
                                            h.medium_outside)

        # emitted radiance on first/specular hits (photonbeam.cpp:528-529)
        see_le = surf & (first | specular)
        Le = area_light_emitted(scene, h.area_light, h.n, -d)
        Ld = Ld + torch.where(see_le[:, None], beta * Le, zero3)

        # direct lighting (photonbeam.cpp:530-532)
        if cfg.rendersurfaces:
            rng, nee = sample_one_light(
                scene, rng, p_seg_end, h.ns, -d, h.material, medium,
                torch.ones((R,), dtype=torch.bool, device=dev),
                tangent=h.tangent, tr_crossings=tr_crossings)
            Ld = Ld + torch.where((surf & ~is_boundary)[:, None], beta * nee,
                                  zero3)

        # BSDF continuation (photonbeam.cpp:535-546)
        rng, s0 = pcg32_next_f32(rng)
        rng, s1 = pcg32_next_f32(rng)
        bs = sample_bsdf(scene.materials, h.material, h.ns, -d,
                         torch.stack([s0, s1], -1), mode=MODE_RADIANCE,
                         tangent=h.tangent)
        cont = surf & ~is_boundary & bs.valid & cfg.rendersurfaces
        pdf_ok = cont & (bs.pdf > 1e-12)
        one = torch.ones_like(bs.pdf)
        new_beta = torch.where(
            pdf_ok[:, None],
            beta * bs.f * (absdot(bs.wi, h.ns)
                           / torch.where(pdf_ok, bs.pdf, one))[:, None],
            beta)
        bd3 = is_boundary[:, None]
        new_d = torch.where(cont[:, None], bs.wi, d)
        new_o = torch.where(surf[:, None], offset_ray_origin(
            p_seg_end, h.n, torch.where(bd3, d, bs.wi)), o)
        new_medium = torch.where(
            is_boundary, medium_after_boundary,
            torch.where(cont & (dot(bs.wi, h.n) > 0.0), h.medium_outside,
                        torch.where(cont, h.medium_inside, medium)))
        new_alive = (cont | is_boundary) & alive
        specular = torch.where(cont, bs.specular, specular)
        first = first & is_boundary  # first real hit not yet seen

        # Russian roulette (photonbeam.cpp:549-554)
        rng, u_rr = pcg32_next_f32(rng)
        y = luminance(new_beta)
        do_rr = new_alive & (y < 0.25)
        if not compat:
            # compat rolls after boundary hops too (photonbeam.cpp:549)
            do_rr = do_rr & ~is_boundary
        cont_prob = torch.clamp_max(y, 1.0)
        killed = do_rr & (u_rr > cont_prob)
        keep = do_rr & ~killed & (cont_prob > 1e-6)
        new_beta = torch.where(
            keep[:, None],
            new_beta / torch.where(keep, cont_prob, one)[:, None], new_beta)
        o, d, beta, medium = new_o, new_d, new_beta, new_medium
        alive = new_alive & ~killed

    return Ld, dict(camera_rays=R)


def render_photonbeam(scene: Scene, camera: Camera, width: int, height: int,
                      cfg: PhotonBeamConfig = PhotonBeamConfig(),
                      write_callback: Optional[Callable] = None,
                      checkpoint_path: Optional[str] = None):
    """Full progressive render (photonbeam.cpp:328-587).

    Returns (image (H,W,3) tensor on the scene's device, stats dict).
    ``write_callback(iter, image)`` runs every ``imagewritefrequency``
    iterations and at the end, with a CPU copy of the running image.  With
    ``checkpoint_path``, the state (the next iteration, its radius and the
    float32 ``Ld`` sum) is saved at every write point, and a checkpoint
    past ``startiteration`` is resumed from (the reference's
    photonbeam.py:545-552, 622-629)."""
    _check_config(cfg)
    check_slice(scene)
    if cfg.tr_crossings is None:
        cfg = dataclasses.replace(cfg, tr_crossings=default_tr_crossings(scene))
    n_pixels = width * height
    photons = cfg.photonsperiteration if cfg.photonsperiteration > 0 else n_pixels
    end_iter = cfg.enditeration if cfg.enditeration is not None else cfg.iterations
    light_distr = light_power_distribution(scene)

    # radius fast-forward for startiteration (photonbeam.cpp:354-357)
    radius = float(cfg.initialbeamradius)
    start_iter = cfg.startiteration
    for i in range(start_iter):
        radius = radius * (i + cfg.alpha) / (i + 1)

    Ld_total = torch.zeros((n_pixels, 3), dtype=torch.float32,
                           device=scene.device)
    resumed = False
    if checkpoint_path is not None:
        ck = load_checkpoint(checkpoint_path)
        if ck is not None and ck["iteration"] > start_iter:
            Ld = ck["buffers"]["Ld"]
            if Ld.shape != (n_pixels, 3) or Ld.dtype != np.float32:
                raise ValueError(
                    f"{checkpoint_path}: Ld is {Ld.dtype} {Ld.shape}, not "
                    f"float32 ({n_pixels}, 3) for a {width}x{height} film")
            start_iter, radius, resumed = ck["iteration"], ck["radius"], True
            Ld_total = torch.as_tensor(Ld, device=scene.device)
    stats_total: dict = {}
    for it in range(start_iter, end_iter):
        # radius is rounded to float32 where it enters the device, as in
        # the reference's f32 schedule array
        rad32 = float(torch.tensor(radius, dtype=torch.float32))
        if cfg.kernel == "compat":
            idx = torch.arange(photons, dtype=torch.int64, device=scene.device)
            beams, tstats = trace_photon_beams_compat(
                scene, light_distr, (it * photons + idx) & _U32,
                cfg.maxdepth, rad32)
        else:
            beams, tstats = trace_photon_beams(
                scene, light_distr, it, photons, cfg.maxdepth, rad32,
                detach_sampling=not cfg.grad_geometry, long_beams=True)
        Ld, cstats = camera_pass(scene, camera, width, height, beams, rad32,
                                 it, cfg, photons_per_iter=photons)
        Ld_total = Ld_total + Ld
        for k, v in {**tstats, **cstats}.items():
            stats_total[k] = stats_total.get(k, 0) + int(v)
        radius = radius * (it + cfg.alpha) / (it + 1)  # photonbeam.cpp:562
        done = it + 1
        if done == end_iter or done % cfg.imagewritefrequency == 0:
            if write_callback is not None:
                img = (Ld_total / done).reshape(height, width, 3)
                write_callback(done - 1, img.cpu())
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, done, radius,
                                {"Ld": Ld_total.detach().cpu().numpy()})
    # a resumed Ld carries iterations [0, end); a fresh one
    # [startiteration, end)
    n_iter = max(end_iter - (0 if resumed else cfg.startiteration), 1)
    image = (Ld_total / n_iter).reshape(height, width, 3)
    stats_total["final_radius"] = radius
    return image, stats_total
