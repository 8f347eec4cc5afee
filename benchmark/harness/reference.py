"""The reference side of the check: the frozen plain copy (``pbref``)
renders the checked pixels of a job, and the comparison with what the
program's timed render produced for them.

``render_pixels`` is ``render_photonbeam``'s loop as the copy has it
(``startiteration`` 0, no checkpoint), restricted to a set of pixels:
every iteration traces all the photons (the same streams as the program)
and walks the camera paths of those pixels only, with the pixel's own
stream ids, so each pixel gets the value the full film would give it.
The gather runs the copy's plain versions over every live block; with
``pair_dtype=torch.bfloat16`` their pair arithmetic is bfloat16, the
lower-precision control.

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kits import build

_U32 = 0xFFFFFFFF


def pixel_blocks(rng: np.random.Generator, width: int, height: int,
                 n_blocks: int, size: int) -> list:
    """``n_blocks`` square blocks of ``size``^2 pixels at positions drawn
    from ``rng``, each as row-major flat pixel indices (one ray tile, so
    the copy's block cull stays tight)."""
    out = []
    for _ in range(n_blocks):
        x0 = int(rng.integers(0, width - size + 1))
        y0 = int(rng.integers(0, height - size + 1))
        ys, xs = np.meshgrid(np.arange(y0, y0 + size),
                             np.arange(x0, x0 + size), indexing="ij")
        out.append((ys * width + xs).reshape(-1))
    return out


@torch.no_grad()
def render_pixels(kit, cell, job, blocks: list, device,
                  pair_dtype=torch.float32) -> list:
    """The job's image at each block's pixels, [(n, 3) float32 CPU]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene, camera, pcfg = build(kit, cell, job, device)
    if pcfg.tr_crossings is None:
        pcfg = dataclasses.replace(
            pcfg, tr_crossings=kit.common.default_tr_crossings(scene))
    W, H = cell.config["width"], cell.config["height"]
    R = W * H
    photons = pcfg.photonsperiteration if pcfg.photonsperiteration > 0 else R
    light_distr = kit.light_power_distribution(scene)
    centers = kit.pixel_centers(W, H, device)
    pix = [torch.as_tensor(b, dtype=torch.int64, device=device)
           for b in blocks]
    acc = [torch.zeros((p.shape[0], 3), dtype=torch.float32, device=device)
           for p in pix]
    token = kit.gather.PAIR_DTYPE.set(pair_dtype)
    try:
        radius = float(pcfg.initialbeamradius)
        for it in range(pcfg.iterations):
            rad32 = float(torch.tensor(radius, dtype=torch.float32))
            beams, _ = kit.photon_trace.trace_photon_beams(
                scene, light_distr, it, photons, pcfg.maxdepth, rad32,
                detach_sampling=not pcfg.grad_geometry, long_beams=True)
            for k, p in enumerate(pix):
                Ld, _ = kit.photonbeam.camera_pass_by_pixels(
                    scene, camera, centers[p], (it * R + p) & _U32, beams,
                    rad32, pcfg, photons_per_iter=photons)
                acc[k] += Ld
            radius = radius * (it + pcfg.alpha) / (it + 1)
    finally:
        kit.gather.PAIR_DTYPE.reset(token)
    return [(a / pcfg.iterations).cpu() for a in acc]


def pixel_gap(program: list, reference: list) -> float:
    """The widest gap between the program's and the reference's pixel
    values, each against the larger of the reference's own value and the
    median of the reference's checked values (dark pixels are not held
    to a relative bound of their own)."""
    p = torch.cat([x.reshape(-1) for x in program]).double()
    r = torch.cat([x.reshape(-1) for x in reference]).double()
    if not bool(torch.isfinite(p).all()):
        return float("inf")
    scale = torch.clamp_min(r.abs(), float(r.abs().median()))
    scale = torch.clamp_min(scale, 1e-30)
    return float(((p - r).abs() / scale).max())


# ---------------------------------------------------------------------------
# fitting: one progressive iteration of the whole film per optimizer step
# ---------------------------------------------------------------------------

def film_iteration(kit, scene, camera, width: int, height: int, pcfg):
    """``run(iter_idx, radius, scene_in) -> Ld (R, 3)``: one iteration of
    the whole film with the copy's walk and camera pass, photon ids
    ``iter_idx * photons + i`` and pixel stream ids ``iter_idx * R + p``;
    differentiable in ``scene_in``'s medium parameters."""
    if pcfg.tr_crossings is None:
        pcfg = dataclasses.replace(
            pcfg, tr_crossings=kit.common.default_tr_crossings(scene))
    R = width * height
    photons = pcfg.photonsperiteration if pcfg.photonsperiteration > 0 else R
    dev = scene.device
    centers = kit.pixel_centers(width, height, dev)
    arange_p = torch.arange(photons, dtype=torch.int64, device=dev)
    arange_r = torch.arange(R, dtype=torch.int64, device=dev)
    light_distr = kit.light_power_distribution(scene)

    def run(iter_idx: int, radius: float, scene_in):
        rad32 = float(torch.tensor(float(radius), dtype=torch.float32))
        beams, _ = kit.photon_trace.trace_photon_beams_by_index(
            scene_in, light_distr, (int(iter_idx) * photons + arange_p) & _U32,
            pcfg.maxdepth, rad32, detach_sampling=not pcfg.grad_geometry)
        Ld, _ = kit.photonbeam.camera_pass_by_pixels(
            scene_in, camera, centers, (int(iter_idx) * R + arange_r) & _U32,
            beams, rad32, pcfg, photons_per_iter=photons)
        return Ld

    return run


def tv(density: torch.Tensor) -> torch.Tensor:
    """The sum over the three axes of mean(diff(density)^2)."""
    return sum(torch.mean(torch.diff(density, dim=ax) ** 2)
               for ax in range(3))


def fit_steps(run, scene, params: dict, target, optimize, lr: float,
              tv_weight: float, n_steps: int, radius: float):
    """``n_steps`` Adam steps (b1 0.9, b2 0.999, eps 1e-8, then a clamp at
    0) on mean((Ld - target)^2) + tv_weight * tv(density), written out:
    (losses, the first gradient, the fitted parameters after the last
    step), all on the CPU."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(p[k]) for k in optimize}
    v = {k: torch.zeros_like(p[k]) for k in optimize}
    R = target.shape[0]
    losses, grad0 = [], None
    for it in range(n_steps):
        leaves = {k: p[k].clone().requires_grad_() for k in optimize}
        media = scene.media._replace(**{**p, **leaves})
        Ld = run(it, radius, scene._replace(media=media))
        loss = torch.sum((Ld - target) ** 2) / (3 * R)
        if tv_weight > 0.0 and "density" in optimize:
            loss = loss + tv_weight * tv(leaves["density"])
        grads = torch.autograd.grad(loss, [leaves[k] for k in optimize],
                                    allow_unused=True)
        grads = [torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(optimize, grads)]
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = {k: g.detach().cpu() for k, g in zip(optimize, grads)}
        t = it + 1
        with torch.no_grad():
            for k, g in zip(optimize, grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v[k] / (1 - b2 ** t)
                p[k] = torch.clamp_min(
                    p[k] - lr * m_hat / (torch.sqrt(v_hat) + eps), 0.0)
    return losses, grad0, {k: p[k].cpu() for k in optimize}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The widest gap between the program's and the reference's norms of a
    leaf, against the larger of the reference's norm of that leaf and of
    the median leaf; ``keep`` names the leaves compared (all: None)."""
    ref = {k: float(torch.linalg.vector_norm(v.double()))
           for k, v in reference.items()}
    median = float(np.median(list(ref.values())))
    worst = 0.0
    for k, r in ref.items():
        if keep is not None and k not in keep:
            continue
        p = program[k].double()
        if not bool(torch.isfinite(p).all()):
            return float("inf")
        gap = abs(float(torch.linalg.vector_norm(p)) - r)
        worst = max(worst, gap / max(r, median, 1e-30))
    return worst
