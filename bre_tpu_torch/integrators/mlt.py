"""Metropolis light transport in primary sample space over the BDPT
strategies (counterpart of ``bre_tpu/integrators/mlt.py``; pbrt
mlt.{h,cpp}: MLTSampler, MLTIntegrator::L and Render).

All chains advance in lockstep as one batch.  A chain's primary sample
vector is a row of a (C, D) matrix, and a mutation perturbs every
dimension.  An evaluation runs the BDPT machinery with ``PathSampler`` in
primary-sample mode; each chain's strategy is a masked sum over every
(s,t) connection.  Bootstrap vectors are regenerated from their index
(pbrt's ``rngSequenceIndex``).  The expected-value splats of each step go
onto the film through ``core.math.ordered_index_sum`` (a sorted segment
sum in lane order) in place of the reference's ``.at[].add``, so two runs
on a card give the same bits.  The bootstrap CDF is added on the host, in
index order, so the card and the CPU seed the same chains.

Grid media draw inside their tracking from a PCG32 stream keyed by the
mutation counter, a pseudo-marginal chain there (the luminance is carried
with the state, never recomputed), as in the reference.

A chain step's evaluation is some 40,000 small kernels on a few hundred
lanes (maxdepth 5), whose launches set the pace on a card.  There, for a
scene without a grid medium (whose tracking reads a host flag every trip)
and without a tri-BVH (whose walk reads one every few trips), the
evaluation is captured once as a CUDA graph and replayed each step
(``_step_evaluator``); the kernels and their order are those of the eager
evaluation.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import ordered_index_sum
from ..core.rng import PCG32State, pcg32_init, pcg32_next_f32
from ..core.spectrum import luminance
from ..lights import light_choice_pmf
from ..scene.camera import Camera, generate_rays
from ..scene.scene import Scene, check_slice
from .bdpt import (PathSampler, _generate_camera_subpath,
                   _generate_light_subpath, connect_bdpt, raster_pixel,
                   strategies)

SQRT2 = 1.41421356237
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class MLTConfig:
    """Parameter names follow CreateMLTIntegrator (mlt.cpp:~262-280)."""

    maxdepth: int = 5
    bootstrapsamples: int = 4096
    chains: int = 256
    mutationsperpixel: int = 100
    largestepprobability: float = 0.3
    sigma: float = 0.01


def _n_dims(maxdepth: int) -> int:
    """Primary-sample dims one evaluation consumes (mlt.py:63-69): strategy
    pick (1) + film position (2) + camera walk ((maxdepth+1) slots x 12
    draws: 4 x 2 segment columns, 2 phase, 2 BSDF) + light subpath (1 pick
    + 4 Sample_Le + maxdepth x 12) + one s=1 light connection (3)."""
    per_slot = 12
    return 3 + per_slot * (maxdepth + 1) + (5 + per_slot * maxdepth) + 3


def _regen_u(flat_index: torch.Tensor, n_dims: int) -> torch.Tensor:
    """A bootstrap primary-sample row from its index (MLTSampler
    rngSequenceIndex, mlt.h:62): dimension j of row i from
    ``RNG(i * n_dims + j + 0x4D4C54)``, uint32 arithmetic."""
    C = flat_index.shape[0]
    seeds = (flat_index[:, None] * n_dims
             + torch.arange(n_dims, dtype=torch.int64,
                            device=flat_index.device)[None, :] + 0x4D4C54)
    _, u = pcg32_next_f32(pcg32_init(seeds.reshape(-1) & _U32))
    return u.reshape(C, n_dims)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """ErfInv (pbrt core/pbrt.h), Giles' single-precision polynomials in
    float32, in the reference's Horner order."""
    x = torch.clamp(x, -0.99999, 0.99999)
    w = -torch.log((1.0 - x) * (1.0 + x))
    w_small = w - 2.5
    p_small = 2.81022636e-08 * torch.ones_like(w)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        p_small = p_small * w_small + c
    w_big = torch.sqrt(torch.clamp_min(w, 1e-12)) - 3.0
    p_big = -0.000200214257 * torch.ones_like(w)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        p_big = p_big * w_big + c
    return torch.where(w < 5.0, p_small, p_big) * x


def _evaluate(scene: Scene, camera: Camera, width: int, height: int, u,
              depth, rng_eval, maxdepth: int, pmf):
    """MLTIntegrator::L (mlt.cpp:~120-170) for a batch of chains: u (C, D)
    primary samples, depth (C,) each chain's path depth.  Returns (L (C,3),
    p_raster (C,2))."""
    C = u.shape[0]
    # the strategy (mlt.cpp): s=0, t=2 at depth 0, else uniform over depth+2
    n_strategies = torch.where(depth == 0, 1, depth + 2)
    s_pick = torch.minimum((u[:, 0] * n_strategies).to(torch.int64),
                           n_strategies - 1)
    s_pick = torch.where(depth == 0, 0, s_pick)

    p_film = torch.stack([u[:, 1] * width, u[:, 2] * height], -1)
    o, d = generate_rays(camera, p_film)
    sp = PathSampler(rng_eval, u=u[:, 3:])
    cam_vs = _generate_camera_subpath(scene, camera, width, height, o, d, sp,
                                      maxdepth)
    light_vs = _generate_light_subpath(scene, sp, C, maxdepth, pmf)
    # one s=1 connection's dims, shared by every t (only the chosen
    # strategy counts: pbrt evaluates exactly one, this masks)
    u_connect = torch.stack([sp.next1(), sp.next1(), sp.next1()], -1)

    L = torch.zeros((C, 3), dtype=torch.float32, device=u.device)
    p_out = p_film
    for s, t in strategies(maxdepth):
        chosen = (depth == t + s - 2) & (s_pick == s)
        sp_conn = PathSampler(sp.rng, u=u_connect)
        Lst, p_raster, _, sok = connect_bdpt(scene, camera, width, height,
                                             cam_vs, light_vs, s, t, sp_conn,
                                             pmf)
        sp.rng = sp_conn.rng
        L = L + torch.where(chosen[:, None], Lst * n_strategies[:, None], 0.0)
        if t == 1:
            p_out = torch.where((chosen & sok)[:, None], p_raster, p_out)
    return L, p_out


def _capturable(scene: Scene) -> bool:
    """Whether an evaluation can be one CUDA graph: not where a loop reads
    the host to know when it is done, the grid media's tracking
    (``media.py``) and the tri-BVH walk (``scene/intersect.py``)."""
    return scene.media.density.numel() <= 1 and scene.tri_bvh is None


def _step_evaluator(scene: Scene, camera: Camera, width: int, height: int,
                    depth, maxdepth: int, pmf, n_dims: int):
    """``f(u, rng) -> _evaluate(..., u, depth, rng, ...)`` for the chain
    steps.  On a card and where ``_capturable``, one capture of the
    evaluation on static buffers (after a warm-up on a side stream) that
    each call fills and replays; else the eager evaluation."""
    def run(u, rng):
        return _evaluate(scene, camera, width, height, u, depth, rng,
                         maxdepth, pmf)

    dev = depth.device
    if dev.type != "cuda" or not _capturable(scene):
        return run
    C = depth.shape[0]
    u_in = torch.zeros((C, n_dims), dtype=torch.float32, device=dev)
    rng_in = PCG32State(torch.zeros((C,), dtype=torch.int64, device=dev),
                        torch.ones((C,), dtype=torch.int64, device=dev))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run(u_in, rng_in)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        L_out, p_out = run(u_in, rng_in)

    def replay(u, rng):
        u_in.copy_(u)
        rng_in.state.copy_(rng.state)
        rng_in.inc.copy_(rng.inc)
        graph.replay()
        return L_out.clone(), p_out.clone()
    return replay


def bootstrap(scene: Scene, camera: Camera, width: int, height: int,
              cfg: MLTConfig, pmf):
    """The bootstrap (mlt.cpp Render): ``bootstrapsamples`` paths per depth,
    entry i * (maxdepth+1) + d evaluated from its regenerated row at depth
    d.  Returns the (n_boot, maxdepth+1) luminances."""
    n_depths = cfg.maxdepth + 1
    D = _n_dims(cfg.maxdepth)
    dev = scene.device
    cols = []
    for dv in range(n_depths):
        idx = dv + torch.arange(cfg.bootstrapsamples, dtype=torch.int64,
                                device=dev) * n_depths
        depth = torch.full((cfg.bootstrapsamples,), dv, dtype=torch.int64,
                           device=dev)
        L, _ = _evaluate(scene, camera, width, height, _regen_u(idx, D),
                         depth, pcg32_init((idx + 0xE7A1) & _U32),
                         cfg.maxdepth, pmf)
        cols.append(luminance(L))
    return torch.stack(cols, -1)


def seed_chains(weights: torch.Tensor, chains: int) -> torch.Tensor:
    """Each chain's bootstrap entry, drawn in proportion to its luminance
    (mlt.cpp nChains loop; mlt.py:179-188): the count of normalized CDF
    values <= ``RNG(c + 0xC417)``'s first draw, capped at the last entry.
    The CDF is added in index order on the host (a double accumulator), so
    the card and the CPU pick alike."""
    dev = weights.device
    cdf = torch.cumsum(weights.reshape(-1).cpu(), 0).to(dev)
    total = torch.clamp_min(cdf[-1], 1e-30)
    _, u_pick = pcg32_next_f32(pcg32_init(
        torch.arange(chains, dtype=torch.int64, device=dev) + 0xC417))
    picks = torch.searchsorted(cdf / total, u_pick, right=True)
    return torch.clamp_max(picks, weights.numel() - 1)


def render_mlt(scene: Scene, camera: Camera, width: int, height: int,
               cfg: MLTConfig = MLTConfig()) -> torch.Tensor:
    """MLTIntegrator::Render (mlt.cpp:~172-260; mlt.py:154-255).  Returns
    the (H, W, 3) image on the scene's device."""
    check_slice(scene)
    maxdepth = cfg.maxdepth
    n_depths = maxdepth + 1
    D = _n_dims(maxdepth)
    dev = scene.device
    pmf = light_choice_pmf(scene)
    weights = bootstrap(scene, camera, width, height, cfg, pmf)
    b = weights.mean() * n_depths  # bootstrapI.funcInt * (maxDepth+1)

    C = cfg.chains
    picks = seed_chains(weights, C)
    depth = picks % n_depths
    u_cur = _regen_u(picks, D)
    L_cur, p_cur = _evaluate(scene, camera, width, height, u_cur, depth,
                             pcg32_init((picks + 0xE7A1) & _U32), maxdepth,
                             pmf)

    evaluate = _step_evaluator(scene, camera, width, height, depth, maxdepth,
                               pmf, D)
    n_steps = max(1, (cfg.mutationsperpixel * width * height + C - 1) // C)
    R = width * height
    film = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    rng = pcg32_init(torch.arange(C, dtype=torch.int64, device=dev) + 0xAAC3)
    lanes = torch.arange(C * D, dtype=torch.int64, device=dev)
    chain = torch.arange(C, dtype=torch.int64, device=dev)
    for step in range(n_steps):
        lum_cur = luminance(L_cur)
        rng, u_large = pcg32_next_f32(rng)
        large = u_large < cfg.largestepprobability
        # fresh uniforms, or a small Gaussian perturbation, of every dim
        seeds = (step * C * D + lanes + 0x51E9) & _U32
        _, fresh = pcg32_next_f32(pcg32_init(seeds))
        _, u_mut = pcg32_next_f32(pcg32_init(seeds + 0x9999))
        perturbed = u_cur + cfg.sigma * SQRT2 * _erf_inv(
            2.0 * u_mut.reshape(C, D) - 1.0)
        perturbed = perturbed - torch.floor(perturbed)
        u_prop = torch.where(large[:, None], fresh.reshape(C, D), perturbed)

        rng_eval = pcg32_init((step * C + chain + 0x77E5) & _U32)
        L_prop, p_prop = evaluate(u_prop, rng_eval)
        lum_prop = luminance(L_prop)
        accept = torch.clamp_max(lum_prop / torch.clamp_min(lum_cur, 1e-30),
                                 1.0)
        accept = torch.where(lum_cur <= 0.0,
                             (lum_prop > 0.0).to(torch.float32), accept)

        # expected-value splats (mlt.cpp:~240-252): the proposal's, then
        # the current state's
        w_prop = accept / torch.clamp_min(lum_prop, 1e-30)
        w_cur = (1.0 - accept) / torch.clamp_min(lum_cur, 1e-30)
        film = film + ordered_index_sum(
            torch.cat([raster_pixel(p_prop, width, height),
                       raster_pixel(p_cur, width, height)]),
            torch.cat([torch.where((lum_prop > 0.0)[:, None],
                                   L_prop * w_prop[:, None], 0.0),
                       torch.where((lum_cur > 0.0)[:, None],
                                   L_cur * w_cur[:, None], 0.0)]), R)

        rng, u_acc = pcg32_next_f32(rng)
        take = u_acc < accept
        u_cur = torch.where(take[:, None], u_prop, u_cur)
        L_cur = torch.where(take[:, None], L_prop, L_cur)
        p_cur = torch.where(take[:, None], p_prop, p_cur)

    mutations_per_pixel = (n_steps * C) / R
    return (film * (b / mutations_per_pixel)).reshape(height, width, 3)
