"""Beam radiance gather, packed path (counterpart of
``bre_tpu/accel/beam_gather.py:193-323, 893-1318``).

The beam buffer is validity-compacted and Morton-sorted once per camera pass
(``pack_beams_compact``); each depth step packs its camera segments, builds
the exact chunk x tile AABB cull mask (``_block_overlap_mask``) and runs the
kernels of ``ops/gather.py``, picking at run time between the sparse
live-block kernel (live blocks within ``sparse_cap``) and the dense masked
kernel, as the reference does.  Ray tiles and beam chunks are 256 wide on
every device: the reference's own off-TPU branch (``_pallas_tile``,
beam_gather.py:74-75), so the pick matches it.

Grid-density media take the heterogeneous layouts: per segment, the
polynomial tables of ``medium_interval_poly`` (K = 8 quadrature nodes of the
trilinear density, fitted by fixed least-squares maps), once per camera
pass for the beams (packed beside them) and per sweep for the camera
segments.

The gradient is the reference's custom VJP (``_packed_bwd``): geometry is
detached where the reference stop-gradients it, and ``_GatherCorePacked``
returns the analytic cotangents of the backward kernels of
``ops/gather_bwd.py`` for the beam powers and radii, the camera
transmittance, sigma_s and g, and in grid media the tables' coefficients
(and through them the density grid and sigma_t), on the CPU and on the card
alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import transform as tfm
from ..core.math import length
from ..media import gather_medium, grid_density
from ..ops.gather import (BF_B0, BF_B1, BF_RAD, BF_VALID, NB, POLY_D_COEFS,
                          POLY_DENS_COEFS, RF_DC, RF_DENSC, RF_G, RF_SIGS,
                          RF_SIGTC, RF_TR, gather_forward, gather_sparse,
                          is_hetero, pack_rays, sparse_block_ids)
from ..ops.gather_bwd import (DR_DC, DR_DENS, DR_G, DR_SIGS, DR_SIGTC, DR_TR,
                              NDR, gather_backward_fused,
                              gather_backward_sparse,
                              sparse_block_ids_chunk_major)
from ..scene.scene import Media
from .lbvh import morton3

TILE = 256  # camera segments per ray tile
CHUNK = 256  # beams per packed chunk

HETERO_NODES = 8  # quadrature nodes per segment in grid media
POLY_D_DEG = 5  # D(f) = c1 f + ... + c5 f^5
POLY_DENS_DEG = 5  # dens(f) = e0 + e1 f + ... + e5 f^5


def medium_interval_nodes(media: Media, med_idx, p0, p1, K: int = HETERO_NODES):
    """Factored per-segment node tables (beam_gather.py:196-236) for
    segments p0 -> p1 (N, 3): ``(dk, dens, sigma_t)``, dk (N, K) the
    density times len/K at K midpoints (0 outside media), dens (N, K) the
    trilinear density (1 for homogeneous media and outside), sigma_t (N, 3)
    the segment medium's constant extinction (not masked: dk = 0 zeroes
    both tau and its sigma_t cotangent outside media)."""
    sigma_a, sigma_s, _, is_grid, in_med = gather_medium(media, med_idx)
    sigma_t = sigma_a + sigma_s
    seg_len = length(p1 - p0)
    fr = (torch.arange(K, dtype=torch.float32, device=p0.device) + 0.5) / K
    pts = p0[:, None, :] + fr[None, :, None] * (p1 - p0)[:, None, :]
    one = torch.ones((), dtype=torch.float32, device=p0.device)
    if media.density.numel() > 1:
        # grid_density samples medium space [0,1]^3 (grid.cpp:46-60)
        dens = grid_density(media.density,
                            tfm.apply_point(media.world_to_medium, pts))
        dens = torch.where(is_grid[:, None], dens, one)
    else:
        dens = torch.ones(seg_len.shape + (K,), dtype=torch.float32,
                          device=p0.device)
    dk = torch.where(in_med[:, None], dens * (seg_len / K)[:, None],
                     torch.zeros((), dtype=torch.float32, device=p0.device))
    dens = torch.where(in_med[:, None], dens, one)
    return dk, dens, sigma_t


@functools.lru_cache(maxsize=None)
def _fit_matrices(K: int):
    """Least-squares maps from K nodes to the polynomial coefficients
    (beam_gather.py:270-282), numpy float32 constants: D from the clamp
    basis of the cumulative sum, dens from the hat basis of the node
    interpolation, both sampled at 129 fractions."""
    fs = np.linspace(0.0, 1.0, 129)
    clamp_basis = np.clip(fs[:, None] * K - np.arange(K)[None, :], 0, 1)
    xq = np.clip(fs * K, 0.5, K - 0.5) - 0.5
    hat_basis = np.clip(1.0 - np.abs(xq[:, None] - np.arange(K)[None, :]), 0, 1)
    VD = np.stack([fs ** i for i in range(1, POLY_D_DEG + 1)], -1)
    VN = np.stack([fs ** i for i in range(0, POLY_DENS_DEG + 1)], -1)
    MD = np.linalg.lstsq(VD, clamp_basis, rcond=None)[0]  # (5, K)
    MN = np.linalg.lstsq(VN, hat_basis, rcond=None)[0]  # (6, K)
    return MD.astype(np.float32), MN.astype(np.float32)


def nodes_to_poly(dk, dens):
    """(N, K) node tables -> (d_poly (N, 5), dens_poly (N, 6)): the fixed
    linear fit maps, so autograd chains the coefficient cotangents back to
    the nodes and through them to the density grid.  Full float32 products
    (matmul TF32 is off by default on the card)."""
    MD, MN = (torch.from_numpy(m).to(dk.device)
              for m in _fit_matrices(dk.shape[-1]))
    return dk @ MD.T, dens @ MN.T


def medium_interval_poly(media: Media, med_idx, p0, p1, K: int = HETERO_NODES):
    """Per-segment polynomial tables: ``(d_poly (N, 5), dens_poly (N, 6),
    sigma_t (N, 3))`` with tau_ch(f) = sigma_t[ch] * D(f)."""
    dk, dens, sigma_t = medium_interval_nodes(media, med_idx, p0, p1, K)
    d_poly, dens_poly = nodes_to_poly(dk, dens)
    return d_poly, dens_poly, sigma_t


def pack_beams_compact(beams, d_poly=None, sigma_t=None):
    """Validity-compact and pack a Beams SoA into the (n_chunks, NB, CHUNK)
    field-major chunk layout.  Returns (beams_packed, n_valid f32 ()).
    ``d_poly`` (B, 5) and ``sigma_t`` (B, 3), a grid medium's per-beam
    tables (``medium_interval_poly``), append the NB_HET - NB extension
    fields, permuted and padded with the rest.

    Sort key: validity-major, Morton-minor, one stable argsort — valid beams
    first (the dead-chunk skip) and spatially local chunks (tight chunk
    AABBs for the block cull)."""
    dev = beams.start.device
    mid = (0.5 * (beams.start + beams.end)).detach()
    vcol = beams.valid[:, None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    mn = torch.where(vcol, mid, inf).amin(0)
    mx = torch.where(vcol, mid, -inf).amax(0)
    any_valid = beams.valid.any()
    mn = torch.where(any_valid, mn, torch.zeros_like(mn))
    mx = torch.where(any_valid, mx, torch.ones_like(mx))
    codes = morton3((mid - mn) / torch.clamp_min(mx - mn, 1e-12))  # < 2^30
    key = torch.where(beams.valid, codes, torch.full_like(codes, 1 << 30))
    order = torch.argsort(key, stable=True).detach()
    B = beams.capacity
    n_chunks = max(1, -(-B // CHUNK))
    Bp = n_chunks * CHUNK

    # validity folds into the beam powers (the kernels assume it)
    valid_f = beams.valid.to(torch.float32)
    ps = beams.power_start * valid_f[:, None]
    pe = beams.power_end * valid_f[:, None]
    zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
    cols = [
        beams.start[:, 0], beams.start[:, 1], beams.start[:, 2],
        beams.end[:, 0], beams.end[:, 1], beams.end[:, 2],
        ps[:, 0], ps[:, 1], ps[:, 2],
        pe[:, 0], pe[:, 1], pe[:, 2],
        beams.radius, valid_f, zeros, zeros,
    ]
    if d_poly is not None:  # grid-medium extension fields
        cols += [d_poly[:, k] for k in range(POLY_D_COEFS)]
        cols += [sigma_t[:, ch] for ch in range(3)]
    nb = len(cols)
    mat = torch.stack(cols, 0)[:, order]  # (nb, B), field-major
    if Bp != B:
        mat = torch.cat([mat, torch.zeros((nb, Bp - B), dtype=torch.float32,
                                          device=dev)], 1)
    packed = mat.reshape(nb, n_chunks, CHUNK).permute(1, 0, 2).contiguous()
    return packed, valid_f.sum()


def _block_overlap_mask(beams_packed, seg_a0, seg_a1, tile: int, cam_radius):
    """(n_chunks, n_tiles) f32 conservative cull mask: 1 where the chunk's
    radius-inflated AABB overlaps the tile's cam_radius-inflated segment
    AABB.  Disjoint boxes guarantee zero contribution, so the skip is exact;
    dead chunks get empty boxes and mask 0."""
    bp = beams_packed.detach()
    start = bp[:, BF_B0:BF_B0 + 3, :].transpose(1, 2)
    end = bp[:, BF_B1:BF_B1 + 3, :].transpose(1, 2)
    rad = bp[:, BF_RAD:BF_RAD + 1, :].transpose(1, 2)
    live = bp[:, BF_VALID:BF_VALID + 1, :].transpose(1, 2) > 0.0
    big = torch.tensor(3e37, dtype=torch.float32, device=bp.device)
    cmin = torch.where(live, torch.minimum(start, end) - rad, big).amin(1)
    cmax = torch.where(live, torch.maximum(start, end) + rad, -big).amax(1)

    n_tiles = seg_a0.shape[0] // tile
    a0 = seg_a0.detach().reshape(n_tiles, tile, 3)
    a1 = seg_a1.detach().reshape(n_tiles, tile, 3)
    r = torch.as_tensor(cam_radius, dtype=torch.float32, device=bp.device)
    tmin = torch.minimum(a0.amin(1), a1.amin(1)) - r
    tmax = torch.maximum(a0.amax(1), a1.amax(1)) + r
    hit = ((cmax[:, None, :] >= tmin[None, :, :])
           & (cmin[:, None, :] <= tmax[None, :, :])).all(-1)
    return hit.to(torch.float32)


def _packed_forward(beams_packed, rays_packed, scalars, block_mask,
                    sparse_cap: int):
    """Run the forward kernel for one packed sweep: the sparse live-block
    kernel when the live blocks fit ``sparse_cap`` (the reference's runtime
    pick; the live count is read on the host, one sync per sweep in this
    eager port), the dense masked kernel otherwise (both exact).  Returns
    ((n_tiles*T, 3), the tile-major block ids of the sparse pick or None)."""
    idx = None
    if sparse_cap > 0 and int((block_mask > 0).sum()) <= sparse_cap:
        idx, _ = sparse_block_ids(block_mask, sparse_cap)
        out = gather_sparse(rays_packed, beams_packed, scalars, idx)
    else:
        out = gather_forward(rays_packed, beams_packed, scalars, block_mask)
    n_tiles, tile = rays_packed.shape[0], rays_packed.shape[2]
    return out[:, :3, :].transpose(1, 2).reshape(n_tiles * tile, 3), idx


def pack_ct(ct, n_tiles: int):
    """(n_tiles*T, 3) output cotangent -> the kernels' (n_tiles, 8, T)
    layout, RGB in rows 0-2 (beam_gather.py:1139-1141)."""
    return torch.cat(
        [ct.reshape(n_tiles, TILE, 3).transpose(1, 2),
         torch.zeros((n_tiles, NDR - 3, TILE), dtype=torch.float32,
                     device=ct.device)], 1).contiguous()


def _packed_backward(beams_packed, rays_packed, scalars, block_mask, ct,
                     idx_t, grad_extras: bool):
    """The reference's ``_packed_bwd`` (beam_gather.py:1121-1208): (n_tiles*T,
    3) output cotangent -> (d_beams, d_rays) in the packed layouts.  Takes
    the forward's pick: the sparse kernels over its tile-major ids ``idx_t``
    and chunk-major ids of the same cap, the dense kernels where ``idx_t``
    is None.  Grid media always take the dense kernels with the block mask
    (the reference has no sparse heterogeneous backward, :1147; the
    skipped blocks hold no in-range pair, so the result is the same).  The
    geometry rows get zero cotangents, and in grid media the tr_full rows
    too (the transmittance rides the tables)."""
    ct_packed = pack_ct(ct, rays_packed.shape[0])
    hetero = is_hetero(rays_packed)
    if idx_t is not None and not hetero:
        cap = idx_t.shape[0] - rays_packed.shape[0]
        idx_c, _ = sparse_block_ids_chunk_major(block_mask, cap)
        d_rays8, d_beams = gather_backward_sparse(
            rays_packed, beams_packed, scalars, ct_packed, idx_t, idx_c,
            want_extras=grad_extras)
    else:
        d_rays8, d_beams = gather_backward_fused(
            rays_packed, beams_packed, scalars, ct_packed, block_mask,
            want_extras=grad_extras)
    d_rays = torch.zeros_like(rays_packed)
    d_rays[:, RF_SIGS:RF_SIGS + 3] = d_rays8[:, DR_SIGS:DR_SIGS + 3]
    d_rays[:, RF_G] = d_rays8[:, DR_G]
    if hetero:
        d_rays[:, RF_DC:RF_DC + POLY_D_COEFS] = \
            d_rays8[:, DR_DC:DR_DC + POLY_D_COEFS]
        d_rays[:, RF_SIGTC:RF_SIGTC + 3] = d_rays8[:, DR_SIGTC:DR_SIGTC + 3]
        d_rays[:, RF_DENSC:RF_DENSC + POLY_DENS_COEFS] = \
            d_rays8[:, DR_DENS:DR_DENS + POLY_DENS_COEFS]
    else:
        d_rays[:, RF_TR:RF_TR + 3] = d_rays8[:, DR_TR:DR_TR + 3]
    return d_beams, d_rays


class _GatherCorePacked(torch.autograd.Function):
    """The packed gather with the reference's custom VJP
    (``_gather_core_packed``, beam_gather.py:1036-1211): the forward
    launches the forward kernels, the backward the backward kernels, on
    the CPU through their plain versions.  The cam_radius cotangent
    (``DR_CAMR``) is not returned: the progressive radius is a schedule,
    not a parameter, so scalars and mask get None."""

    @staticmethod
    def forward(ctx, beams_packed, rays_packed, scalars, block_mask,
                sparse_cap, grad_extras):
        out, idx_t = _packed_forward(beams_packed, rays_packed, scalars,
                                     block_mask, sparse_cap)
        ctx.save_for_backward(beams_packed, rays_packed, scalars, block_mask,
                              idx_t)
        ctx.grad_extras = grad_extras
        return out

    @staticmethod
    def backward(ctx, ct):
        beams_packed, rays_packed, scalars, block_mask, idx_t = \
            ctx.saved_tensors
        d_beams, d_rays = _packed_backward(
            beams_packed, rays_packed, scalars, block_mask, ct, idx_t,
            ctx.grad_extras)
        return d_beams, d_rays, None, None, None, None


def gather_beams_packed(beams_packed, n_valid, media: Media, seg_a0, seg_a1,
                        seg_dir, seg_medium, seg_tr_full, cam_radius,
                        power_scale: float = 1.0, min_sin_theta: float = 0.05,
                        grad_extras: bool = True,
                        sparse_cap: int = 0) -> torch.Tensor:
    """Packed-mode gather (normalized BRE, geometry detached) over
    ``pack_beams_compact``'s chunks: per-ray medium factors are gathered
    here (and, for beams packed with grid tables, the camera segments'
    tables, geometry detached, medium parameters attached), rays are padded
    to a tile multiple and packed, and ``sparse_cap > 0`` enables the
    sparse-block kernels.  ``grad_extras`` False skips the radius and HG g
    cotangents.  Returns (R, 3)."""
    R = seg_a0.shape[0]
    dev = seg_a0.device
    _, sigma_s_seg, g_seg, _, seg_in_med = gather_medium(media, seg_medium)
    in_med_f = seg_in_med.to(torch.float32)
    seg = dict(
        a0=seg_a0.detach(), a1=seg_a1.detach(), dir=seg_dir.detach(),
        len=torch.clamp_min(length(seg_a1 - seg_a0), 1e-30).detach(),
        tr_full=seg_tr_full,
        # power_scale * in_med folds into sigma_s (kernel assumption)
        sigma_s=sigma_s_seg * (power_scale * in_med_f)[:, None],
        g=g_seg, in_med_f=in_med_f,
    )
    if beams_packed.shape[1] > NB:  # grid media: the camera-side tables
        dp_c, dens_c, sigt_c = medium_interval_poly(
            media, seg_medium, seg_a0.detach(), seg_a1.detach())
        seg.update(d_cam_poly=dp_c, sigma_t_cam=sigt_c, dens_cam_poly=dens_c)
    R_pad = -(-R // TILE) * TILE
    if R_pad != R:
        seg = {k: torch.cat([v, torch.zeros((R_pad - R,) + v.shape[1:],
                                            dtype=v.dtype, device=dev)], 0)
               for k, v in seg.items()}
    rays_packed = pack_rays(seg, TILE)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    scalars = torch.stack([f32(cam_radius), f32(power_scale),
                           f32(min_sin_theta), f32(n_valid)]).reshape(1, 4)
    mask = _block_overlap_mask(beams_packed, seg["a0"], seg["a1"], TILE,
                               cam_radius)
    return _GatherCorePacked.apply(beams_packed, rays_packed, scalars, mask,
                                   sparse_cap, grad_extras)[:R]
