"""Beam radiance gather, packed forward path (counterpart of
``bre_tpu/accel/beam_gather.py:893-1033, 1214-1318``).

The beam buffer is validity-compacted and Morton-sorted once per camera pass
(``pack_beams_compact``); each depth step packs its camera segments, builds
the exact chunk x tile AABB cull mask (``_block_overlap_mask``) and runs the
forward kernels of ``ops/gather.py``, picking at run time between the
sparse live-block kernel (live blocks within ``sparse_cap``) and the dense
masked kernel, as the reference does.  Ray tiles and beam chunks are 256
wide on every device: the reference's own off-TPU branch
(``_pallas_tile``, beam_gather.py:74-75), so the pick matches it.

Forward only: geometry is detached where the reference stop-gradients it;
the backward kernels are ROADMAP Queue 2 items 3-4.
"""

from __future__ import annotations

import torch

from ..core.math import length
from ..media import gather_medium
from ..ops.gather import (BF_B0, BF_B1, BF_RAD, BF_VALID, NB, gather_forward,
                          gather_sparse, pack_rays, sparse_block_ids)
from ..scene.scene import Media
from .lbvh import morton3

TILE = 256  # camera segments per ray tile
CHUNK = 256  # beams per packed chunk


def pack_beams_compact(beams):
    """Validity-compact and pack a Beams SoA into the (n_chunks, NB, CHUNK)
    field-major chunk layout.  Returns (beams_packed, n_valid f32 ()).

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
    mat = torch.stack(cols, 0)[:, order]  # (NB, B), field-major
    if Bp != B:
        mat = torch.cat([mat, torch.zeros((NB, Bp - B), dtype=torch.float32,
                                          device=dev)], 1)
    packed = mat.reshape(NB, n_chunks, CHUNK).permute(1, 0, 2).contiguous()
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
    kernel when the live count fits ``sparse_cap``, the dense masked kernel
    otherwise (both exact).  Returns (n_tiles*T, 3).  The live count is
    read on the host: one sync per sweep in this eager slice."""
    out = None
    if sparse_cap > 0:
        n_live = int((block_mask > 0).sum())
        if n_live <= sparse_cap:
            idx, _ = sparse_block_ids(block_mask, sparse_cap)
            out = gather_sparse(rays_packed, beams_packed, scalars, idx)
    if out is None:
        out = gather_forward(rays_packed, beams_packed, scalars, block_mask)
    n_tiles, tile = rays_packed.shape[0], rays_packed.shape[2]
    return out[:, :3, :].transpose(1, 2).reshape(n_tiles * tile, 3)


def gather_beams_packed(beams_packed, n_valid, media: Media, seg_a0, seg_a1,
                        seg_dir, seg_medium, seg_tr_full, cam_radius,
                        power_scale: float = 1.0, min_sin_theta: float = 0.05,
                        sparse_cap: int = 0) -> torch.Tensor:
    """Packed-mode gather (normalized BRE, geometry detached) over
    ``pack_beams_compact``'s chunks: per-ray medium factors are gathered
    here, rays are padded to a tile multiple and packed, and
    ``sparse_cap > 0`` enables the sparse-block kernel.  Returns (R, 3)."""
    R = seg_a0.shape[0]
    dev = seg_a0.device
    _, sigma_s_seg, g_seg, seg_in_med = gather_medium(media, seg_medium)
    in_med_f = seg_in_med.to(torch.float32)
    seg = dict(
        a0=seg_a0.detach(), a1=seg_a1.detach(), dir=seg_dir.detach(),
        len=torch.clamp_min(length(seg_a1 - seg_a0), 1e-30).detach(),
        tr_full=seg_tr_full,
        # power_scale * in_med folds into sigma_s (kernel assumption)
        sigma_s=sigma_s_seg * (power_scale * in_med_f)[:, None],
        g=g_seg, in_med_f=in_med_f,
    )
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
    return _packed_forward(beams_packed, rays_packed, scalars, mask,
                           sparse_cap)[:R]
