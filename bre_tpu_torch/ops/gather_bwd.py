"""Packed beam-radiance gather, backward: plain PyTorch versions and the
CUDA kernel wrappers (counterpart of ``bre_tpu/ops/pallas_gather_bwd.py``).

With the gather geometry held fixed (``grad_geometry=False``), the
cotangents of the forward's per-segment sums are analytic in the pair
quantities: per ray d tr, d sigma_s, d g and d cam_radius, per beam d ps,
d pe and d radius (``_bwd_fused_body``, pallas_gather_bwd.py:182-238).  The
pair geometry is recomputed, never stored.

Layouts are the forward's (``ops/gather.py``) plus:
- ct ``(n_tiles, 8, T)``: the output cotangent, RGB in rows 0-2;
- d_rays ``(n_tiles, 8, T)``: rows ``DR_*``;
- d_beams ``(n_chunks, NB, C)``: d ps in rows BF_PS.., d pe in BF_PE..,
  d radius in BF_RAD, zeros in the geometry and padding rows.
Heterogeneous layouts (``_bwd_fused_body_het``, pallas_gather_bwd.py:241):
d_rays ``(n_tiles, NDR_HET, T)`` adds the camera tables' coefficient
cotangents (``DR_DC``, ``DR_SIGTC``, ``DR_DENS``) and leaves the DR_TR rows
0; d_beams ``(n_chunks, NB_HET, C)`` holds d ps, d radius and the beam
tables' cotangents (``BF_DP``, ``BF_SIGT``), zeros in the pe, geometry
and padding rows.  The coefficient cotangents are gated by the clamps at 0
of D and dens.

``gather_backward_fused`` (dense, block mask), ``gather_backward_sparse``
(compacted live blocks, tile-major for d_rays and chunk-major for d_beams)
and ``gather_backward_twopass`` (the reference's historical two-pass
``pallas_gather_backward``: every block, no mask, no dead-chunk skip, the
extras always on) take their plain versions only for CPU tensors; for CUDA
tensors they launch the kernels of ``csrc/beam_gather_bwd.cu`` or raise.
The dense wrapper picks the heterogeneous instance for NF_HET rays; the
sparse and two-pass backward are homogeneous only, as in the reference,
which takes the dense one for grid media (beam_gather.py:1147).  Each
wrapper counts its launches per instance in ``<wrapper>.launches`` and
``<wrapper>.launches_het``, and keeps the grid of its last launch in
``<wrapper>.last_grid``: (ray tiles, splits per tile, d_beams blocks).
"""

from __future__ import annotations

import torch

from .gather import (BF_DP, BF_PE, BF_PS, BF_RAD, BF_SIGT, KERNEL_CHUNK,
                     KERNEL_TILE, NB, NB_HET, POLY_D_COEFS, POLY_DENS_COEFS,
                     RF_SIGS, RF_SIGTC, RF_TR, _check_cuda, _check_packed,
                     _live_chunks, _REF_BATCH_PAIRS_CARD,
                     _REF_BATCH_PAIRS_CPU, beam_power_ref, block_col,
                     block_row, count_launch, hetero_decay_ref,
                     hetero_tables_ref, is_hetero, pair_geometry_ref,
                     run_starts, split_bounds, split_count,
                     split_run_starts, staged_beams_buffer)

# per-ray cotangent rows of d_rays (pallas_gather_bwd.py:59-70)
DR_TR = 0  # d tr_full rgb rows 0..2
DR_SIGS = 3  # d sigma_s rgb rows 3..5
DR_G = 6
DR_CAMR = 7  # per-ray partial of d cam_radius
NDR = 8
DR_DC = 8  # 5 rows: d d_cam_poly (heterogeneous)
DR_SIGTC = DR_DC + POLY_D_COEFS  # 3 rows: d sigma_t_cam
DR_DENS = DR_SIGTC + 3  # 6 rows: d dens_cam_poly
NDR_HET = DR_DENS + POLY_DENS_COEFS  # 22

# each cotangent's rows in d_rays and in d_beams; the other rows of d_beams
# (geometry, validity, padding) are zero
D_RAYS_ROWS = dict(tr=slice(DR_TR, DR_TR + 3),
                   sigma_s=slice(DR_SIGS, DR_SIGS + 3),
                   g=slice(DR_G, DR_G + 1),
                   cam_radius=slice(DR_CAMR, DR_CAMR + 1))
D_BEAMS_ROWS = dict(power_start=slice(BF_PS, BF_PS + 3),
                    power_end=slice(BF_PE, BF_PE + 3),
                    radius=slice(BF_RAD, BF_RAD + 1))
# the heterogeneous instance's cotangents; its DR_TR rows and the other
# rows of d_beams (power_end among them) are zero
D_RAYS_ROWS_HET = dict(sigma_s=slice(DR_SIGS, DR_SIGS + 3),
                       g=slice(DR_G, DR_G + 1),
                       cam_radius=slice(DR_CAMR, DR_CAMR + 1),
                       d_cam_poly=slice(DR_DC, DR_DC + POLY_D_COEFS),
                       sigma_t_cam=slice(DR_SIGTC, DR_SIGTC + 3),
                       dens_cam_poly=slice(DR_DENS, DR_DENS + POLY_DENS_COEFS))
D_BEAMS_ROWS_HET = dict(power_start=slice(BF_PS, BF_PS + 3),
                        radius=slice(BF_RAD, BF_RAD + 1),
                        d_poly=slice(BF_DP, BF_DP + POLY_D_COEFS),
                        sigma_t=slice(BF_SIGT, BF_SIGT + 3))

_INV_4PI = 0.07957747154594767


def sparse_block_ids_chunk_major(block_mask: torch.Tensor, cap: int):
    """Chunk-major companion of ``sparse_block_ids``
    (pallas_gather_bwd.py:592-604): live blocks are ``chunk*(n_tiles+1) +
    tile+1``, each chunk's seed entry is ``chunk*(n_tiles+1)``, fill entries
    are ``n_chunks*(n_tiles+1)``.  Returns (idx (n_chunks + cap,) int32,
    n_live () int64)."""
    n_chunks, n_tiles = block_mask.shape
    ext = torch.cat([torch.ones((n_chunks, 1), dtype=block_mask.dtype,
                                device=block_mask.device), block_mask], 1)
    nz = torch.nonzero(ext.reshape(-1) != 0).reshape(-1)[: n_chunks + cap]
    idx = torch.full((n_chunks + cap,), n_chunks * (n_tiles + 1),
                     dtype=torch.int32, device=block_mask.device)
    idx[: nz.shape[0]] = nz.to(torch.int32)
    return idx, (block_mask > 0).sum()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _pair_terms_ref(q, want_extras):
    """The pair terms of ``_pair_quantities`` (pallas_gather_bwd.py:
    115-149): base = in_range / sin(theta), the HG phase rho, the kernel k1
    and, with the extras, drho/dg and dk1/dwidth (None without)."""
    gg, rs, cos_t = q["g"], q["rs"], q["cos_theta"]
    r2, inv_width = q["r2"], q["inv_width"]
    rs3 = rs * rs * rs
    rho = _INV_4PI * (1.0 - gg * gg) * rs3
    k1 = 0.75 * (1.0 - r2) * inv_width
    base = q["in_range"] * q["inv_sin"]
    if not want_extras:
        return base, rho, k1, None, None
    drho_dg = _INV_4PI * ((-2.0 * gg) * rs3 + (1.0 - gg * gg) * (-1.5)
                          * (rs3 * rs * rs) * (2.0 * gg + 2.0 * cos_t))
    dk1_dw = 0.75 * (inv_width * inv_width) * (3.0 * r2 - 1.0)
    return base, rho, k1, drho_dg, dk1_dw


def _pair_weights_ref(q, want_extras):
    """The pair weights: w0 = base rho k1 and, with the extras, wrad = base
    rho dk1/dwidth and wg = base k1 drho/dg (None without)."""
    base, rho, k1, drho_dg, dk1_dw = _pair_terms_ref(q, want_extras)
    w0 = base * rho * k1
    if not want_extras:
        return w0, None, None
    return w0, base * rho * dk1_dw, base * k1 * drho_dg


def _bwd_blocks_het_ref(rays_b, beams_b, ct_b, frac_b, frac_c, w0, wrad, wg,
                        want_extras, side):
    """The heterogeneous cotangents of ``_bwd_fused_body_het``
    (pallas_gather_bwd.py:241-345) on a batch of blocks; ``side`` as in
    ``_bwd_blocks_ref``.  tau's cotangent is -cA per channel; it chains into
    the factored tables (d sigma_t = -cA D, d D = -cA sigma_t, summed over
    channels before the clamp gate and the powers of f)."""
    dens, Db, Dc = hetero_tables_ref(rays_b, beams_b, frac_b, frac_c)
    dens_live = (dens > 0.0).to(torch.float32)
    db_live = (Db > 0.0).to(torch.float32)
    dc_live = (Dc > 0.0).to(torch.float32)
    dens = torch.clamp_min(dens, 0.0)
    Db, Dc = torch.clamp_min(Db, 0.0), torch.clamp_min(Dc, 0.0)
    zero_ray = torch.zeros_like(block_row(rays_b, 0)[:, 0])  # (nb, T)
    zero_beam = torch.zeros_like(block_col(beams_b, 0)[..., 0])  # (nb, C)
    d_g, d_camr, d_rad = zero_ray, zero_ray, zero_beam
    d_sig, d_sigtc, d_ps, d_sigtb = [], [], [], []
    m_D = torch.zeros_like(frac_b)  # sum_ch cA * sigma_t (this side's)
    cw_sum = torch.zeros_like(frac_b)  # sum_ch ct w0 sigma_s pt
    for ch in range(3):
        ct = ct_b[:, ch:ch + 1, :]  # (nb, 1, T)
        sig = block_row(rays_b, RF_SIGS + ch)
        ps = block_col(beams_b, BF_PS + ch)
        decay = hetero_decay_ref(rays_b, beams_b, ch, Db, Dc)
        pt = ps * decay
        cB = ct * (w0 * sig * dens) * decay
        cA = cB * ps
        if side == "rays":
            d_sigtc.append((-cA * Dc).sum(1))
            m_D = m_D + cA * block_row(rays_b, RF_SIGTC + ch)
            d_sig.append((ct * (w0 * pt * dens).sum(1, keepdim=True))[:, 0])
            cw_sum = cw_sum + ct * (w0 * sig) * pt
            if want_extras:
                d_g = d_g + (ct * wg * pt * sig * dens).sum(1)
                d_camr = d_camr + (ct * wrad * pt * sig * dens).sum(1)
        else:
            d_ps.append(cB.sum(2))
            d_sigtb.append((-cA * Db).sum(2))
            m_D = m_D + cA * block_col(beams_b, BF_SIGT + ch)
            if want_extras:
                d_rad = d_rad + (ct * wrad * pt * sig * dens).sum(2)
    frac, axis = (frac_c, 1) if side == "rays" else (frac_b, 2)
    m_D = -m_D * (dc_live if side == "rays" else db_live)
    d_poly, f_pow = [], frac
    for _ in range(POLY_D_COEFS):  # d c_i = dL/dD * f^(i+1)
        d_poly.append((m_D * f_pow).sum(axis))
        f_pow = f_pow * frac
    if side == "beams":
        cols = ([zero_beam] * BF_PS + d_ps + [zero_beam] * 3 + [d_rad]
                + [zero_beam] * (BF_DP - BF_RAD - 1) + d_poly + d_sigtb)
        return torch.stack(cols, 1)
    cw_m = cw_sum * dens_live
    d_dens, f_pow = [], torch.ones_like(frac_c)
    for _ in range(POLY_DENS_COEFS):  # d e_i = dL/d dens * f^i
        d_dens.append((cw_m * f_pow).sum(1))
        f_pow = f_pow * frac_c
    return torch.stack([zero_ray] * 3 + d_sig + [d_g, d_camr] + d_poly
                       + d_sigtc + d_dens, 1)


def _bwd_blocks_ref(rays_b, beams_b, ct_b, cam_radius, min_sin, want_extras,
                    side):
    """The analytic cotangents of ``_bwd_fused_body`` on a batch of blocks.
    ``side == "rays"`` returns the per-block (nb, 8, T) d_rays rows (sums
    over each block's beams); ``side == "beams"`` the per-block (nb, NB, C)
    d_beams fields (sums over each block's rays).  Each sum over a block is
    taken before the division by ps_s, pe_s or tr, as in the reference; the
    gates at the clamps are the reference's, not autograd's."""
    q = pair_geometry_ref(rays_b, beams_b, cam_radius, min_sin)
    w0, wrad, wg = _pair_weights_ref(q, want_extras)
    frac_b, frac_c = q["t_cl"], q["s"]  # beam and camera fractions
    if is_hetero(rays_b):
        return _bwd_blocks_het_ref(rays_b, beams_b, ct_b, frac_b, frac_c, w0,
                                   wrad, wg, want_extras, side)

    zero_ray = torch.zeros_like(block_row(rays_b, 0)[:, 0])  # (nb, T)
    zero_beam = torch.zeros_like(block_col(beams_b, 0)[..., 0])  # (nb, C)
    d_g, d_camr, d_rad = zero_ray, zero_ray, zero_beam
    d_tr, d_sig, d_ps, d_pe = [], [], [], []
    for ch in range(3):
        ct = ct_b[:, ch:ch + 1, :]  # (nb, 1, T)
        sig = block_row(rays_b, RF_SIGS + ch)
        pt, ps_s, pe_s = beam_power_ref(rays_b, beams_b, ch, frac_b, frac_c)
        coef = ct * sig
        A = w0 * pt
        if side == "rays":
            trf_raw = block_row(rays_b, RF_TR + ch)
            trf = torch.clamp_min(trf_raw, 1e-30)
            trf_live = (trf_raw > 1e-30).to(torch.float32)
            d_sig.append((ct * A.sum(1, keepdim=True))[:, 0])
            d_tr.append((ct * sig * (A * frac_c).sum(1, keepdim=True) / trf
                         * trf_live)[:, 0])
            if want_extras:
                d_g = d_g + (coef * wg * pt).sum(1)
                d_camr = d_camr + (coef * wrad * pt).sum(1)
        else:
            cA = coef * A
            pe = block_col(beams_b, BF_PE + ch)
            pe_live = (pe > 1e-12 * ps_s).to(torch.float32)
            d_ps.append(((cA * (1.0 - frac_b)).sum(2, keepdim=True)
                         / ps_s)[..., 0])
            d_pe.append(((cA * frac_b * pe_live).sum(2, keepdim=True)
                         / pe_s)[..., 0])
            if want_extras:
                d_rad = d_rad + (coef * wrad * pt).sum(2)
    if side == "rays":
        return torch.stack(d_tr + d_sig + [d_g, d_camr], 1)
    cols = [zero_beam] * BF_PS + d_ps + d_pe + [d_rad]
    cols += [zero_beam] * (NB - len(cols))
    return torch.stack(cols, 1)


def _interp_terms_ref(ps, pe, frac):
    """p_at and its partials in ps and pe (``_interp_terms``,
    pallas_gather_bwd.py:152-162), zero where the start power is dead."""
    ok = ps > 1e-20
    one, zero = torch.ones_like(ps), torch.zeros_like(ps)
    ps_s = torch.where(ok, ps, one)
    pe_s = torch.where(ok, torch.maximum(pe, 1e-12 * ps_s), one)
    p_at = torch.where(ok, ps_s * torch.exp(frac * torch.log(pe_s / ps_s)),
                       zero)
    dp_dps = torch.where(ok, p_at * (1.0 - frac) / ps_s, zero)
    pe_live = (pe > 1e-12 * ps_s).to(torch.float32)
    dp_dpe = torch.where(ok, p_at * frac / pe_s, zero) * pe_live
    return p_at, dp_dps, dp_dpe


def _twopass_blocks_ref(rays_b, beams_b, ct_b, cam_radius, min_sin,
                        want_extras, side):
    """The cotangents of the two-pass backward on a batch of blocks:
    ``_bwd_rays_kernel`` (pallas_gather_bwd.py:708-738) for ``side ==
    "rays"``, ``_bwd_beams_kernel`` (:741-772) for ``side == "beams"``, in
    their operation order.  Unlike the fused body, p_at and tr_cam are two
    exps, the per-beam partials divide per pair, and the extras are always
    on (``want_extras`` is not read)."""
    q = pair_geometry_ref(rays_b, beams_b, cam_radius, min_sin)
    base, rho, k1, drho_dg, dk1_dw = _pair_terms_ref(q, True)
    w0 = base * rho * k1
    frac_b, frac_c = q["t_cl"], q["s"]
    zero_beam = torch.zeros_like(block_col(beams_b, 0)[..., 0])  # (nb, C)
    d_tr, d_sig, d_ps, d_pe = [], [], [], []
    d_g = d_camr = torch.zeros_like(frac_b)
    d_rad = zero_beam
    for ch in range(3):
        ct = ct_b[:, ch:ch + 1, :]  # (nb, 1, T)
        sig = block_row(rays_b, RF_SIGS + ch)
        trf_raw = block_row(rays_b, RF_TR + ch)
        trf = torch.clamp_min(trf_raw, 1e-30)
        tr_cam = torch.exp(frac_c * torch.log(trf))
        p_at, dp_dps, dp_dpe = _interp_terms_ref(
            block_col(beams_b, BF_PS + ch), block_col(beams_b, BF_PE + ch),
            frac_b)
        if side == "rays":
            trf_live = (trf_raw > 1e-30).to(torch.float32)
            A = w0 * p_at * tr_cam
            d_sig.append((ct * A.sum(1, keepdim=True))[:, 0])
            dtr = (w0 * p_at * tr_cam * frac_c).sum(1, keepdim=True) / trf
            d_tr.append((ct * sig * dtr * trf_live)[:, 0])
            d_g = d_g + ct * sig * (base * k1 * drho_dg) * p_at * tr_cam
            d_camr = d_camr + ct * sig * (base * rho * dk1_dw) * p_at * tr_cam
        else:
            coef = ct * sig * w0 * tr_cam
            d_ps.append((coef * dp_dps).sum(2))
            d_pe.append((coef * dp_dpe).sum(2))
            d_rad = d_rad + (ct * sig * base * rho * dk1_dw * p_at
                             * tr_cam).sum(2)
    if side == "rays":
        return torch.stack(d_tr + d_sig + [d_g.sum(1), d_camr.sum(1)], 1)
    cols = [zero_beam] * BF_PS + d_ps + d_pe + [d_rad]
    cols += [zero_beam] * (NB - len(cols))
    return torch.stack(cols, 1)


def _bwd_ref(rays_packed, beams_packed, scalars, ct, tiles, chunks,
             want_extras, side, blocks_ref=_bwd_blocks_ref):
    """Accumulate the listed (tile, chunk) blocks, in list order, into d_rays
    (``side == "rays"``) or d_beams (``side == "beams"``), each batch of
    blocks through ``blocks_ref``."""
    n_tiles, _, T = rays_packed.shape
    n_chunks, nb_fields, C = beams_packed.shape
    cam_radius, min_sin = scalars[0, 0], scalars[0, 2]
    dev = rays_packed.device
    if side == "rays":
        ndr = NDR_HET if is_hetero(rays_packed) else NDR
        out = torch.zeros((n_tiles, ndr, T), dtype=torch.float32, device=dev)
        dst = tiles
    else:
        out = torch.zeros((n_chunks, nb_fields, C), dtype=torch.float32,
                          device=dev)
        dst = chunks
    pairs = _REF_BATCH_PAIRS_CPU if dev.type == "cpu" else _REF_BATCH_PAIRS_CARD
    nb = max(1, pairs // (T * C))
    for lo in range(0, tiles.shape[0], nb):
        ti, ch = tiles[lo:lo + nb], chunks[lo:lo + nb]
        upd = blocks_ref(rays_packed[ti], beams_packed[ch], ct[ti],
                         cam_radius, min_sin, want_extras, side)
        out.index_add_(0, dst[lo:lo + nb], upd)
    return out


def gather_backward_fused_ref(rays_packed, beams_packed, scalars, ct,
                              block_mask=None, want_extras=True):
    """Plain version of the dense backward: every block with
    ``block_mask[j, i] > 0`` whose chunk lies before ``n_valid``; d_rays
    sums tile-major, d_beams chunk-major.  Returns (d_rays, d_beams)."""
    n_tiles = rays_packed.shape[0]
    n_chunks, _, C = beams_packed.shape
    live = _live_chunks(n_chunks, C, scalars[0, 3], rays_packed.device)
    live = live[:, None].expand(n_chunks, n_tiles)
    if block_mask is not None:
        live = live & (block_mask > 0)
    tiles, chunks = torch.nonzero(live.T, as_tuple=True)  # tile-major
    d_rays = _bwd_ref(rays_packed, beams_packed, scalars, ct, tiles, chunks,
                      want_extras, "rays")
    chunks, tiles = torch.nonzero(live, as_tuple=True)  # chunk-major
    d_beams = _bwd_ref(rays_packed, beams_packed, scalars, ct, tiles, chunks,
                       want_extras, "beams")
    return d_rays, d_beams


def gather_backward_sparse_ref(rays_packed, beams_packed, scalars, ct,
                               idx_tile_major, idx_chunk_major,
                               want_extras=True):
    """Plain version of the sparse backward: d_rays over the tile-major ids
    of ``sparse_block_ids``, d_beams over the chunk-major ids of
    ``sparse_block_ids_chunk_major``.  Returns (d_rays, d_beams)."""
    n_tiles = rays_packed.shape[0]
    n_chunks, _, C = beams_packed.shape
    live_c = _live_chunks(n_chunks, C, scalars[0, 3], rays_packed.device)

    def blocks(idx, n_outer, n_inner):
        idx = idx.to(torch.int64)
        outer, sub = idx // (n_inner + 1), idx % (n_inner + 1)
        keep = (outer < n_outer) & (sub > 0)
        return outer[keep], sub[keep] - 1

    tiles, chunks = blocks(idx_tile_major, n_tiles, n_chunks)
    keep = live_c[chunks]
    d_rays = _bwd_ref(rays_packed, beams_packed, scalars, ct, tiles[keep],
                      chunks[keep], want_extras, "rays")
    chunks, tiles = blocks(idx_chunk_major, n_chunks, n_tiles)
    keep = live_c[chunks]
    d_beams = _bwd_ref(rays_packed, beams_packed, scalars, ct, tiles[keep],
                       chunks[keep], want_extras, "beams")
    return d_rays, d_beams


def gather_backward_twopass_ref(rays_packed, beams_packed, scalars, ct):
    """Plain version of the two-pass dense backward: every block of the
    grid (no mask, no dead-chunk skip; ``n_valid`` is not read), the
    extras always on; d_rays sums tile-major, d_beams chunk-major.  Returns
    (d_rays (n_tiles, 8, T), d_beams (n_chunks, NB, C))."""
    _reject_hetero(rays_packed, "the two-pass backward",
                   "gather_backward_fused")
    n_tiles, n_chunks = rays_packed.shape[0], beams_packed.shape[0]
    grid = torch.ones((n_tiles, n_chunks), dtype=torch.bool,
                      device=rays_packed.device)
    tiles, chunks = torch.nonzero(grid, as_tuple=True)  # tile-major
    d_rays = _bwd_ref(rays_packed, beams_packed, scalars, ct, tiles, chunks,
                      True, "rays", _twopass_blocks_ref)
    chunks, tiles = torch.nonzero(grid.T, as_tuple=True)  # chunk-major
    d_beams = _bwd_ref(rays_packed, beams_packed, scalars, ct, tiles, chunks,
                       True, "beams", _twopass_blocks_ref)
    return d_rays, d_beams


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _reject_hetero(rays_packed, what, instead):
    if is_hetero(rays_packed):
        raise ValueError(
            f"{what} is homogeneous only, as the reference's "
            f"(beam_gather.py:629-631, 1147); grid media take {instead}")


def _check_ct(ct, n_tiles, device):
    _check_cuda("ct", ct, torch.float32, (n_tiles, NDR, KERNEL_TILE))
    if ct.device != device:
        raise ValueError("gather inputs must share one device")


def _outputs(rays_packed, n_tiles, n_chunks, hetero):
    dev = rays_packed.device
    return (torch.empty((n_tiles, NDR_HET if hetero else NDR, KERNEL_TILE),
                        dtype=torch.float32, device=dev),
            torch.empty((n_chunks, NB_HET if hetero else NB, KERNEL_CHUNK),
                        dtype=torch.float32, device=dev))


def _partial(rays_packed, n_splits, n_tiles, hetero):
    """The d_rays sweep's per-split partial cotangents, (n_splits, n_tiles,
    8|NDR_HET, T)."""
    return torch.empty((n_splits, n_tiles, NDR_HET if hetero else NDR,
                        KERNEL_TILE), dtype=torch.float32,
                       device=rays_packed.device)


def gather_backward_fused(rays_packed, beams_packed, scalars, ct,
                          block_mask=None, want_extras=True):
    """Dense backward (replaces ``pallas_gather_backward_fused``): returns
    (d_rays (n_tiles, 8|NDR_HET, T), d_beams (n_chunks, NB|NB_HET, C)).
    CPU tensors take ``gather_backward_fused_ref``; CUDA tensors launch the
    two sweeps of ``csrc/beam_gather_bwd.cu`` (d_rays over ``split_count``
    blocks per ray tile and ``reduce_splits``, d_beams chunk by chunk)
    after the beam pre-pass, the heterogeneous instances for NF_HET rays."""
    n_tiles, n_chunks = rays_packed.shape[0], beams_packed.shape[0]
    if block_mask is None:
        block_mask = torch.ones((n_chunks, n_tiles), dtype=torch.float32,
                                device=rays_packed.device)
    if rays_packed.device.type == "cpu":
        return gather_backward_fused_ref(rays_packed, beams_packed, scalars,
                                         ct, block_mask, want_extras)
    from .cuda_build import check_status, load_library

    _, _, hetero = _check_packed(rays_packed, beams_packed, scalars)
    _check_cuda("block_mask", block_mask, torch.float32, (n_chunks, n_tiles))
    _check_ct(ct, n_tiles, rays_packed.device)
    lib = load_library()
    n_splits = split_count(n_tiles, n_chunks)
    d_rays, d_beams = _outputs(rays_packed, n_tiles, n_chunks, hetero)
    staged_beams = staged_beams_buffer(rays_packed, n_chunks, hetero)
    partial = _partial(rays_packed, n_splits, n_tiles, hetero)
    stream = torch.cuda.current_stream(rays_packed.device).cuda_stream
    err = lib.bre_gather_backward(
        rays_packed.data_ptr(), beams_packed.data_ptr(), scalars.data_ptr(),
        block_mask.data_ptr(), ct.data_ptr(), staged_beams.data_ptr(),
        partial.data_ptr(), d_rays.data_ptr(), d_beams.data_ptr(), n_tiles,
        n_chunks, n_splits, int(bool(want_extras)), int(hetero), stream)
    check_status(lib, err, "gather_backward kernels")
    count_launch(gather_backward_fused, (n_tiles, n_splits, n_chunks), hetero)
    return d_rays, d_beams


def gather_backward_sparse(rays_packed, beams_packed, scalars, ct,
                           idx_tile_major, idx_chunk_major, want_extras=True):
    """Sparse live-block backward (replaces ``pallas_gather_backward_sparse``)
    over ``sparse_block_ids`` (d_rays) and ``sparse_block_ids_chunk_major``
    (d_beams) ids: returns (d_rays, d_beams).  CPU tensors take
    ``gather_backward_sparse_ref``; CUDA tensors launch the sparse sweeps of
    ``csrc/beam_gather_bwd.cu``.  Homogeneous layouts only."""
    _reject_hetero(rays_packed, "the sparse backward",
                   "gather_backward_fused with the forward's block mask")
    if rays_packed.device.type == "cpu":
        return gather_backward_sparse_ref(rays_packed, beams_packed, scalars,
                                          ct, idx_tile_major, idx_chunk_major,
                                          want_extras)
    from .cuda_build import check_status, load_library

    n_tiles, n_chunks, _ = _check_packed(rays_packed, beams_packed, scalars)
    _check_ct(ct, n_tiles, rays_packed.device)
    _check_cuda("idx_tile_major", idx_tile_major, torch.int32,
                (idx_tile_major.shape[0],))
    _check_cuda("idx_chunk_major", idx_chunk_major, torch.int32,
                (idx_chunk_major.shape[0],))
    n_splits = split_count(n_tiles, n_chunks)
    run_start = split_run_starts(
        idx_tile_major, n_tiles, n_chunks,
        split_bounds(scalars[0, 3], n_chunks, n_splits))
    chunk_start = run_starts(idx_chunk_major, n_chunks, n_tiles + 1)
    lib = load_library()
    d_rays, d_beams = _outputs(rays_packed, n_tiles, n_chunks, False)
    staged_beams = staged_beams_buffer(rays_packed, n_chunks, False)
    partial = _partial(rays_packed, n_splits, n_tiles, False)
    stream = torch.cuda.current_stream(rays_packed.device).cuda_stream
    err = lib.bre_gather_backward_sparse(
        rays_packed.data_ptr(), beams_packed.data_ptr(), scalars.data_ptr(),
        ct.data_ptr(), idx_tile_major.data_ptr(), run_start.data_ptr(),
        idx_chunk_major.data_ptr(), chunk_start.data_ptr(),
        staged_beams.data_ptr(), partial.data_ptr(), d_rays.data_ptr(),
        d_beams.data_ptr(), n_tiles, n_chunks, n_splits,
        int(bool(want_extras)), stream)
    check_status(lib, err, "gather_backward_sparse kernels")
    count_launch(gather_backward_sparse, (n_tiles, n_splits, n_chunks), False)
    return d_rays, d_beams


def gather_backward_twopass(rays_packed, beams_packed, scalars, ct):
    """Two-pass dense backward (replaces ``pallas_gather_backward``, the
    reference's ``PALLAS_BWD_MODE = "twopass"``): returns (d_rays (n_tiles,
    8, T), d_beams (n_chunks, NB, C)) over every block, the extras always
    on.  ``scalars`` is the port's (1, 4) row; its ``n_valid`` is not read.
    CPU tensors take ``gather_backward_twopass_ref``; CUDA tensors launch
    ``bwd_rays_twopass`` and ``bwd_beams_twopass``.  Homogeneous layouts
    only, as in the reference."""
    _reject_hetero(rays_packed, "the two-pass backward",
                   "gather_backward_fused")
    if rays_packed.device.type == "cpu":
        return gather_backward_twopass_ref(rays_packed, beams_packed, scalars,
                                           ct)
    from .cuda_build import check_status, load_library

    n_tiles, n_chunks, _ = _check_packed(rays_packed, beams_packed, scalars)
    _check_ct(ct, n_tiles, rays_packed.device)
    lib = load_library()
    d_rays, d_beams = _outputs(rays_packed, n_tiles, n_chunks, False)
    stream = torch.cuda.current_stream(rays_packed.device).cuda_stream
    err = lib.bre_gather_backward_twopass(
        rays_packed.data_ptr(), beams_packed.data_ptr(), scalars.data_ptr(),
        ct.data_ptr(), d_rays.data_ptr(), d_beams.data_ptr(), n_tiles,
        n_chunks, stream)
    check_status(lib, err, "gather_backward_twopass kernels")
    count_launch(gather_backward_twopass, (n_tiles, 1, n_chunks), False)
    return d_rays, d_beams


gather_backward_fused.launches = gather_backward_fused.launches_het = 0
gather_backward_sparse.launches = 0
gather_backward_twopass.launches = 0
gather_backward_fused.last_grid = gather_backward_sparse.last_grid = None
gather_backward_twopass.last_grid = None
