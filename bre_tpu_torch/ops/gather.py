"""Packed beam-radiance gather, forward: layouts, plain PyTorch versions and
the CUDA kernel wrappers (counterpart of ``bre_tpu/ops/pallas_gather.py``).

For a tile of camera segments and a chunk of photon beams, every
(segment, beam) pair contributes the physically normalized 1D-1D beam
radiance estimate; contributions are summed per segment.

Packed layouts (the reference's, homogeneous media):
- rays ``(n_tiles, NF, T)``: per-ray rows ``RF_*``, T rays per tile;
- beams ``(n_chunks, NB, C)``: per-beam fields ``BF_*``, C beams per chunk;
- scalars ``(1, 4)``: cam_radius, power_scale, min_sin, n_valid;
- output ``(n_tiles, 8, T)``, RGB in rows 0-2.
Inputs arrive folded: sigma_s rows carry power_scale * in_medium, beam
powers carry validity.

``gather_forward`` (dense, block mask) and ``gather_sparse`` (compacted live
blocks) take their plain versions ``gather_forward_ref``/``gather_sparse_ref``
only for CPU tensors; for CUDA tensors they launch the kernels of
``csrc/beam_gather_fwd.cu`` (T = C = 256) or raise.  Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

# ray feature rows (NF x T blocks)
RF_A0 = 0  # a0.x a0.y a0.z rows 0..2
RF_A1 = 3
RF_DIR = 6
RF_LEN = 9
RF_TR = 10  # tr_full rgb rows 10..12
RF_SIGS = 13  # sigma_s rgb rows 13..15
RF_G = 16
RF_INMED = 17
NF = 18

# beam feature fields (NB x C blocks)
BF_B0 = 0
BF_B1 = 3
BF_PS = 6
BF_PE = 9
BF_RAD = 12
BF_VALID = 13
NB = 16  # padded

OUT_ROWS = 8
KERNEL_TILE = 256  # rays per tile and beams per chunk of the CUDA kernels
KERNEL_CHUNK = 256

# plain version: pairs evaluated per batch of blocks (bounds its memory);
# larger on a card, where every op of a batch is one launch
_REF_BATCH_PAIRS_CPU = 1 << 22
_REF_BATCH_PAIRS_CARD = 1 << 24


def pack_rays(seg: dict, tile: int) -> torch.Tensor:
    """seg dict (R-sized tensors, R a multiple of ``tile``) -> (n_tiles, NF,
    T) packed feature rows."""
    R = seg["a0"].shape[0]
    rows = [
        seg["a0"][:, 0], seg["a0"][:, 1], seg["a0"][:, 2],
        seg["a1"][:, 0], seg["a1"][:, 1], seg["a1"][:, 2],
        seg["dir"][:, 0], seg["dir"][:, 1], seg["dir"][:, 2],
        seg["len"],
        seg["tr_full"][:, 0], seg["tr_full"][:, 1], seg["tr_full"][:, 2],
        seg["sigma_s"][:, 0], seg["sigma_s"][:, 1], seg["sigma_s"][:, 2],
        seg["g"],
        seg["in_med_f"],
    ]
    packed = torch.stack(rows, 0)  # (NF, R)
    return packed.reshape(NF, R // tile, tile).permute(1, 0, 2).contiguous()


def sparse_block_ids(block_mask: torch.Tensor, cap: int):
    """Compact live (chunk, tile) blocks to extended flat ids, tile-major
    (the reference's ``jnp.nonzero(size=, fill_value=)``).

    Returns (idx (n_tiles + cap,) int32, n_live () int64): live blocks are
    ``tile*(n_chunks+1) + chunk+1``, each tile's seed entry is
    ``tile*(n_chunks+1)``, and fill entries are ``n_tiles*(n_chunks+1)``.
    When the list overflows (n_live > cap) it is truncated, as in the
    reference; callers then take the dense kernel."""
    n_chunks, n_tiles = block_mask.shape
    ext = torch.cat([torch.ones((n_tiles, 1), dtype=block_mask.dtype,
                                device=block_mask.device), block_mask.T], 1)
    nz = torch.nonzero(ext.reshape(-1) != 0).reshape(-1)[: n_tiles + cap]
    idx = torch.full((n_tiles + cap,), n_tiles * (n_chunks + 1),
                     dtype=torch.int32, device=block_mask.device)
    idx[: nz.shape[0]] = nz.to(torch.int32)
    n_live = (block_mask > 0).sum()
    return idx, n_live


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _pair_blocks_ref(rays_b, beams_b, cam_radius, min_sin):
    """The pair math of ``_pair_block_update`` (pallas_gather.py:134-242)
    on a batch of blocks: rays_b (nb, NF, T), beams_b (nb, NB, C) ->
    (nb, 3, T) sums over each block's beams.  Every guard is a torch.where
    with safe operands, so no inf or NaN forms even in unselected lanes."""
    row = lambda k: rays_b[:, k:k + 1, :]  # (nb,1,T)  # noqa: E731
    col = lambda k: beams_b[:, k, :, None]  # (nb,C,1)  # noqa: E731
    a0 = [row(RF_A0 + c) for c in range(3)]
    d1 = [row(RF_A1 + c) - a0[c] for c in range(3)]
    b0 = [col(BF_B0 + c) for c in range(3)]
    d2 = [col(BF_B1 + c) - b0[c] for c in range(3)]

    a = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2]  # (nb,1,T)
    e = d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2]  # (nb,C,1)
    rr = [a0[c] - b0[c] for c in range(3)]
    b = d1[0] * d2[0] + d1[1] * d2[1] + d1[2] * d2[2]
    c_ = d1[0] * rr[0] + d1[1] * rr[1] + d1[2] * rr[2]
    f = d2[0] * rr[0] + d2[1] * rr[1] + d2[2] * rr[2]
    denom = a * e - b * b
    dpos = denom > 1e-12
    s = torch.where(dpos, (b * f - c_ * e) / torch.where(
        dpos, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    s = torch.clamp(s, 0.0, 1.0)
    epos = e > 1e-12
    inv_e = torch.where(epos, 1.0 / torch.where(epos, e, torch.ones_like(e)),
                        torch.zeros_like(e))
    t = (b * s + f) * inv_e
    t_cl = torch.clamp(t, 0.0, 1.0)
    apos = a > 1e-12
    inv_a = torch.where(apos, 1.0 / torch.where(apos, a, torch.ones_like(a)),
                        torch.zeros_like(a))
    s_new = torch.clamp((t_cl * b - c_) * inv_a, 0.0, 1.0)
    s = torch.where((t != t_cl) & apos, s_new, s)

    dist2 = torch.zeros_like(b)
    for c in range(3):
        diff = (a0[c] + d1[c] * s) - (b0[c] + d2[c] * t_cl)
        dist2 = dist2 + diff * diff
    width = torch.clamp_min(cam_radius + col(BF_RAD), 1e-30)
    inv_width = 1.0 / width
    r2 = dist2 * (inv_width * inv_width)
    in_range = (r2 < 1.0).to(torch.float32)
    inv_beam_len = torch.rsqrt(torch.clamp_min(e, 1e-30))
    cos_theta = sum(row(RF_DIR + c) * (d2[c] * inv_beam_len) for c in range(3))
    gg = row(RF_G)
    rs = torch.rsqrt(torch.clamp_min(1.0 + gg * gg + 2.0 * gg * cos_theta, 1e-12))
    rho = 0.07957747154594767 * (1.0 - gg * gg) * (rs * rs * rs)
    inv_sin = torch.clamp_max(
        torch.rsqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 1e-12)),
        1.0 / min_sin)
    k1 = 0.75 * (1.0 - r2) * inv_width
    w = rho * k1 * inv_sin * in_range

    out = []
    for ch in range(3):
        # p_at * tr_cam as ONE exp: ps * exp(t_b*log(pe/ps) + t_c*log(tr))
        ps, pe = col(BF_PS + ch), col(BF_PE + ch)
        ok = ps > 1e-20
        one = torch.ones_like(ps)
        ps_s = torch.where(ok, ps, one)
        pe_s = torch.where(ok, torch.maximum(pe, 1e-12 * ps_s), one)
        lp = torch.log(pe_s / ps_s)
        lt = torch.log(torch.clamp_min(row(RF_TR + ch), 1e-30))
        pt = ps_s * torch.exp(t_cl * lp + s * lt)
        pt = torch.where(ok, pt, torch.zeros_like(pt))
        out.append((w * pt * row(RF_SIGS + ch)).sum(1))
    return torch.stack(out, 1)


def _blocks_ref(rays_packed, beams_packed, scalars, tiles, chunks):
    """Accumulate the listed (tile, chunk) blocks, tile-major with chunks
    ascending, into a (n_tiles, 8, T) output."""
    n_tiles, _, T = rays_packed.shape
    C = beams_packed.shape[2]
    cam_radius, min_sin = scalars[0, 0], scalars[0, 2]
    out = torch.zeros((n_tiles, OUT_ROWS, T), dtype=torch.float32,
                      device=rays_packed.device)
    pairs = (_REF_BATCH_PAIRS_CPU if rays_packed.device.type == "cpu"
             else _REF_BATCH_PAIRS_CARD)
    nb = max(1, pairs // (T * C))
    for lo in range(0, tiles.shape[0], nb):
        ti, ch = tiles[lo:lo + nb], chunks[lo:lo + nb]
        upd = _pair_blocks_ref(rays_packed[ti], beams_packed[ch], cam_radius,
                               min_sin)
        out[:, :3].index_add_(0, ti, upd)
    return out


def _live_chunks(n_chunks: int, chunk: int, n_valid, device):
    """(n_chunks,) bool: chunk j holds live beams iff j*C < n_valid."""
    start = (torch.arange(n_chunks, device=device) * chunk).to(torch.float32)
    return start < n_valid


def gather_forward_ref(rays_packed, beams_packed, scalars, block_mask=None):
    """Plain version of the dense forward: every block with
    ``block_mask[j, i] > 0`` whose chunk lies before ``n_valid``."""
    n_tiles = rays_packed.shape[0]
    n_chunks, _, C = beams_packed.shape
    live = _live_chunks(n_chunks, C, scalars[0, 3], rays_packed.device)
    live = live[:, None].expand(n_chunks, n_tiles)
    if block_mask is not None:
        live = live & (block_mask > 0)
    tiles, chunks = torch.nonzero(live.T, as_tuple=True)  # tile-major
    return _blocks_ref(rays_packed, beams_packed, scalars, tiles, chunks)


def gather_sparse_ref(rays_packed, beams_packed, scalars, idx):
    """Plain version of the sparse forward over ``sparse_block_ids`` ids."""
    n_tiles = rays_packed.shape[0]
    n_chunks, _, C = beams_packed.shape
    n1 = n_chunks + 1
    idx = idx.to(torch.int64)
    tile, sub = idx // n1, idx % n1
    live_c = _live_chunks(n_chunks, C, scalars[0, 3], rays_packed.device)
    keep = (tile < n_tiles) & (sub > 0)
    keep &= live_c[torch.clamp_min(sub - 1, 0)]
    return _blocks_ref(rays_packed, beams_packed, scalars, tile[keep],
                       sub[keep] - 1)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_packed(rays_packed, beams_packed, scalars):
    n_tiles, n_chunks = rays_packed.shape[0], beams_packed.shape[0]
    _check_cuda("rays_packed", rays_packed, torch.float32,
                (n_tiles, NF, KERNEL_TILE))
    _check_cuda("beams_packed", beams_packed, torch.float32,
                (n_chunks, NB, KERNEL_CHUNK))
    _check_cuda("scalars", scalars, torch.float32, (1, 4))
    for t in (beams_packed, scalars):
        if t.device != rays_packed.device:
            raise ValueError("gather inputs must share one device")
    if n_tiles * NF * KERNEL_TILE >= 2 ** 31 or n_chunks * NB * KERNEL_CHUNK >= 2 ** 31:
        raise ValueError("packed gather inputs exceed the kernel's int32 offsets")
    return n_tiles, n_chunks


def gather_forward(rays_packed, beams_packed, scalars, block_mask=None):
    """Dense forward (replaces ``pallas_gather_forward``): returns
    (n_tiles, 8, T).  CPU tensors take ``gather_forward_ref``; CUDA tensors
    launch ``gather_dense_kernel``."""
    n_tiles, n_chunks = rays_packed.shape[0], beams_packed.shape[0]
    if block_mask is None:
        block_mask = torch.ones((n_chunks, n_tiles), dtype=torch.float32,
                                device=rays_packed.device)
    if rays_packed.device.type == "cpu":
        return gather_forward_ref(rays_packed, beams_packed, scalars,
                                  block_mask)
    from .cuda_build import check_status, load_library

    _check_packed(rays_packed, beams_packed, scalars)
    _check_cuda("block_mask", block_mask, torch.float32, (n_chunks, n_tiles))
    lib = load_library()
    out = torch.empty((n_tiles, OUT_ROWS, KERNEL_TILE), dtype=torch.float32,
                      device=rays_packed.device)
    stream = torch.cuda.current_stream(rays_packed.device).cuda_stream
    err = lib.bre_gather_forward(
        rays_packed.data_ptr(), beams_packed.data_ptr(), scalars.data_ptr(),
        block_mask.data_ptr(), out.data_ptr(), n_tiles, n_chunks, stream)
    check_status(lib, err, "gather_dense_kernel")
    gather_forward.launches += 1
    return out


def gather_sparse(rays_packed, beams_packed, scalars, idx):
    """Sparse live-block forward (replaces ``pallas_gather_sparse``) over
    ``sparse_block_ids`` ids: returns (n_tiles, 8, T).  CPU tensors take
    ``gather_sparse_ref``; CUDA tensors launch ``gather_sparse_kernel``."""
    if rays_packed.device.type == "cpu":
        return gather_sparse_ref(rays_packed, beams_packed, scalars, idx)
    from .cuda_build import check_status, load_library

    n_tiles, n_chunks = _check_packed(rays_packed, beams_packed, scalars)
    _check_cuda("idx", idx, torch.int32, (idx.shape[0],))
    # each tile's run of the tile-major id list
    bounds = (torch.arange(n_tiles + 1, device=idx.device, dtype=torch.int32)
              * (n_chunks + 1))
    tile_start = torch.searchsorted(idx, bounds).to(torch.int32)
    lib = load_library()
    out = torch.empty((n_tiles, OUT_ROWS, KERNEL_TILE), dtype=torch.float32,
                      device=rays_packed.device)
    stream = torch.cuda.current_stream(rays_packed.device).cuda_stream
    err = lib.bre_gather_sparse(
        rays_packed.data_ptr(), beams_packed.data_ptr(), scalars.data_ptr(),
        idx.data_ptr(), tile_start.data_ptr(), out.data_ptr(), n_tiles,
        n_chunks, stream)
    check_status(lib, err, "gather_sparse_kernel")
    gather_sparse.launches += 1
    return out


gather_forward.launches = 0
gather_sparse.launches = 0
