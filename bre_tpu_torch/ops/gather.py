"""Packed beam-radiance gather, forward: layouts, plain PyTorch versions and
the CUDA kernel wrappers (counterpart of ``bre_tpu/ops/pallas_gather.py``).

For a tile of camera segments and a chunk of photon beams, every
(segment, beam) pair contributes the physically normalized 1D-1D beam
radiance estimate; contributions are summed per segment.

Packed layouts (the reference's):
- rays ``(n_tiles, NF, T)``: per-ray rows ``RF_*``, T rays per tile;
- beams ``(n_chunks, NB, C)``: per-beam fields ``BF_*``, C beams per chunk;
- scalars ``(1, 4)``: cam_radius, power_scale, min_sin, n_valid;
- output ``(n_tiles, 8, T)``, RGB in rows 0-2.
Inputs arrive folded: sigma_s rows carry power_scale * in_medium, beam
powers carry validity.

Grid-density (heterogeneous) media extend both layouts (``NF_HET`` ray
rows, ``NB_HET`` beam fields): per segment, the optical thickness factors as
tau_ch(f) = sigma_t[ch] * D(f), with D(f) (no constant term) and the
density dens(f) carried as polynomial coefficients fitted to the segment's
quadrature nodes (``accel/beam_gather.medium_interval_poly``).  A pair then
evaluates dens_c and D_c on the camera side and D_b on the beam side by
Horner, each clamped at 0, and contributes
w * ps * exp(-(sigma_t_b D_b + sigma_t_c D_c)) * sigma_s * dens_c;
the power_end and tr_full rows are not read.

``gather_forward`` (dense, block mask) and ``gather_sparse`` (compacted live
blocks) take their plain versions ``gather_forward_ref``/``gather_sparse_ref``
only for CPU tensors; for CUDA tensors they launch the kernels of
``csrc/beam_gather_fwd.cu`` (T = C = 256), the heterogeneous instance when
the ray rows are ``NF_HET``, or raise.  Each wrapper counts its kernel
launches per instance, in ``<wrapper>.launches`` (homogeneous) and
``<wrapper>.launches_het``, and keeps the grid of its last launch in
``<wrapper>.last_grid``: (ray tiles, splits per tile).

The kernels split each ray tile's chunk range across ``split_count`` blocks
and add the splits' partial sums in a fixed order (``csrc/split_sweep.cuh``);
``split_bounds`` and ``split_run_starts`` are that plan in Python, for the
sparse kernel's list and for the tests.
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

# heterogeneous extension (pallas_gather.py:63-83): polynomial tables
POLY_D_COEFS = 5  # D(f) = c1 f + ... + c5 f^5 (zero constant term)
POLY_DENS_COEFS = 6  # dens(f) = e0 + e1 f + ... + e5 f^5
RF_DC = NF  # 5 rows: camera D(f) coefficients
RF_SIGTC = NF + 5  # 3 rows: camera-medium sigma_t rgb
RF_DENSC = NF + 8  # 6 rows: camera dens(f) coefficients
NF_HET = NF + 14  # 32
BF_DP = NB  # 5 fields: beam D(f) coefficients
BF_SIGT = NB + 5  # 3 fields: beam-medium sigma_t rgb
NB_HET = NB + 8  # 24

OUT_ROWS = 8
KERNEL_TILE = 256  # rays per tile and beams per chunk of the CUDA kernels
KERNEL_CHUNK = 256

# The ray-side sweeps split each ray tile's chunk range across blocks
# (csrc/split_sweep.cuh).  The split count aims at 4 resident 256-thread
# blocks on each of the H100's 132 SMs, 8 waves over: a 64-tile (R/4) sweep
# fills the card, the SMs keep warps enough to hide the pair math's
# dependent chains, and blocks of uneven work (the block mask) even out
# with a short last wave.  Of 1, 2, 4 and 8 such waves, 8 was fastest on
# every main-path sweep (PERF.md, PR 5).
SPLIT_TARGET_BLOCKS = 8 * 4 * 132
# rows of one staged chunk (pair_math.cuh BeamChunk, BeamChunkHet): the
# beam fields with their per-beam terms, written once per call
STAGED_BEAM_ROWS, STAGED_BEAM_ROWS_HET = 16, 21

# plain version: pairs evaluated per batch of blocks (bounds its memory);
# larger on a card, where every op of a batch is one launch
_REF_BATCH_PAIRS_CPU = 1 << 22
_REF_BATCH_PAIRS_CARD = 1 << 24


def pack_rays(seg: dict, tile: int) -> torch.Tensor:
    """seg dict (R-sized tensors, R a multiple of ``tile``) -> (n_tiles, NF,
    T) packed feature rows; (n_tiles, NF_HET, T) when ``seg`` carries the
    heterogeneous tables d_cam_poly (R, 5), sigma_t_cam (R, 3) and
    dens_cam_poly (R, 6)."""
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
    if "d_cam_poly" in seg:  # heterogeneous extension rows
        rows += [seg["d_cam_poly"][:, k] for k in range(POLY_D_COEFS)]
        rows += [seg["sigma_t_cam"][:, ch] for ch in range(3)]
        rows += [seg["dens_cam_poly"][:, k] for k in range(POLY_DENS_COEFS)]
    nf = len(rows)
    packed = torch.stack(rows, 0)  # (nf, R)
    return packed.reshape(nf, R // tile, tile).permute(1, 0, 2).contiguous()


def pack_beams(pb: dict, chunk: int) -> torch.Tensor:
    """Padded beam dict (Bp-sized tensors) -> the non-packed route's
    (n_chunks, NB, C) field-major chunks (pallas_gather.py:338-364), no
    sort; (n_chunks, NB_HET, C) when ``pb`` carries the beam tables d_poly_b
    (Bp, 5) and sigma_t_b (Bp, 3).  The buffer is padded with zero beams up
    to a multiple of ``chunk``: dead beams with zero powers, so exact."""
    Bp = pb["radius"].shape[0]
    zeros = torch.zeros_like(pb["radius"])
    cols = [
        pb["start"][:, 0], pb["start"][:, 1], pb["start"][:, 2],
        pb["end"][:, 0], pb["end"][:, 1], pb["end"][:, 2],
        pb["power_start"][:, 0], pb["power_start"][:, 1],
        pb["power_start"][:, 2],
        pb["power_end"][:, 0], pb["power_end"][:, 1], pb["power_end"][:, 2],
        pb["radius"], pb["valid_f"], zeros, zeros,
    ]
    if "d_poly_b" in pb:  # heterogeneous extension fields
        cols += [pb["d_poly_b"][:, k] for k in range(POLY_D_COEFS)]
        cols += [pb["sigma_t_b"][:, ch] for ch in range(3)]
    nb = len(cols)
    mat = torch.stack(cols, 0)  # (nb, Bp)
    n_chunks = max(1, -(-Bp // chunk))
    if n_chunks * chunk != Bp:
        mat = torch.cat([mat, mat.new_zeros((nb, n_chunks * chunk - Bp))], 1)
    return mat.reshape(nb, n_chunks, chunk).permute(1, 0, 2).contiguous()


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

def block_row(rays_b, k):
    """Ray row k of a batch of ray tiles, (nb, 1, T)."""
    return rays_b[:, k:k + 1, :]


def block_col(beams_b, k):
    """Beam field k of a batch of beam chunks, (nb, C, 1)."""
    return beams_b[:, k, :, None]


def pair_geometry_ref(rays_b, beams_b, cam_radius, min_sin):
    """The geometry of ``_pair_block_update`` (pallas_gather.py:134-242) on
    a batch of blocks, rays_b (nb, NF, T) against beams_b (nb, NB, C):
    Ericson closest points, r^2 against the blur width, the HG denominator's
    rsqrt and the clamped 1/sin(theta), each (nb, C, T).  Every guard is a
    torch.where with safe operands, so no inf or NaN forms even in
    unselected lanes."""
    row = lambda k: block_row(rays_b, k)  # noqa: E731
    col = lambda k: block_col(beams_b, k)  # noqa: E731
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
    inv_sin = torch.clamp_max(
        torch.rsqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 1e-12)),
        1.0 / min_sin)
    return dict(s=s, t_cl=t_cl, r2=r2, in_range=in_range, inv_width=inv_width,
                cos_theta=cos_theta, g=gg, rs=rs, inv_sin=inv_sin)


def beam_power_ref(rays_b, beams_b, ch, t_cl, s):
    """p_at * tr_cam for channel ch as ONE exp, ps * exp(t_b*log(pe/ps) +
    t_c*log(tr)), zero where the start power is dead (_log_decay,
    pallas_gather.py:94-102).  Returns (pt, ps_s, pe_s)."""
    ps, pe = block_col(beams_b, BF_PS + ch), block_col(beams_b, BF_PE + ch)
    ok = ps > 1e-20
    one = torch.ones_like(ps)
    ps_s = torch.where(ok, ps, one)
    pe_s = torch.where(ok, torch.maximum(pe, 1e-12 * ps_s), one)
    lp = torch.log(pe_s / ps_s)
    lt = torch.log(torch.clamp_min(block_row(rays_b, RF_TR + ch), 1e-30))
    pt = ps_s * torch.exp(t_cl * lp + s * lt)
    return torch.where(ok, pt, torch.zeros_like(pt)), ps_s, pe_s


def hetero_tables_ref(rays_b, beams_b, t_cl, s):
    """Horner evaluations of the heterogeneous tables at a pair's closest
    point (pallas_gather.py:208-222), before their clamps at 0: (dens_c
    at the camera fraction s, D_b = t_cl * poly_b(t_cl), D_c = s *
    poly_c(s)), each (nb, C, T)."""
    row = lambda k: block_row(rays_b, k)  # noqa: E731
    col = lambda k: block_col(beams_b, k)  # noqa: E731
    dens = row(RF_DENSC + POLY_DENS_COEFS - 1)
    for k in range(POLY_DENS_COEFS - 2, -1, -1):
        dens = row(RF_DENSC + k) + s * dens
    Db = col(BF_DP + POLY_D_COEFS - 1)
    Dc = row(RF_DC + POLY_D_COEFS - 1)
    for k in range(POLY_D_COEFS - 2, -1, -1):
        Db = col(BF_DP + k) + t_cl * Db
        Dc = row(RF_DC + k) + s * Dc
    return dens, t_cl * Db, s * Dc


def hetero_decay_ref(rays_b, beams_b, ch, Db, Dc):
    """exp(-tau) for channel ch, tau = sigma_t_b D_b + sigma_t_c D_c."""
    tau = (block_col(beams_b, BF_SIGT + ch) * Db
           + block_row(rays_b, RF_SIGTC + ch) * Dc)
    return torch.exp(-tau)


def _pair_blocks_ref(rays_b, beams_b, cam_radius, min_sin):
    """The pair math of ``_pair_block_update`` (pallas_gather.py:134-242)
    on a batch of blocks: rays_b (nb, NF|NF_HET, T), beams_b (nb,
    NB|NB_HET, C) -> (nb, 3, T) sums over each block's beams."""
    q = pair_geometry_ref(rays_b, beams_b, cam_radius, min_sin)
    gg, rs = q["g"], q["rs"]
    rho = 0.07957747154594767 * (1.0 - gg * gg) * (rs * rs * rs)
    k1 = 0.75 * (1.0 - q["r2"]) * q["inv_width"]
    w = rho * k1 * q["inv_sin"] * q["in_range"]

    hetero = rays_b.shape[1] == NF_HET
    if hetero:
        dens, Db, Dc = hetero_tables_ref(rays_b, beams_b, q["t_cl"], q["s"])
        dens = torch.clamp_min(dens, 0.0)
        Db, Dc = torch.clamp_min(Db, 0.0), torch.clamp_min(Dc, 0.0)
    out = []
    for ch in range(3):
        sig = block_row(rays_b, RF_SIGS + ch)
        if hetero:
            pt = (block_col(beams_b, BF_PS + ch)
                  * hetero_decay_ref(rays_b, beams_b, ch, Db, Dc))
            out.append((w * pt * (sig * dens)).sum(1))
        else:
            pt, _, _ = beam_power_ref(rays_b, beams_b, ch, q["t_cl"], q["s"])
            out.append((w * pt * sig).sum(1))
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


def split_count(n_tiles: int, n_chunks: int) -> int:
    """Blocks per ray tile of the ray-side sweeps: SPLIT_TARGET_BLOCKS
    spread over the tiles, at most one per chunk.  A function of the shapes
    only, so dense and sparse sweeps of one call split alike."""
    return max(1, min(n_chunks, -(-SPLIT_TARGET_BLOCKS // max(1, n_tiles))))


def split_bounds(n_valid, n_chunks: int, n_splits: int):
    """(n_splits + 1,) int64 chunk bounds on n_valid's device: split s
    sweeps chunks [b[s], b[s+1]).  The live chunks (j*C < n_valid) are cut
    into ranges of K = ceil(n_live / n_splits); the kernels compute the same
    from n_valid on the card (split_range, csrc/split_sweep.cuh), so no
    host sync and no split for the dead tail."""
    n_valid = torch.as_tensor(n_valid, dtype=torch.float32)
    n_live = torch.clamp(torch.ceil(n_valid / KERNEL_CHUNK), 0,
                         n_chunks).to(torch.int64)
    k = (n_live + n_splits - 1) // n_splits
    s = torch.arange(n_splits + 1, device=n_valid.device, dtype=torch.int64)
    return torch.minimum(s * k, n_live)


def split_run_starts(idx, n_tiles: int, n_chunks: int, bounds):
    """(n_splits + 1, n_tiles) int32 positions in a tile-major id list of
    ``sparse_block_ids``: entries [r[s, t], r[s+1, t]) are tile t's listed
    blocks whose chunk lies in split s of ``bounds`` (no seed entries)."""
    n1 = n_chunks + 1
    keys = (torch.arange(n_tiles, device=idx.device, dtype=torch.int64)[None]
            * n1 + 1 + bounds.to(idx.device)[:, None])
    return torch.searchsorted(idx, keys.to(idx.dtype).contiguous()).to(
        torch.int32).contiguous()


def run_starts(idx, n_runs, run_len):
    """Where each of ``n_runs`` runs of a sorted extended id list starts,
    plus its end: run r holds the ids in [r*run_len, (r+1)*run_len)."""
    bounds = torch.arange(n_runs + 1, device=idx.device,
                          dtype=torch.int32) * run_len
    return torch.searchsorted(idx, bounds).to(torch.int32)


def is_hetero(rays_packed) -> bool:
    """The packed rays carry the heterogeneous rows (the reference picks
    its kernel instance by the same row count, pallas_gather.py:265-267)."""
    return rays_packed.shape[1] == NF_HET


def _check_packed(rays_packed, beams_packed, scalars):
    """Check the packed inputs against one layout, homogeneous or
    heterogeneous; returns (n_tiles, n_chunks, hetero)."""
    n_tiles, n_chunks = rays_packed.shape[0], beams_packed.shape[0]
    hetero = is_hetero(rays_packed)
    nf, nb = (NF_HET, NB_HET) if hetero else (NF, NB)
    _check_cuda("rays_packed", rays_packed, torch.float32,
                (n_tiles, nf, KERNEL_TILE))
    _check_cuda("beams_packed", beams_packed, torch.float32,
                (n_chunks, nb, KERNEL_CHUNK))
    _check_cuda("scalars", scalars, torch.float32, (1, 4))
    for t in (beams_packed, scalars):
        if t.device != rays_packed.device:
            raise ValueError("gather inputs must share one device")
    if n_tiles * nf * KERNEL_TILE >= 2 ** 31 or n_chunks * nb * KERNEL_CHUNK >= 2 ** 31:
        raise ValueError("packed gather inputs exceed the kernel's int32 offsets")
    return n_tiles, n_chunks, hetero


def count_launch(wrapper, grid, hetero: bool) -> None:
    """One more launch of ``wrapper``'s homogeneous or heterogeneous
    kernel instance, whose grid was ``grid``: (ray tiles, splits per tile)
    of the ray-side sweep, and the backward's d_beams blocks.  The grid is
    kept as ``wrapper.last_grid``."""
    wrapper.last_grid = grid
    if hetero:
        wrapper.launches_het += 1
    else:
        wrapper.launches += 1


def staged_beams_buffer(rays_packed, n_chunks, hetero):
    """Scratch for the kernels' beam pre-pass, (n_chunks, 16|21, C)."""
    rows = STAGED_BEAM_ROWS_HET if hetero else STAGED_BEAM_ROWS
    return torch.empty((n_chunks, rows, KERNEL_CHUNK), dtype=torch.float32,
                       device=rays_packed.device)


def _forward_buffers(rays_packed, n_tiles, n_chunks, n_splits, hetero):
    """The staged chunks, the splits' partial sums (n_splits, n_tiles, 3,
    T) and the output (n_tiles, 8, T)."""
    dev = rays_packed.device
    return (staged_beams_buffer(rays_packed, n_chunks, hetero),
            torch.empty((n_splits, n_tiles, 3, KERNEL_TILE),
                        dtype=torch.float32, device=dev),
            torch.empty((n_tiles, OUT_ROWS, KERNEL_TILE), dtype=torch.float32,
                        device=dev))


def gather_forward(rays_packed, beams_packed, scalars, block_mask=None):
    """Dense forward (replaces ``pallas_gather_forward``): returns
    (n_tiles, 8, T).  CPU tensors take ``gather_forward_ref``; CUDA tensors
    launch ``stage_beams``, ``gather_dense_kernel`` over ``split_count``
    blocks per ray tile and ``reduce_splits`` (their heterogeneous
    instances for NF_HET rays)."""
    n_tiles, n_chunks = rays_packed.shape[0], beams_packed.shape[0]
    if block_mask is None:
        block_mask = torch.ones((n_chunks, n_tiles), dtype=torch.float32,
                                device=rays_packed.device)
    if rays_packed.device.type == "cpu":
        return gather_forward_ref(rays_packed, beams_packed, scalars,
                                  block_mask)
    from .cuda_build import check_status, load_library

    _, _, hetero = _check_packed(rays_packed, beams_packed, scalars)
    _check_cuda("block_mask", block_mask, torch.float32, (n_chunks, n_tiles))
    lib = load_library()
    n_splits = split_count(n_tiles, n_chunks)
    staged, partial, out = _forward_buffers(rays_packed, n_tiles, n_chunks,
                                            n_splits, hetero)
    stream = torch.cuda.current_stream(rays_packed.device).cuda_stream
    err = lib.bre_gather_forward(
        rays_packed.data_ptr(), beams_packed.data_ptr(), scalars.data_ptr(),
        block_mask.data_ptr(), staged.data_ptr(), partial.data_ptr(),
        out.data_ptr(), n_tiles, n_chunks, n_splits, int(hetero), stream)
    check_status(lib, err, "gather_dense_kernel")
    count_launch(gather_forward, (n_tiles, n_splits), hetero)
    return out


def gather_sparse(rays_packed, beams_packed, scalars, idx):
    """Sparse live-block forward (replaces ``pallas_gather_sparse``) over
    ``sparse_block_ids`` ids: returns (n_tiles, 8, T).  CPU tensors take
    ``gather_sparse_ref``; CUDA tensors launch ``gather_sparse_kernel``
    (its heterogeneous instance for NF_HET rays) with the dense kernel's
    split, between the same pre-pass and reduction."""
    if rays_packed.device.type == "cpu":
        return gather_sparse_ref(rays_packed, beams_packed, scalars, idx)
    from .cuda_build import check_status, load_library

    n_tiles, n_chunks, hetero = _check_packed(rays_packed, beams_packed,
                                              scalars)
    _check_cuda("idx", idx, torch.int32, (idx.shape[0],))
    n_splits = split_count(n_tiles, n_chunks)
    run_start = split_run_starts(
        idx, n_tiles, n_chunks, split_bounds(scalars[0, 3], n_chunks, n_splits))
    lib = load_library()
    staged, partial, out = _forward_buffers(rays_packed, n_tiles, n_chunks,
                                            n_splits, hetero)
    stream = torch.cuda.current_stream(rays_packed.device).cuda_stream
    err = lib.bre_gather_sparse(
        rays_packed.data_ptr(), beams_packed.data_ptr(), scalars.data_ptr(),
        idx.data_ptr(), run_start.data_ptr(), staged.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n_tiles, n_chunks, n_splits,
        int(hetero), stream)
    check_status(lib, err, "gather_sparse_kernel")
    count_launch(gather_sparse, (n_tiles, n_splits), hetero)
    return out


gather_forward.launches = gather_forward.launches_het = 0
gather_sparse.launches = gather_sparse.launches_het = 0
gather_forward.last_grid = gather_sparse.last_grid = None
