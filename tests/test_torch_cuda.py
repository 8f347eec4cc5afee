"""bre_tpu_torch CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, not at import).  These tests import no
JAX, so on a CUDA machine without JAX they run from the repository root as
  python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
      tests/test_torch_cuda.py -q

Tolerances: forward kernels vs plain versions rtol 2e-4 / atol 1e-8 (the
reference's Pallas tolerance, tests/test_pallas_gather.py:47; measured ~1e-6:
the kernel rounds every product and sum as the plain version does and only
the sum order and the math library's exp/log/rsqrt differ); backward kernels
max|d| <= 2e-4 * (max|ref| + 1e-9) per cotangent (the reference's backward
criterion, tests/test_pallas_gather.py:448, held per gradient there).  The
split sweeps (rows 1-5) are held on shapes with more than one split per ray
tile, one ray tile, and fewer valid beams than one chunk, dense against
sparse and run against run bit for bit.  CUDA vs CPU image
means 1e-3: same PCG32 streams, float-ulp flips of a few photon decisions
at most.  The grid-density (heterogeneous) instances are held to the same
criteria; their zero rows (d tr_full, d power_end, geometry) exactly 0."""

import numpy as np
import pytest
import torch

from bre_tpu_torch.accel import beam_gather as BG
from bre_tpu_torch.core import transform as tfm
from bre_tpu_torch.integrators.photon_trace import Beams
from bre_tpu_torch.integrators.photonbeam import PhotonBeamConfig, render_photonbeam
from bre_tpu_torch.ops import gather as G
from bre_tpu_torch.ops import gather_bwd as GB
from bre_tpu_torch.scene.builder import SceneBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bre_tpu_torch kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda", 0)


def _inputs(dev, n_tiles=8, n_chunks=40, seed=0):
    rs = np.random.RandomState(seed)
    T = C = 256
    rays = rs.uniform(-1, 1, (n_tiles, G.NF, T)).astype(np.float32)
    d = rays[:, 3:6] - rays[:, 0:3]
    rays[:, 6:9] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays[:, 10:13] = rs.uniform(0.2, 1.0, (n_tiles, 3, T))
    rays[:, 13:16] = rs.uniform(0.0, 1e-2, (n_tiles, 3, T))
    rays[:, 16] = rs.uniform(-0.6, 0.6, (n_tiles, T))
    beams = rs.uniform(-1, 1, (n_chunks, G.NB, C)).astype(np.float32)
    beams[:, 6:9] = rs.uniform(0.5, 2.0, (n_chunks, 3, C))
    beams[:, 9:12] = beams[:, 6:9] * rs.uniform(0.05, 1.0, (n_chunks, 3, C))
    beams[:, 12] = 0.15
    beams[-2, 6:12, 50:] = 0.0  # dead powers
    scal = np.array([[0.1, 1.0, 0.05, (n_chunks - 1) * C - 30]], np.float32)
    mask = (rs.rand(n_chunks, n_tiles) < 0.4).astype(np.float32)
    mask[:, 1] = 0.0
    return [torch.from_numpy(x).to(dev) for x in (rays, beams, scal, mask)]


def test_kernels_match_plain_versions(dev):
    rays, beams, scal, mask = _inputs(dev)
    n0 = (G.gather_forward.launches, G.gather_sparse.launches)
    dense = G.gather_forward(rays, beams, scal, mask)
    idx, n_live = G.sparse_block_ids(mask, int(mask.sum()))
    sparse = G.gather_sparse(rays, beams, scal, idx)
    torch.cuda.synchronize()
    assert (G.gather_forward.launches, G.gather_sparse.launches) == (n0[0] + 1, n0[1] + 1)
    ref = G.gather_forward_ref(rays, beams, scal, mask)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(dense, ref, rtol=2e-4, atol=1e-8)
    torch.testing.assert_close(sparse, G.gather_sparse_ref(rays, beams, scal, idx),
                               rtol=2e-4, atol=1e-8)
    # same live blocks in the same order: bit-identical, and deterministic
    assert torch.equal(dense, sparse)
    assert torch.equal(dense, G.gather_forward(rays, beams, scal, mask))
    assert float(dense[1].abs().max()) == 0.0


def test_wrappers_reject_bad_inputs(dev):
    rays, beams, scal, mask = _inputs(dev, n_tiles=2, n_chunks=3)
    with pytest.raises(ValueError, match="contiguous"):
        G.gather_forward(rays.transpose(1, 2).contiguous().transpose(1, 2),
                         beams, scal, mask)
    with pytest.raises(ValueError, match="float32"):
        G.gather_forward(rays, beams.double(), scal, mask)
    with pytest.raises(ValueError, match="shape"):
        G.gather_forward(rays[:, :, :128].contiguous(), beams, scal, mask[:, :2])
    with pytest.raises(ValueError, match="int32"):
        G.gather_sparse(rays, beams, scal, torch.zeros(4, dtype=torch.int64,
                                                       device=dev))


def _split_inputs(dev, n_tiles, n_chunks, n_valid, het):
    """Inputs whose every chunk is live in the mask's first row, at a given
    n_valid: the split plan's edge cases."""
    rays, beams, scal, mask = (_het_inputs if het else _inputs)(
        dev, max(n_tiles, 2), n_chunks, seed=n_tiles + n_chunks)
    rays, mask = rays[:n_tiles].contiguous(), mask[:, :n_tiles].contiguous()
    mask[0] = 1.0
    scal[0, 3] = n_valid
    return rays, beams, scal, mask


@pytest.mark.parametrize("het", [False, True])
@pytest.mark.parametrize("n_tiles,n_chunks,n_valid", [
    (1, 24, 23 * 256 - 7),   # one ray tile: one split per chunk
    (3, 12, 100),            # fewer valid beams than one chunk
    (3, 12, 0),              # none valid: every split writes zeros
    (300, 40, 40 * 256 - 9),  # 15 splits of up to 3 chunks, the last empty
])
def test_split_sweeps_match_plain_versions(dev, het, n_tiles, n_chunks,
                                           n_valid):
    """Rows 1-5 with each tile's chunk range split across blocks: each
    kernel against its plain version, dense against sparse bit for bit
    (homogeneous), and two runs bit for bit."""
    rays, beams, scal, mask = _split_inputs(dev, n_tiles, n_chunks, n_valid,
                                            het)
    ct = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (n_tiles, GB.NDR, 256)).astype(np.float32)).to(dev)
    ct[:, 3:] = 0.0
    idx, _ = G.sparse_block_ids(mask, int(mask.sum()))
    fwd = [G.gather_forward(rays, beams, scal, mask) for _ in range(2)]
    bwd = [GB.gather_backward_fused(rays, beams, scal, ct, mask, True)
           for _ in range(2)]
    sparse = G.gather_sparse(rays, beams, scal, idx)
    torch.cuda.synchronize()
    n_splits = G.split_count(n_tiles, n_chunks)
    assert n_splits > 1
    assert G.gather_forward.last_grid == (n_tiles, n_splits)
    assert G.gather_sparse.last_grid == (n_tiles, n_splits)
    assert GB.gather_backward_fused.last_grid == (n_tiles, n_splits, n_chunks)
    ref = G.gather_forward_ref(rays, beams, scal, mask)
    torch.testing.assert_close(fwd[0], ref, rtol=2e-4, atol=1e-8)
    assert torch.equal(fwd[0], fwd[1]) and torch.equal(fwd[0], sparse)
    assert (float(ref.abs().max()) > 0) == (n_valid > 0)
    bref = GB.gather_backward_fused_ref(rays, beams, scal, ct, mask, True)
    rows = ((GB.D_RAYS_ROWS_HET, GB.D_BEAMS_ROWS_HET) if het
            else (GB.D_RAYS_ROWS, GB.D_BEAMS_ROWS))
    for o, r, rr in zip(bwd[0], bref, rows):
        for name, sl in rr.items():
            err = float((o[:, sl] - r[:, sl]).abs().max())
            assert err <= 2e-4 * (float(r[:, sl].abs().max()) + 1e-9), name
    assert all(torch.equal(a, b) for a, b in zip(*bwd))
    if not het:
        idx_c, _ = GB.sparse_block_ids_chunk_major(mask, int(mask.sum()))
        bsp = GB.gather_backward_sparse(rays, beams, scal, ct, idx, idx_c,
                                        True)
        assert all(torch.equal(a, b) for a, b in zip(bwd[0], bsp))


@pytest.mark.parametrize("het", [False, True])
@pytest.mark.parametrize("want_extras", [False, True])
def test_sparse_kernels_in_the_sparse_regime(dev, het, want_extras):
    """Rows 2 and 4 on a mask at most a quarter live with a few heavy
    chunks and tiles (the regime gather="auto" picks them for), their runs
    launched largest first: against their plain versions, against the
    dense kernels bit for bit, two runs bit for bit, and the lists, plans
    and launches without a host sync.  The sparse backward is homogeneous
    only; ``het`` holds the heterogeneous sparse forward."""
    n_tiles, n_chunks = 300, 40
    rays, beams, scal, _ = (_het_inputs if het else _inputs)(
        dev, n_tiles, n_chunks, seed=11)
    m = np.random.RandomState(12).rand(n_chunks, n_tiles) < 0.05
    m[[2, 17, 33]] = True  # heavy chunks
    m[:, [5, 250]] = True  # heavy tiles
    mask = torch.from_numpy(m.astype(np.float32)).to(dev)
    assert float(mask.mean()) <= 0.25
    ct = torch.from_numpy(np.random.RandomState(13).uniform(
        -1, 1, (n_tiles, GB.NDR, 256)).astype(np.float32)).to(dev)
    ct[:, 3:] = 0.0
    cap = n_chunks * n_tiles // 4
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx_t, _ = G.sparse_block_ids(mask, cap)
        fwd = [G.gather_sparse(rays, beams, scal, idx_t) for _ in range(2)]
        if not het:
            idx_c, _ = GB.sparse_block_ids_chunk_major(mask, cap)
            bwd = [GB.gather_backward_sparse(rays, beams, scal, ct, idx_t,
                                             idx_c, want_extras)
                   for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n_splits = G.split_count(n_tiles, n_chunks)
    assert G.gather_sparse.last_grid == (n_tiles, n_splits)
    torch.testing.assert_close(fwd[0], G.gather_sparse_ref(
        rays, beams, scal, idx_t), rtol=2e-4, atol=1e-8)
    assert torch.equal(fwd[0], fwd[1])
    assert torch.equal(fwd[0], G.gather_forward(rays, beams, scal, mask))
    if het:
        return
    _close_by_cotangent(bwd[0], GB.gather_backward_sparse_ref(
        rays, beams, scal, ct, idx_t, idx_c, want_extras))
    dense = GB.gather_backward_fused(rays, beams, scal, ct, mask, want_extras)
    for a, b, c in zip(bwd[0], bwd[1], dense):
        assert torch.equal(a, b) and torch.equal(a, c)


def _cornell(dev, point_light=False):
    b = SceneBuilder()
    fog = b.homogeneous_medium((0.02,) * 3, (0.35,) * 3, g=0.0)
    white = b.matte((0.73, 0.73, 0.73))
    b.box((-1, -1, 0), (1, 1, 2), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-1, -1, 2), (-1, 1, 2), (1, 1, 2), (1, -1, 2), material=white)
    b.quad((-1, -1, 0), (1, -1, 0), (1, -1, 2), (-1, -1, 2), material=white)
    b.area_light_quad((-0.3, 0.98, 0.7), (0.3, 0.98, 0.7),
                      (0.3, 0.98, 1.3), (-0.3, 0.98, 1.3),
                      (6.0, 5.5, 4.5), medium=fog)
    if point_light:  # a second light: a point light in the fog
        b.point_light((0.2, -0.4, 1.1), (0.8, 0.9, 1.0), medium=fog)
    return b.build(device=dev)


def test_render_on_card_matches_cpu(dev):
    W = 32
    cfg = PhotonBeamConfig(iterations=1, maxdepth=5, photonsperiteration=4000,
                           initialbeamradius=0.12, alpha=0.7, gather="auto",
                           grad_geometry=False)
    imgs = []
    for d in (dev, torch.device("cpu")):
        cam = make_perspective_camera(
            tfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, W, W,
            device=d)
        img, _ = render_photonbeam(_cornell(d), cam, W, W, cfg)
        imgs.append(img.cpu())
    assert bool(torch.isfinite(imgs[0]).all()) and float(imgs[1].mean()) > 0
    rel = float((imgs[0].mean() / imgs[1].mean() - 1).abs())
    assert rel < 1e-3, rel


def _close(out, ref):
    assert float(ref.abs().max()) > 0
    err = float((out - ref).abs().max())
    assert err <= 2e-4 * (float(ref.abs().max()) + 1e-9), err


def _close_by_cotangent(out, ref):
    """The backward criterion per cotangent (rows of d_rays and d_beams),
    not over the packed tensors, whose largest rows would hide the small
    ones; d_beams rows outside the cotangents stay zero."""
    for o, r, rows in zip(out, ref, (GB.D_RAYS_ROWS, GB.D_BEAMS_ROWS)):
        for name, sl in rows.items():
            err = float((o[:, sl] - r[:, sl]).abs().max())
            r_max = float(r[:, sl].abs().max())
            assert err <= 2e-4 * (r_max + 1e-9), (name, err, r_max)
    other = torch.ones(G.NB, dtype=torch.bool, device=out[1].device)
    for sl in GB.D_BEAMS_ROWS.values():
        other[sl] = False
    assert float(out[1][:, other].abs().max()) == 0.0


@pytest.mark.parametrize("want_extras", [True, False])
def test_backward_kernels_match_plain_versions(dev, want_extras):
    rays, beams, scal, mask = _inputs(dev)
    ct = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (rays.shape[0], GB.NDR, 256)).astype(np.float32)).to(dev)
    ct[:, 3:] = 0.0
    cap = int(mask.sum())
    idx_t, _ = G.sparse_block_ids(mask, cap)
    idx_c, _ = GB.sparse_block_ids_chunk_major(mask, cap)
    n0 = (GB.gather_backward_fused.launches, GB.gather_backward_sparse.launches)
    dense = GB.gather_backward_fused(rays, beams, scal, ct, mask, want_extras)
    sparse = GB.gather_backward_sparse(rays, beams, scal, ct, idx_t, idx_c,
                                       want_extras)
    torch.cuda.synchronize()
    assert (GB.gather_backward_fused.launches,
            GB.gather_backward_sparse.launches) == (n0[0] + 1, n0[1] + 1)
    ref = GB.gather_backward_fused_ref(rays, beams, scal, ct, mask, want_extras)
    assert float(ref[0].abs().max()) > 0
    _close_by_cotangent(dense, ref)
    _close_by_cotangent(sparse, GB.gather_backward_sparse_ref(
        rays, beams, scal, ct, idx_t, idx_c, want_extras))
    # same live blocks in the same order: bit-identical, and deterministic
    for a, b, c in zip(dense, sparse, GB.gather_backward_fused(
            rays, beams, scal, ct, mask, want_extras)):
        assert torch.equal(a, b) and torch.equal(a, c)
    # a tile without live blocks, the chunk past n_valid, the extras
    assert float(dense[0][1].abs().max()) == 0.0
    assert float(dense[1][-1].abs().max()) == 0.0
    assert (float(dense[0][:, GB.DR_G:].abs().max()) > 0) == want_extras


# (n_tiles, n_chunks, chunks whose powers are dead, zero-padded tail from)
TWOPASS_CASES = {
    "dead_middle": (4, 40, range(17, 18), None),
    "dead_tail": (4, 40, range(30, 36), 36),
    "all_dead": (4, 40, range(0, 40), None),
    "one_tile": (1, 24, range(9, 11), 20),
    "many_tiles": (300, 40, range(5, 6), 33),
}


@pytest.mark.parametrize("case", list(TWOPASS_CASES))
def test_twopass_kernels_match_plain_version(dev, case):
    """Kernel 6 (``gather_backward_twopass``): every block of the grid
    whatever n_valid says, the extras always on, per cotangent against its
    plain version, and twice bit for bit (no atomics), with no host sync.
    Its d_rays sweep runs ``split_count`` blocks per ray tile; the chunks
    without a live start power (a dead chunk in the middle, a dead tail of
    invalid and zero-padded beams, or every chunk) get exact zeros, and the
    last chunk, past n_valid with live powers, keeps its cotangents."""
    n_tiles, n_chunks, dead, pad = TWOPASS_CASES[case]
    rays, beams, scal, _ = _inputs(dev, max(n_tiles, 2), n_chunks, seed=21)
    rays = rays[:n_tiles].contiguous()
    beams[list(dead), G.BF_PS:G.BF_PE + 3] = 0.0
    if pad is not None:
        beams[pad:] = 0.0
    ct = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (n_tiles, GB.NDR, 256)).astype(np.float32)).to(dev)
    ct[:, 3:] = 0.0
    n0 = GB.gather_backward_twopass.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = GB.gather_backward_twopass(rays, beams, scal, ct)
        again = GB.gather_backward_twopass(rays, beams, scal, ct)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert GB.gather_backward_twopass.launches == n0 + 2
    n_splits = G.split_count(n_tiles, n_chunks)
    assert n_splits > 1
    assert GB.gather_backward_twopass.last_grid == (n_tiles, n_splits,
                                                     n_chunks)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    ref = GB.gather_backward_twopass_ref(rays, beams, scal, ct)
    flags, _ = GB.twopass_chunk_flags(beams)
    unflagged = ~flags
    if case == "all_dead":
        assert not bool(flags.any())
        assert all(float(x.abs().max()) == 0.0 for x in out + ref)
        return
    assert all(float(r.abs().max()) > 0 for r in ref)
    _close_by_cotangent(out, ref)
    assert float(out[1][unflagged].abs().max()) == 0.0
    assert float(ref[1][unflagged].abs().max()) == 0.0
    if pad is None:  # no dead-chunk skip by n_valid
        assert float(out[1][-1].abs().max()) > 0


def _bruteforce_grad(d, mode, grad_geometry, monkeypatch):
    """Cotangents of the non-packed gather (backend "pallas") in the beam
    powers, radii, the segments' transmittance, sigma_s, g and cam_radius."""
    monkeypatch.setattr(BG, "PALLAS_BWD_MODE", mode)
    rs = np.random.RandomState(6)
    B, R = 1500, 600
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=d)  # noqa: E731
    ps = rs.uniform(0.5, 2, (B, 3))
    a0, a1 = rs.uniform(-1, 0, (R, 3)), rs.uniform(0, 1, (R, 3))
    leaves = dict(power_start=f(ps), power_end=f(ps * rs.uniform(0.1, 1, (B, 3))),
                  radius=f(np.full(B, 0.15)), tr=f(rs.uniform(0.2, 0.9, (R, 3))),
                  cam_radius=f(0.1))
    for v in leaves.values():
        v.requires_grad_()
    valid = torch.from_numpy(rs.rand(B) < 0.7).to(d)
    beams = Beams(start=f(rs.uniform(-1, 1, (B, 3))), end=f(rs.uniform(-1, 1, (B, 3))),
                  power_start=leaves["power_start"], power_end=leaves["power_end"],
                  radius=leaves["radius"],
                  medium=torch.zeros(B, dtype=torch.int64, device=d), valid=valid)
    scene = _cornell(d)
    sig = scene.media.sigma_s.detach().clone().requires_grad_()
    g = scene.media.g.detach().clone().requires_grad_()
    out = BG.gather_beams_bruteforce(
        beams, scene.media._replace(sigma_s=sig, g=g), f(a0), f(a1),
        f((a1 - a0) / np.linalg.norm(a1 - a0, axis=-1, keepdims=True)),
        torch.zeros(R, dtype=torch.int64, device=d), leaves["tr"],
        leaves["cam_radius"], chunk=512, power_scale=1e-3, backend="pallas",
        grad_geometry=grad_geometry)
    w = f(rs.uniform(0, 1, (R, 3)))
    return torch.autograd.grad((out * w).sum(), [*leaves.values(), sig, g])


@pytest.mark.parametrize("mode,grad_geometry", [("fused", False),
                                                ("twopass", False),
                                                ("fused", True)])
def test_bruteforce_gradients_on_card(dev, mode, grad_geometry, monkeypatch):
    """The default route's gather on the card: the forward kernel on the
    non-packed layout, then the analytic backward kernels (geometry
    detached, "fused" or "twopass") or the recompute backward (geometry
    attached); gradients against the CPU's, and repeated bit for bit."""
    n0 = (G.gather_forward.launches, GB.gather_backward_fused.launches,
          GB.gather_backward_twopass.launches)
    runs = [_bruteforce_grad(d, mode, grad_geometry, monkeypatch)
            for d in (dev, dev, torch.device("cpu"))]
    torch.cuda.synchronize()
    n1 = (G.gather_forward.launches, GB.gather_backward_fused.launches,
          GB.gather_backward_twopass.launches)
    kernel_bwd = not grad_geometry
    assert n1 == (n0[0] + 2, n0[1] + 2 * (kernel_bwd and mode == "fused"),
                  n0[2] + 2 * (kernel_bwd and mode == "twopass"))
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)
        _close(a.cpu(), c)


def test_default_route_on_card_matches_cpu(dev):
    """PhotonBeamConfig's defaults (gather="auto", grad_geometry=True) take
    the non-packed route: the forward kernel launches, the packed route is
    never called, and the image agrees with the CPU's."""
    W = 32
    cfg = PhotonBeamConfig(iterations=1, maxdepth=5, photonsperiteration=4000,
                           initialbeamradius=0.12, alpha=0.7)
    imgs = []
    n0 = (G.gather_forward.launches, BG.gather_beams_packed.calls,
          BG.gather_beams_bruteforce.calls)
    for d in (dev, torch.device("cpu")):
        cam = make_perspective_camera(
            tfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, W, W,
            device=d)
        img, _ = render_photonbeam(_cornell(d), cam, W, W, cfg)
        imgs.append(img.cpu())
    assert G.gather_forward.launches > n0[0]
    assert BG.gather_beams_packed.calls == n0[1]
    assert BG.gather_beams_bruteforce.calls > n0[2]
    assert bool(torch.isfinite(imgs[0]).all()) and float(imgs[1].mean()) > 0
    rel = float((imgs[0].mean() / imgs[1].mean() - 1).abs())
    assert rel < 1e-3, rel


def _recorded_sweeps(monkeypatch, scene, cam, W, cfg):
    """The arguments of every packed gather sweep of one render."""
    from bre_tpu_torch.integrators import photonbeam as PB
    calls = []
    real = PB.gather_beams_packed

    def record(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    with monkeypatch.context() as m:
        m.setattr(PB, "gather_beams_packed", record)
        render_photonbeam(scene, cam, W, W, cfg)
    return calls


@pytest.mark.parametrize("case", ["cornell", "hetero"])
def test_ray_order_keeps_the_packed_forward_bits(dev, case, monkeypatch):
    """Every sweep of one iteration at config 2's shapes (256^2, 1M
    photons) and config 3's (the grid smoke, 512^2, 100k photons; the
    HETERO kernels): ``gather_beams_packed``, which sorts the rays by
    position before the pack and the cull, equals bit for bit
    ``_packed_forward`` on the same rays in row order with the mask that
    ``_block_overlap_mask`` builds for that order."""
    hetero = case == "hetero"
    W = 512 if hetero else 256
    cfg = PhotonBeamConfig(
        iterations=1, maxdepth=5,
        photonsperiteration=100_000 if hetero else 1_000_000,
        initialbeamradius=0.15 if hetero else 0.12,
        alpha=0.5 if hetero else 0.7, gather="auto", grad_geometry=False)
    scene = _smoke(dev, n=32) if hetero else _cornell(dev)
    cam = make_perspective_camera(
        tfm.look_at(*(((0, 0, -3.2), (0, 0, 0)) if hetero
                      else ((0, 0, -2.2), (0, 0, 1))), (0, 1, 0)),
        50.0, W, W, device=dev)
    calls = _recorded_sweeps(monkeypatch, scene, cam, W, cfg)
    assert len(calls) >= 2 and any(a[3].shape[0] > BG.TILE for a, _ in calls)
    with torch.no_grad():
        for a, kw in calls:
            bp, nv, media, a0, a1, sd, med, tr, rad = a
            assert (bp.shape[1] > G.NB) == hetero
            got = BG.gather_beams_packed(*a, **kw)
            seg = BG._sweep_rows(media, a0, a1, sd, med, tr,
                                 kw["power_scale"], hetero)
            rp, sc, mask = BG._pack_sweep(bp, nv, seg, rad,
                                          kw["power_scale"], 0.05)
            want, _ = BG._packed_forward(bp, rp, sc, mask,
                                         kw.get("sparse_cap", 0))
            assert float(want.abs().max()) > 0
            assert torch.equal(got, want[:a0.shape[0]]), a0.shape[0]


def test_gather_gradient_on_card(dev):
    """On CUDA tensors the packed gather's output carries a grad_fn and its
    gradients (through the backward kernels) equal the CPU ones (through
    the plain versions) within the backward criterion."""
    rs = np.random.RandomState(4)
    B, R = 3000, 700
    beams_np = dict(
        start=rs.uniform(-1, 1, (B, 3)), end=rs.uniform(-1, 1, (B, 3)),
        power_start=rs.uniform(0.5, 2, (B, 3)),
        power_end=rs.uniform(0.05, 0.5, (B, 3)), radius=np.full(B, 0.2))
    a0 = rs.uniform(-2, -1, (R, 3))
    a1 = rs.uniform(1, 2, (R, 3))
    seg = dict(a0=a0, a1=a1, dir=(a1 - a0) / np.linalg.norm(
        a1 - a0, axis=-1, keepdims=True), tr=rs.uniform(0.2, 0.9, (R, 3)))
    grads = []
    for d in (dev, torch.device("cpu")):
        f = {k: torch.tensor(v, dtype=torch.float32, device=d)
             for k, v in {**beams_np, **seg}.items()}
        leaves = [f[k].requires_grad_() for k in
                  ("power_start", "power_end", "tr")]
        beams = Beams(start=f["start"], end=f["end"],
                      power_start=f["power_start"], power_end=f["power_end"],
                      radius=f["radius"],
                      medium=torch.zeros(B, dtype=torch.int64, device=d),
                      valid=torch.ones(B, dtype=torch.bool, device=d))
        scene = _cornell(d)
        sig = scene.media.sigma_s.detach().clone().requires_grad_()
        bp, nv = BG.pack_beams_compact(beams)
        out = BG.gather_beams_packed(
            bp, nv, scene.media._replace(sigma_s=sig), f["a0"], f["a1"],
            f["dir"], torch.zeros(R, dtype=torch.int64, device=d), f["tr"],
            0.2, power_scale=1e-3, sparse_cap=4096 if d.type == "cuda" else 0)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad(out.sum(), leaves + [sig]))
    for g_card, g_cpu in zip(*grads):
        _close(g_card.cpu(), g_cpu)


def _het_inputs(dev, n_tiles=8, n_chunks=40, seed=0):
    """Hetero packed inputs: _inputs' rows plus polynomial tables from the
    fit maps applied to positive node tables (a few all-zero density
    rows), the kernels' NF_HET / NB_HET layouts."""
    rays, beams, scal, mask = (x.cpu().numpy() for x in
                               _inputs("cpu", n_tiles, n_chunks, seed))
    rs = np.random.RandomState(seed + 11)
    MD, MN = BG._fit_matrices(BG.HETERO_NODES)
    K, T, C = BG.HETERO_NODES, 256, 256
    dk_r = rs.uniform(0, 0.4, (n_tiles, T, K)).astype(np.float32)
    dens_r = rs.uniform(0, 1.5, (n_tiles, T, K)).astype(np.float32)
    dens_r[:, :20] = 0.0
    dk_b = rs.uniform(0, 0.4, (n_chunks, C, K)).astype(np.float32)
    rays_h = np.concatenate([
        rays, (dk_r @ MD.T).transpose(0, 2, 1),
        rs.uniform(0.3, 1.5, (n_tiles, 3, T)).astype(np.float32),
        (dens_r @ MN.T).transpose(0, 2, 1)], 1)
    rays_h[:, G.RF_SIGS:G.RF_SIGS + 3] *= 40.0
    beams_h = np.concatenate([
        beams, (dk_b @ MD.T).transpose(0, 2, 1),
        rs.uniform(0.3, 1.5, (n_chunks, 3, C)).astype(np.float32)], 1)
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in (rays_h, beams_h, scal, mask)]


def test_hetero_kernels_match_plain_versions(dev):
    rays, beams, scal, mask = _het_inputs(dev)
    n0 = (G.gather_forward.launches_het, G.gather_sparse.launches_het,
          G.gather_forward.launches)
    dense = G.gather_forward(rays, beams, scal, mask)
    idx, _ = G.sparse_block_ids(mask, int(mask.sum()))
    sparse = G.gather_sparse(rays, beams, scal, idx)
    torch.cuda.synchronize()
    assert (G.gather_forward.launches_het, G.gather_sparse.launches_het,
            G.gather_forward.launches) == (n0[0] + 1, n0[1] + 1, n0[2])
    ref = G.gather_forward_ref(rays, beams, scal, mask)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(dense, ref, rtol=2e-4, atol=1e-8)
    torch.testing.assert_close(sparse, G.gather_sparse_ref(rays, beams, scal, idx),
                               rtol=2e-4, atol=1e-8)
    assert torch.equal(dense, sparse)
    assert torch.equal(dense, G.gather_forward(rays, beams, scal, mask))


@pytest.mark.parametrize("want_extras", [True, False])
def test_hetero_backward_kernels_match_plain_versions(dev, want_extras):
    rays, beams, scal, mask = _het_inputs(dev)
    ct = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (rays.shape[0], GB.NDR, 256)).astype(np.float32)).to(dev)
    ct[:, 3:] = 0.0
    n0 = GB.gather_backward_fused.launches_het
    out = GB.gather_backward_fused(rays, beams, scal, ct, mask, want_extras)
    torch.cuda.synchronize()
    assert GB.gather_backward_fused.launches_het == n0 + 1
    assert out[0].shape == (rays.shape[0], GB.NDR_HET, 256)
    assert out[1].shape == beams.shape
    ref = GB.gather_backward_fused_ref(rays, beams, scal, ct, mask, want_extras)
    for o, r, rows in zip(out, ref, (GB.D_RAYS_ROWS_HET, GB.D_BEAMS_ROWS_HET)):
        for name, sl in rows.items():
            err = float((o[:, sl] - r[:, sl]).abs().max())
            r_max = float(r[:, sl].abs().max())
            assert err <= 2e-4 * (r_max + 1e-9), (name, err, r_max)
            if name not in ("g", "cam_radius", "radius"):
                assert r_max > 0, name
    other = torch.ones(G.NB_HET, dtype=torch.bool, device=dev)
    for sl in GB.D_BEAMS_ROWS_HET.values():
        other[sl] = False
    assert float(out[1][:, other].abs().max()) == 0.0
    assert float(out[0][:, GB.DR_TR:GB.DR_TR + 3].abs().max()) == 0.0
    assert (float(out[0][:, GB.DR_G].abs().max()) > 0) == want_extras
    for a, b in zip(out, GB.gather_backward_fused(rays, beams, scal, ct, mask,
                                                  want_extras)):
        assert torch.equal(a, b)  # deterministic


def _smoke(dev, n=16):
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    dens = np.exp(-2.0 * (x**2 + 2 * y**2 + z**2))
    dens *= 1.0 + 0.5 * np.sin(4 * x) * np.cos(3 * z)
    b = SceneBuilder()
    w2m = np.array([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5], [0, 0, 0.5, 0.5],
                    [0, 0, 0, 1]], np.float32)
    smoke = b.grid_medium(np.clip(dens, 0, None).astype(np.float32), w2m,
                          sigma_a=(0.02,) * 3, sigma_s=(0.6,) * 3, g=0.4)
    wall = b.matte((0.5, 0.5, 0.6))
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=smoke,
          medium_outside=-1)
    b.quad((-4, -4, 2.5), (-4, 4, 2.5), (4, 4, 2.5), (4, -4, 2.5),
           material=wall)
    b.point_light((0.0, 0.8, -0.5), (2.0, 1.9, 1.7), medium=smoke)
    return b.build(device=dev)


def test_hetero_render_on_card_matches_cpu(dev):
    W = 32
    cfg = PhotonBeamConfig(iterations=1, maxdepth=5, photonsperiteration=3000,
                           initialbeamradius=0.15, gather="pallas",
                           grad_geometry=False, grad_extras=False)
    imgs = []
    n0 = G.gather_forward.launches_het + G.gather_sparse.launches_het
    for d in (dev, torch.device("cpu")):
        cam = make_perspective_camera(
            tfm.look_at((0, 0, -3.2), (0, 0, 0), (0, 1, 0)), 50.0, W, W,
            device=d)
        img, _ = render_photonbeam(_smoke(d), cam, W, W, cfg)
        imgs.append(img.cpu())
    assert G.gather_forward.launches_het + G.gather_sparse.launches_het > n0
    assert bool(torch.isfinite(imgs[0]).all()) and float(imgs[1].mean()) > 0
    rel = float((imgs[0].mean() / imgs[1].mean() - 1).abs())
    assert rel < 1e-3, rel


def test_grid_density_gradient_on_card(dev):
    """The density lookup's backward (a sorted segment sum per table row)
    repeats bit for bit on the card and agrees with the CPU's."""
    from bre_tpu_torch.media import grid_density
    rs = np.random.RandomState(5)
    dens = rs.uniform(0, 1, (32, 32, 32)).astype(np.float32)
    p = rs.uniform(-0.1, 1.1, (200_000, 3)).astype(np.float32)
    w = rs.uniform(-1, 1, p.shape[0]).astype(np.float32)
    grads = []
    for d in (dev, dev, torch.device("cpu")):
        dd = torch.from_numpy(dens).to(d).requires_grad_()
        out = (grid_density(dd, torch.from_numpy(p).to(d))
               * torch.from_numpy(w).to(d)).sum()
        grads.append(torch.autograd.grad(out, dd)[0].cpu())
    assert torch.equal(grads[0], grads[1])
    _close(grads[0], grads[2])


def _pixels_close(a, b):
    """The CPU parity tests' per-pixel check: 99% of the pixels within
    rtol 1e-3, atol 1e-6 in every channel."""
    close = np.isclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("grid", [False, True])
def test_compat_render_on_card_matches_cpu(dev, grid):
    """kernel="compat" on the card (the plain chunk scan there too: no
    kernel launches) against the CPU, same seeds: the compat trace's
    integer statistics, the image mean within 1e-3 and 99% of the pixels
    within rtol 1e-3."""
    W = 32
    cfg = PhotonBeamConfig(iterations=2, maxdepth=4, photonsperiteration=3000,
                           initialbeamradius=0.2, kernel="compat")
    make = _smoke if grid else _cornell
    look = ((0, 0, -3.2), (0, 0, 0)) if grid else ((0, 0, -2.2), (0, 0, 1))
    n0 = G.gather_forward.launches + G.gather_forward.launches_het
    out = []
    for d in (dev, torch.device("cpu")):
        cam = make_perspective_camera(tfm.look_at(*look, (0, 1, 0)), 50.0, W,
                                      W, device=d)
        img, st = render_photonbeam(make(d), cam, W, W, cfg)
        out.append((img.cpu(), st))
    assert G.gather_forward.launches + G.gather_forward.launches_het == n0
    (img_c, st_c), (img_h, st_h) = out
    assert bool(torch.isfinite(img_c).all()) and float(img_h.mean()) > 0
    rel = float((img_c.mean() / img_h.mean() - 1).abs())
    assert rel < 1e-3, rel
    _pixels_close(img_c, img_h)
    for k in ("photon_paths", "n_beams", "n_medium_scatter"):
        assert abs(st_c[k] - st_h[k]) <= 1e-3 * st_h[k], k


def test_golden_gates_on_card(dev):
    """tests/test_torch_reference_golden.py's two gates, on the card."""
    from test_torch_reference_golden import fog_gate, smoke_gate

    fog_gate(dev)
    smoke_gate(dev)


def test_volpath_on_card_matches_cpu(dev):
    """render_volpath on the card against the CPU, same seeds, the grid
    scene (fixed-trip tracking) and the two-sample MIS: image mean within
    1e-3 and 99% of the pixels within rtol 1e-3."""
    from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath

    W = 16
    imgs = []
    for d in (dev, torch.device("cpu")):
        cam = make_perspective_camera(
            tfm.look_at((0, 0, -3.2), (0, 0, 0), (0, 1, 0)), 50.0, W, W,
            device=d)
        imgs.append(render_volpath(_smoke(d), cam, W, W, VolPathConfig(
            maxdepth=5, spp=8, nee_mis=True)).cpu())
    assert bool(torch.isfinite(imgs[0]).all()) and float(imgs[1].mean()) > 0
    rel = float((imgs[0].mean() / imgs[1].mean() - 1).abs())
    assert rel < 1e-3, rel
    _pixels_close(imgs[0], imgs[1])


def test_gather_core_refuses_compat_on_card(dev):
    """The forward kernel computes the normalized estimate only: given
    KERNEL_COMPAT with the kernel backend, _GatherCore raises before any
    launch."""
    R, C = 16, 256
    rs = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(rs.rand(*s).astype(np.float32)).to(dev)  # noqa: E731
    pb = dict(start=f(C, 3), end=f(C, 3), power_start=f(C, 3),
              power_end=f(C, 3), radius=f(C), valid_f=torch.ones(C, device=dev))
    seg = dict(a0=f(R, 3), a1=f(R, 3), dir=f(R, 3), len=f(R), tr_full=f(R, 3),
               sigma_s=f(R, 3), g=f(R), in_med_f=torch.ones(R, device=dev),
               cam_radius=torch.tensor(0.1, device=dev),
               n_valid_beams=torch.tensor(float(C), device=dev))
    cfg = BG._Cfg(BG.KERNEL_COMPAT, C, 1, 1.0, 0.05, True, True, "pallas")
    n0 = G.gather_forward.launches
    with pytest.raises(ValueError, match="KERNEL_BRE"):
        BG._GatherCore.apply(cfg, tuple(pb), tuple(seg), *pb.values(),
                             *seg.values())
    assert G.gather_forward.launches == n0


@pytest.mark.parametrize("kernel", ["compat", "physical"])
def test_vsppm_on_card_matches_cpu(dev, kernel):
    """render_vsppm on the card against the CPU, the vsppm golden scene at
    32x32, 2 iterations of 2,000 photons: the statistics within 1e-3, the
    image mean within 1e-3 and 99% of the pixels within rtol 1e-3 (the
    CUDA vs CPU bound of the photon-beam renders above)."""
    from test_torch_vsppm_golden import DATA
    from bre_tpu_torch.integrators.vsppm import VSPPMConfig, render_vsppm
    from bre_tpu_torch.scene.parser import parse_file

    out = []
    for d in (dev, torch.device("cpu")):
        ps = parse_file(str(DATA / "vsppm_golden.pbrt"), device=d)
        out.append(render_vsppm(ps.build(device=d), ps.camera, 32, 32,
                                VSPPMConfig(iterations=2, maxdepth=3,
                                            photonsperiteration=2000,
                                            radius=0.25, kernel=kernel)))
    (img_c, st_c), (img_h, st_h) = out
    img_c = img_c.cpu()
    assert bool(torch.isfinite(img_c).all()) and float(img_h.mean()) > 0
    rel = float((img_c.mean() / img_h.mean() - 1).abs())
    assert rel < 1e-3, rel
    _pixels_close(img_c, img_h)
    for k in st_h:
        assert abs(st_c[k] - st_h[k]) <= 1e-3 * max(st_h[k], 1), k


def test_vsppm_golden_gate_on_card(dev):
    """tests/test_torch_vsppm_golden.py's 32-iteration gate, on the card."""
    from test_torch_vsppm_golden import vsppm_gate

    vsppm_gate(dev, 32)


def test_sample_streams_on_card_match_cpu(dev):
    """Every sampler kind's camera sample and 40 more dimensions on the
    card, bit for bit the CPU's (uint32 arithmetic in int64 tensors)."""
    from bre_tpu_torch.core import samplers as S
    from bre_tpu_torch.core.rng import pcg32_init

    W, H, R = 9, 5, 45
    for kind in S.KINDS:
        vals = []
        for d in (dev, torch.device("cpu")):
            pix = torch.arange(R, device=d).repeat(3)
            samp = torch.tensor([0, 7, 1000], device=d).repeat_interleave(R)
            s = S.make_sample_stream(S.make_stream_spec(kind, W, H, 16), pix,
                                     pix % W, pix // W, samp,
                                     pcg32_init(samp * R + pix))
            s, film, time, lens = S.stream_camera_sample(s)
            row = [film, time[:, None], lens]
            for k in range(40):
                s, v = (S.stream_2d if k % 2 else S.stream_1d)(s)
                row.append(v.reshape(3 * R, -1))
            vals.append(torch.cat(row, 1).cpu())
        assert torch.equal(vals[0], vals[1]), kind


def test_photonmap_and_spatial_volpath_on_card_match_cpu(dev):
    """render_photonmap (fog cube, 16x16, 4,000 photons) and render_volpath
    with the halton sampler and the spatial strategy (Cornell fog, 16x16, 4
    spp) on the card against the CPU: photon counts equal, image means
    within 1e-3, 99% of the pixels within rtol 1e-3."""
    from bre_tpu_torch.integrators.photonmap import (PhotonMapConfig,
                                                     render_photonmap)
    from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath

    W = 16
    pm, vp = [], []
    for d in (dev, torch.device("cpu")):
        cam = make_perspective_camera(
            tfm.look_at((0, 0, -3.5), (0, 0, 0), (0, 1, 0)), 40.0, W, W,
            device=d)
        b = SceneBuilder()
        fog = b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.0)
        b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
              medium_outside=-1)
        b.point_light((0.0, 0.0, 0.0), (1.0,) * 3, medium=fog)
        img, st = render_photonmap(b.build(device=d), cam, W, W,
                                   PhotonMapConfig(nphotons=4000, spp=2))
        pm.append((img.cpu(), st))
        cam = make_perspective_camera(
            tfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, W, W,
            device=d)
        scene = _cornell(d, point_light=True)
        vp.append(render_volpath(scene, cam, W, W, VolPathConfig(
            spp=4, sampler="halton", lightsamplestrategy="spatial")).cpu())
    assert pm[0][1] == pm[1][1]
    for a, b in ((pm[0][0], pm[1][0]), (vp[0], vp[1])):
        assert bool(torch.isfinite(a).all()) and float(b.mean()) > 0
        assert float((a.mean() / b.mean() - 1).abs()) < 1e-3
        _pixels_close(a, b)


def _region_means(img):
    return img.reshape(4, img.shape[0] // 4, 4, img.shape[1] // 4,
                       3).mean((1, 3))


def test_bdpt_and_mlt_on_card_match_cpu(dev, monkeypatch):
    """render_bdpt (the fog shell lit by a sphere light, 16x16, 4 spp,
    maxdepth 3) and render_mlt (the sphere lit by a point light, 16x16,
    maxdepth 3, 256 bootstrap samples, 32 chains, 4 mutations per pixel;
    and the fog shell at 2 mutations per pixel, whose graph holds the
    medium vertices) on the card against the CPU, same seeds: the means
    within 1e-3, the 4x4 region means within rtol 1e-3 (a splat near a
    pixel edge may land in the neighbouring pixel), 99% of the pixels
    within rtol 1e-3; two card runs of each give the same bits (the
    sorted-segment splats), and MLT's CUDA-graph chain steps the bits of
    its eager steps."""
    from bre_tpu_torch.integrators import mlt as ML
    from bre_tpu_torch.integrators.bdpt import BDPTConfig, render_bdpt
    from bre_tpu_torch.integrators.mlt import MLTConfig, render_mlt

    W = 16

    def fog(d):
        b = SceneBuilder()
        med = b.homogeneous_medium((0.1,) * 3, (0.6,) * 3, 0.0)
        m = b.matte((0.5, 0.5, 0.5))
        b.sphere((0, 0, 0), 1.0, material=m, medium_inside=med)
        b.area_light_sphere((0.0, 0.4, 0.5), 0.15, (4.0,) * 3, material=m,
                            two_sided=True, medium=med)
        b.camera_medium = med
        return b.build(device=d)

    def point(d):
        b = SceneBuilder()
        b.sphere((0, 0, 0), 1.0, material=b.matte((0.5, 0.5, 0.5)))
        b.point_light((0, 0, 0), (np.pi,) * 3)
        return b.build(device=d)

    runs = {"bdpt": (fog, lambda s, c: render_bdpt(
        s, c, W, W, BDPTConfig(maxdepth=3, spp=4))),
        "mlt": (point, lambda s, c: render_mlt(
            s, c, W, W, MLTConfig(maxdepth=3, bootstrapsamples=256,
                                  chains=32, mutationsperpixel=4))),
        "mlt_fog": (fog, lambda s, c: render_mlt(
            s, c, W, W, MLTConfig(maxdepth=3, bootstrapsamples=256,
                                  chains=32, mutationsperpixel=2)))}
    cards = {}
    for name, (build, render) in runs.items():
        out = []
        for d in (dev, dev, torch.device("cpu")):
            cam = make_perspective_camera(tfm.look_at((0, 0, 0), (0, 0, 1),
                                                      (0, 1, 0)), 60.0, W, W,
                                          device=d)
            out.append(render(build(d), cam).cpu())
        card, again, cpu = out
        assert torch.equal(card, again), name
        assert bool(torch.isfinite(card).all()) and float(cpu.mean()) > 0
        assert float((card.mean() / cpu.mean() - 1).abs()) < 1e-3, name
        np.testing.assert_allclose(_region_means(card.numpy()),
                                   _region_means(cpu.numpy()), rtol=1e-3,
                                   atol=1e-7, err_msg=name)
        _pixels_close(card, cpu)
        cards[name] = card

    def eager_steps(scene, camera, w, h, depth, maxdepth, pmf, n_dims):
        return lambda u, rng: ML._evaluate(scene, camera, w, h, u, depth,
                                           rng, maxdepth, pmf)

    # the graph replays the eager step's kernels in their order
    monkeypatch.setattr(ML, "_step_evaluator", eager_steps)
    cam = make_perspective_camera(tfm.look_at((0, 0, 0), (0, 0, 1),
                                              (0, 1, 0)), 60.0, W, W,
                                  device=dev)
    for name in ("mlt", "mlt_fog"):
        build, render = runs[name]
        assert torch.equal(render(build(dev), cam).cpu(), cards[name]), name


def test_other_lights_on_card_match_cpu(dev, monkeypatch):
    """The spot, goniometric, projection, distant and image-mapped infinite
    lights (torch_parity.lit_fog_box with all five) on the card against
    the CPU, same seeds: sample_le, sample_li and pdf_le of every light at
    2^16 lanes within rtol 1e-5 (atol 1e-5 x the largest magnitude); the
    photon-beam render at 32x32 on both routes (the packed one with the
    sparse cap at the block grid), volpath with MIS and bdpt at 16x16:
    means within 1e-3, 99% of pixels within rtol 1e-3; MLT's CUDA-graph
    chain step the bits of its eager steps."""
    from torch_parity import lit_fog_box
    from bre_tpu_torch import lights as TL
    from bre_tpu_torch.integrators import mlt as ML
    from bre_tpu_torch.integrators.bdpt import BDPTConfig, render_bdpt
    from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath

    kinds = ("spot", "goniometric", "projection", "distant", "envmap")
    devs = (dev, torch.device("cpu"))
    scenes = [lit_fog_box(SceneBuilder(), kinds, device=d) for d in devs]
    n = 1 << 16
    rs = np.random.RandomState(31)
    li = torch.from_numpy(rs.randint(0, scenes[1].n_lights, n))
    u1, u2 = (torch.from_numpy(rs.rand(n, 2).astype(np.float32))
              for _ in range(2))
    p = torch.from_numpy(rs.uniform([-0.9, -0.9, 0.1], [0.9, 0.9, 1.9],
                                    (n, 3)).astype(np.float32))
    outs = []
    for d, sc in zip(devs, scenes):
        le = TL.sample_le(sc, li.to(d), u1.to(d), u2.to(d))
        ls = TL.sample_li(sc, li.to(d), p.to(d), u1.to(d))
        pe = TL.pdf_le(sc, li.to(d), le.n_light, le.d)
        outs.append([x.cpu() for x in (*le[:6], *ls, *pe)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))

    def cam(d, w):
        return make_perspective_camera(
            tfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, w, w,
            device=d)

    runs = {"photonbeam": (32, lambda s, c, w: render_photonbeam(
        s, c, w, w, PhotonBeamConfig(iterations=1, maxdepth=5,
                                     photonsperiteration=4000,
                                     initialbeamradius=0.15))[0]),
        "photonbeam_packed": (32, lambda s, c, w: render_photonbeam(
            s, c, w, w, PhotonBeamConfig(
                iterations=1, maxdepth=5, photonsperiteration=4000,
                initialbeamradius=0.15, grad_geometry=False,
                gather_sparse_cap=-(-4000 * 7 // BG.CHUNK)
                * (w * w // BG.TILE)))[0]),
        "volpath": (16, lambda s, c, w: render_volpath(
            s, c, w, w, VolPathConfig(maxdepth=5, spp=4, nee_mis=True,
                                      lightsamplestrategy="spatial"))),
        "bdpt": (16, lambda s, c, w: render_bdpt(
            s, c, w, w, BDPTConfig(maxdepth=3, spp=4)))}
    for name, (w, render) in runs.items():
        card, host = (render(sc, cam(d, w), w).cpu()
                      for d, sc in zip(devs, scenes))
        assert bool(torch.isfinite(card).all()) and float(host.mean()) > 0
        assert float((card.mean() / host.mean() - 1).abs()) < 1e-3, name
        _pixels_close(card, host)

    mcfg = ML.MLTConfig(maxdepth=3, bootstrapsamples=256, chains=32,
                        mutationsperpixel=2)
    graphed = ML.render_mlt(scenes[0], cam(dev, 16), 16, 16, mcfg).cpu()

    def eager_steps(scene, camera, w, h, depth, maxdepth, pmf, n_dims):
        return lambda u, rng: ML._evaluate(scene, camera, w, h, u, depth,
                                           rng, maxdepth, pmf)

    monkeypatch.setattr(ML, "_step_evaluator", eager_steps)
    eager = ML.render_mlt(scenes[0], cam(dev, 16), 16, 16, mcfg).cpu()
    assert float(graphed.mean()) > 0 and torch.equal(graphed, eager)


@pytest.mark.parametrize("bvh", [True, False])
def test_large_scene_queries_on_card_match_cpu(dev, bvh, monkeypatch):
    """The tri-BVH walk (on the card a CUDA graph per TRIPS_PER_READ trips,
    on the CPU an eager loop dropping finished lanes) and the chunked sweep
    (a chunk forced small) give the same winners, t and occlusion on the
    card as on the CPU, on a 50 x 50 heightfield with a material-less box
    (4,814 triangles)."""
    from bre_tpu_torch.scene import builder as B
    from bre_tpu_torch.scene import intersect as I

    monkeypatch.setattr(B, "BVH_MIN_TRIANGLES", 1000 if bvh else 1 << 40)
    monkeypatch.setattr(I, "SWEEP_ELEMENTS", 4096 * 512)
    rs = np.random.RandomState(5)
    z = 0.3 * rs.rand(50, 50).astype(np.float32)
    built = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        b = SceneBuilder()
        m = b.matte((0.5, 0.5, 0.5))
        b.heightfield(z, (-1, -1, 0), (2, 2), material=m)
        b.box((-1.5, -1.5, -1), (1.5, 1.5, 1), material=-1)
        built[name] = b.build(device=d)
    assert (built["cuda"].tri_bvh is not None) == bvh
    n = 4096
    o = rs.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    o[:, 2] = rs.uniform(0.4, 0.9, n)
    dv = rs.normal(size=(n, 3)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    tm = rs.uniform(0.2, 3.0, n).astype(np.float32)
    out = {}
    for name, sc in built.items():
        args = [torch.from_numpy(x).to(sc.device) for x in (o, dv, tm)]
        h = I.intersect(sc, args[0], args[1])
        occ = I.intersect_p(sc, *args)
        out[name] = [x.cpu() for x in (h.valid, h.prim_index, h.t, occ)]
    (vc, ic, tc, oc), (vh, ih, th, oh) = out["cuda"], out["cpu"]
    field = vh & (ih < 2 * 49 * 49)  # the box's 12 triangles come last
    assert 0.1 < float(field.float().mean()) < 1.0
    assert torch.equal(vc, vh) and torch.equal(ic[vh], ih[vh])
    torch.testing.assert_close(tc[vh], th[vh], rtol=4 * 2.0 ** -23, atol=0)
    assert torch.equal(oc, oh)


def test_lbvh_gather_on_card_matches_cpu(dev):
    """gather="lbvh" renders the fog box on the card as on the CPU."""
    imgs = []
    for d in (dev, torch.device("cpu")):
        cam = make_perspective_camera(
            tfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, 32, 32,
            device=d)
        cfg = PhotonBeamConfig(iterations=1, maxdepth=5,
                               photonsperiteration=1500,
                               initialbeamradius=0.12, gather="lbvh",
                               tile=64)
        img, stats = render_photonbeam(_cornell(d), cam, 32, 32, cfg)
        assert stats["lbvh_overflow"] == 0
        imgs.append(img.cpu())
    assert float(imgs[1].mean()) > 0
    assert abs(float(imgs[0].mean() / imgs[1].mean()) - 1) < 1e-3


def test_cameras_and_fiber_materials_on_card_match_cpu(dev):
    """Every camera kind's generate_rays (with lens samples) and the
    realistic camera's weighted rays (weights equal), the hair, Fourier
    and BSSRDF queries, card against CPU on the same inputs: rays atol
    2e-5, the BSDFs and profiles rtol 2e-3 / atol 1e-5 of the largest
    magnitude with at most 0.1% of the lanes further (tests/
    test_torch_hair.py's rule: the card's exp, log, asin and atan2 round in
    their own ways, and narrow hair lobes amplify them)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_parity import fiber_materials
    from bre_tpu_torch import bssrdf as TB
    from bre_tpu_torch import materials as TM
    from bre_tpu_torch.scene import camera as TC

    cpu = torch.device("cpu")
    rs = np.random.RandomState(16)
    n = 1 << 14
    W, H = 64, 48
    p = torch.from_numpy((rs.uniform(0, 1, (n, 2)) * (W, H)).astype(
        np.float32))
    u = torch.from_numpy(rs.uniform(0, 1, (n, 2)).astype(np.float32))
    c2w = tfm.look_at((0, 1, -3.9), (0, 1, 0), (0, 1, 0))
    rows = [[50.0, 5.0, 1.5, 30.0], [0.0, 2.0, 0.0, 6.0],
            [-50.0, 45.0, 1.0, 30.0]]
    makers = (
        lambda d: TC.make_perspective_camera(c2w, 40.0, W, H, 0.05, 3.0,
                                             device=d),
        lambda d: TC.make_orthographic_camera(c2w, W, H, device=d),
        lambda d: TC.make_environment_camera(c2w, W, H, device=d),
        lambda d: TC.make_realistic_camera(c2w, rows, W, H, 12.0, 3.9,
                                           device=d))
    for make in makers:
        outs = [TC.generate_rays_weighted(make(d), p.to(d), u.to(d))
                for d in (dev, cpu)]
        (oc, dc, wc), (oh, dh, wh) = ([x.cpu() for x in o] for o in outs)
        assert torch.equal(wc, wh)
        torch.testing.assert_close(oc, oh, rtol=0, atol=2e-5 * max(
            float(oh.abs().max()), 1.0))
        torch.testing.assert_close(dc, dh, rtol=0, atol=2e-5)

    def mostly(a, b):
        a, b = a.cpu(), b.cpu()
        tol = 1e-5 * max(float(b.abs().max()), 1e-30) + 2e-3 * b.abs()
        bad = (a - b).abs() > tol
        if bad.dim() == 2:
            bad = bad.any(-1)
        assert int(bad.sum()) <= b.shape[0] // 1000

    built = []
    for d in (dev, cpu):
        b = SceneBuilder()
        ids = fiber_materials(b)
        built.append(b.build(device=d))
    names = ("hair", "hair_rough", "fourier", "subsurface", "mix_of_mixes")
    mat = torch.from_numpy(np.asarray([ids[k] for k in names])[
        rs.randint(0, len(names), n)])
    nrm, wo, wi = (torch.nn.functional.normalize(torch.from_numpy(
        rs.normal(size=(n, 3)).astype(np.float32)), dim=-1) for _ in range(3))
    tan = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32))
    st = torch.from_numpy(rs.uniform(0.5, 20.0, (n, 3)).astype(np.float32))
    rho = st / st.amax()
    res = []
    for d, sc in zip((dev, cpu), built):
        m = sc.materials
        s_ = TM.sample_bsdf(m, mat.to(d), nrm.to(d), wo.to(d), u.to(d),
                            tangent=tan.to(d))
        f, pdf = TM.eval_bsdf(m, mat.to(d), nrm.to(d), wo.to(d), wi.to(d),
                              tangent=tan.to(d))
        tid = torch.zeros(n, dtype=torch.int64, device=d)
        res.append((s_.wi, s_.f, s_.pdf, f, pdf,
                    TB.bssrdf_sr(m.bss_tables, tid, st.to(d), rho.to(d),
                                 st[:, 0].to(d) * 0.01),
                    TB.bssrdf_sample_sr(m.bss_tables, tid, st[:, 1].to(d),
                                        rho[:, 1].to(d), u[:, 0].to(d))))
    for a, b in zip(*res):
        mostly(a, b)


def test_film_splat_on_card_same_bits_twice(dev):
    """film.add_samples of 2^16 samples into a 64x64 film with a width-2
    Gaussian: two runs on the card give the same bits (the splat is
    core.math.ordered_index_sum, no atomics), and the card is within rtol
    1e-5 of max|image| of the CPU."""
    from bre_tpu_torch import film as F

    rs = np.random.RandomState(38)
    n = 1 << 16
    p = torch.from_numpy(rs.uniform(-1, 65, (n, 2)).astype(np.float32))
    L = torch.from_numpy(rs.uniform(0, 2, (n, 3)).astype(np.float32))
    spec = F.FilterSpec("gaussian", 2.0, 2.0)

    def run(d):
        return F.add_samples(F.make_film(64, 64, device=d), p.to(d), L.to(d),
                             spec)
    a, b = run(dev), run(dev)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    host = run("cpu").image
    err = float((a.image.cpu() - host).abs().max())
    assert err <= 1e-5 * float(host.abs().max())


def test_ef_quadratic_on_card_same_bits_as_cpu(dev):
    """core.efloat.ef_quadratic on 2^16 lanes, some with subnormal
    operands: the card's bits are the CPU's (IEEE operations that neither
    device contracts or flushes; correctly rounded square roots)."""
    from bre_tpu_torch.core import efloat as E

    rs = np.random.RandomState(38)
    n = 1 << 16
    abc = rs.uniform(-4, 4, (3, n)).astype(np.float32)
    abc[0, ::97] = np.float32(3e-39) * rs.uniform(0.1, 1, abc[0, ::97].shape)
    abc[2, ::89] = np.float32(-2e-39)
    err = (np.abs(abc[0]) * 1e-6).astype(np.float32)

    def run(d):
        t = [torch.from_numpy(x).to(d) for x in (*abc, err)]
        return E.ef_quadratic(E.efloat(t[0], t[3]), E.efloat(t[1]),
                              E.efloat(t[2]))
    card, host = run(dev), run("cpu")
    assert torch.equal(card[0].cpu(), host[0])
    for x, y in zip(card[1] + card[2], host[1] + host[2]):
        assert torch.equal(x.cpu().view(torch.int32), y.view(torch.int32))
