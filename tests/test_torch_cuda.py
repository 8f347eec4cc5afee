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


def _cornell(dev):
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


def test_twopass_kernels_match_plain_version(dev):
    """Kernel 6 (``gather_backward_twopass``): every block of the grid, the
    extras always on, per cotangent against its plain version, and twice
    bit for bit (no atomics)."""
    rays, beams, scal, _ = _inputs(dev)
    ct = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (rays.shape[0], GB.NDR, 256)).astype(np.float32)).to(dev)
    ct[:, 3:] = 0.0
    n0 = GB.gather_backward_twopass.launches
    out = GB.gather_backward_twopass(rays, beams, scal, ct)
    torch.cuda.synchronize()
    assert GB.gather_backward_twopass.launches == n0 + 1
    ref = GB.gather_backward_twopass_ref(rays, beams, scal, ct)
    assert all(float(r.abs().max()) > 0 for r in ref)
    _close_by_cotangent(out, ref)
    for a, b in zip(out, GB.gather_backward_twopass(rays, beams, scal, ct)):
        assert torch.equal(a, b)
    # no dead-chunk skip: the chunk past n_valid has cotangents too
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
