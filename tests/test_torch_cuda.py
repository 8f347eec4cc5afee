"""bre_tpu_torch CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, not at import).  These tests import no
JAX, so on a CUDA machine without JAX they run from the repository root as
  python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
      tests/test_torch_cuda.py -q

Tolerances: kernel vs plain version rtol 2e-4 / atol 1e-8 (the reference's
Pallas tolerance, tests/test_pallas_gather.py:47; measured ~1e-6: the kernel
rounds every product and sum as the plain version does and only the sum
order and the math library's exp/log/rsqrt differ).  CUDA vs CPU image
means 1e-3: same PCG32 streams, float-ulp flips of a few photon decisions
at most."""

import numpy as np
import pytest
import torch

from bre_tpu_torch.core import transform as tfm
from bre_tpu_torch.integrators.photonbeam import PhotonBeamConfig, render_photonbeam
from bre_tpu_torch.ops import gather as G
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
