"""bre_tpu_torch's multi-rank iteration and train step (parallel/mesh.py,
torch.distributed over gloo on the CPU) against bre_tpu's sharded ones on
the conftest's virtual CPU devices, at n = 2: __graft_entry__.
dryrun_multichip's config (16x16, 256 photons, maxdepth 3, radius 0.3,
gather_chunk 256, the default route with the geometry attached; depth_scan
as in tests/test_torch_train_step.py).  Both packages shard the same way
(photon ids and raster rows split by rank, the beams gathered rank-major),
so they differ only where test_torch_train_step.py's one-device step does.

Tolerances: those of tests/test_torch_train_step.py (loss within 0.5%, each
gradient within 2e-4 * max|ref|) and of its image comparison
(tests/test_torch_default_route.py ``_images_agree``).  Also: make_mesh
and initialize_distributed's refusals, and one rank in a process group
bit for bit the one-device mesh."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.lights import light_power_distribution as jdistr
from bre_tpu.parallel import mesh as jmesh
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu_torch.parallel import mesh as tmesh
from test_torch_default_route import GRAD_RTOL, _graft_scene, _images_agree
from torch_parity import to_np
from torch_mesh_worker import GRAFT_CFG, GRAFT_LOOK, PARAMS, run_ranks

LOSS_RTOL = 5e-3  # tests/test_torch_train_step.py


def jax_graft(n, width, height, cfg):
    """bre_tpu's sharded train step (target 0, iteration 0, the config's
    radius) and image over ``n`` of the conftest's virtual CPU devices."""
    js = _graft_scene(JBuilder(), 2)
    jc = jcam(jtfm.look_at(*GRAFT_LOOK), 45.0, width, height)
    radius = jnp.float32(cfg["initialbeamradius"])
    jcfg = jpb.PhotonBeamConfig(**cfg)
    mesh = jmesh.make_mesh(n)
    loss, grads = jmesh.make_inverse_train_step(js, jc, width, height, jcfg,
                                                mesh)(
        {k: getattr(js.media, k) for k in PARAMS},
        jnp.zeros((width * height, 3)), jnp.uint32(0), radius)
    run = jmesh.sharded_photonbeam_iteration(js, jc, width, height, jcfg,
                                             mesh, jdistr(js))
    return float(loss), {k: to_np(g) for k, g in grads.items()}, \
        to_np(run(jnp.uint32(0), radius))


def assert_step_matches(ranks, loss_j, grads_j):
    """Every rank holds the same loss and gradients, and they match JAX's."""
    for r in ranks:
        assert float(r["loss"]) == float(ranks[0]["loss"])
        for k in PARAMS:
            assert torch.equal(r["grads"][k], ranks[0]["grads"][k]), k
    assert abs(float(ranks[0]["loss"]) / loss_j - 1.0) < LOSS_RTOL
    for k in PARAMS:
        t, j = to_np(ranks[0]["grads"][k]), grads_j[k]
        assert np.isfinite(t).all(), k
        if k == "density":  # no grid medium: the scene never reads it
            assert np.abs(t).max() == 0.0 == np.abs(j).max()
            continue
        assert np.abs(j).max() > 0, k
        assert np.abs(t - j).max() <= GRAD_RTOL * np.abs(j).max(), (k, t, j)


@pytest.fixture(scope="module")
def n2():
    kw = dict(width=16, height=16, cfg=GRAFT_CFG)
    return run_ranks(2, "graft_step", kw), jax_graft(2, **kw)


def test_sharded_train_step_matches_jax_n2(n2):
    ranks, (loss_j, grads_j, _) = n2
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == 2 for r in ranks)
    assert_step_matches(ranks, loss_j, grads_j)


def test_sharded_image_matches_jax_n2(n2):
    ranks, (_, _, image_j) = n2
    assert torch.equal(ranks[0]["image"], ranks[1]["image"])
    _images_agree(ranks[0]["image"], image_j)


def test_one_rank_group_is_one_device_bit_for_bit():
    (r,) = run_ranks(1, "graft_step", dict(width=16, height=16,
                                           cfg=GRAFT_CFG, one_device=True))
    assert r["size"] == 1 and float(r["loss"]) > 0
    assert float(r["loss"]) == float(r["loss_1"])
    for k in PARAMS:
        assert torch.equal(r["grads"][k], r["grads_1"][k]), k
    assert torch.equal(r["image"], r["image_1"])


def test_rank_whose_rows_see_no_medium():
    """Looking below the fog box with surfaces off, rank 1's rows (the
    lower half) never enter a medium and never gather, so its image rows
    do not depend on the beams; its backward must still join the beams'
    reduce-scatter, and the step must still equal the one-device step."""
    ranks = run_ranks(2, "graft_step", dict(
        width=8, height=8, cfg=dict(GRAFT_CFG, rendersurfaces=False),
        one_device=True, look=((0, 0, -3.5), (0, -2.0, 0), (0, 1, 0))))
    image = ranks[0]["image"].reshape(8, 8, 3)
    assert bool((image[:3].abs().sum((1, 2)) > 0).all())
    assert not image[4:].any()
    for r in ranks:
        assert abs(float(r["loss"]) / float(r["loss_1"]) - 1.0) < 1e-4
        for k in ("sigma_a", "sigma_s"):
            g, g1 = r["grads"][k], r["grads_1"][k]
            assert float(g1.abs().max()) > 0, k
            assert float((g - g1).abs().max()) < 1e-3 * float(g1.abs().max())


@pytest.mark.parametrize("n", [2, 4])
def test_make_mesh_without_group_raises(n):
    with pytest.raises(ValueError, match="initialize_distributed"):
        tmesh.make_mesh(n)


def test_make_mesh_one_device():
    assert tmesh.make_mesh() == tmesh.make_mesh(1) == tmesh.Mesh()
    m = tmesh.Mesh()
    assert (m.group, m.rank, m.size, m.device) == (None, 0, 1, None)


def test_nccl_without_cards_raises():
    # this process sees no CUDA card: NCCL refuses before any group starts
    with pytest.raises(ValueError, match="NCCL needs one CUDA card per rank"):
        tmesh.initialize_distributed("localhost:1", 1, 0, backend="nccl")
    assert not torch.distributed.is_initialized()
