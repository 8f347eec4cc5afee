"""bre_tpu_torch's multi-rank train step at n = 4 gloo ranks on a shape that
neither count divides: 10x9 = 90 pixels (R_pad 92, the last rank's shard
ends in two zero rows) and 62 photons (rounded up to 64, 16 per rank),
against bre_tpu's sharded step at n = 4 on the conftest's virtual CPU
devices, on the packed route (tests/test_sharding.py's TINY_CFG: the
geometry detached, maxdepth 2, radius 0.4; depth_scan as in
tests/test_torch_train_step.py, which keeps the JAX compiles near 45 s);
tolerances as in tests/test_torch_mesh.py.  Also the port's
dryrun_multichip invariant (n ranks against one device: loss within 1e-4
relative, sigma_a gradient within 1e-3 * max|sigma_a grad|,
__graft_entry__.py:92-99) at n = 2 and 4, and a two-process
initialize_distributed over tcp:// (the counterpart of
tests/test_multihost.py)."""

import socket

import pytest
import torch

from bre_tpu_torch.parallel.dryrun import dryrun_multichip
from test_torch_default_route import _images_agree
from test_torch_mesh import assert_step_matches, jax_graft
from torch_mesh_worker import PARAMS, run_ranks

W, H = 10, 9
PAD_CFG = dict(maxdepth=2, photonsperiteration=62, initialbeamradius=0.4,
               gather_chunk=256, grad_geometry=False, depth_scan=True)


@pytest.fixture(scope="module")
def n4():
    kw = dict(width=W, height=H, cfg=PAD_CFG)
    return run_ranks(4, "graft_step", kw), jax_graft(4, **kw)


def test_padded_train_step_matches_jax_n4(n4):
    ranks, (loss_j, grads_j, _) = n4
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert_step_matches(ranks, loss_j, grads_j)


def test_padded_image_matches_jax_n4(n4):
    ranks, (_, _, image_j) = n4
    assert ranks[0]["image"].shape == (W * H, 3)
    assert all(torch.equal(r["image"], ranks[0]["image"]) for r in ranks)
    _images_agree(ranks[0]["image"], image_j)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_invariant(n):
    res = dryrun_multichip(n, device="cpu")
    assert res["n_devices"] == n and res["backend"] == "gloo"
    assert res["loss_rel"] < 1e-4 and res["grad_rel"]["sigma_a"] < 1e-3
    for k in PARAMS:  # reported beside sigma_a; the reference holds only it
        assert res["grad_rel"][k] < 1e-3, k


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_distributed_tcp_two_processes():
    ranks = run_ranks(2, "graft_step", dict(width=8, height=8, cfg=PAD_CFG,
                                            one_device=True),
                      init=f"localhost:{_free_port()}")
    assert [(r["rank"], r["size"]) for r in ranks] == [(0, 2), (1, 2)]
    for r in ranks:
        assert float(r["loss"]) == float(ranks[0]["loss"])
        assert abs(float(r["loss"]) / float(r["loss_1"]) - 1.0) < 1e-4
        g, g1 = r["grads"]["sigma_a"], r["grads_1"]["sigma_a"]
        assert float((g - g1).abs().max()) < 1e-3 * float(g1.abs().max())
