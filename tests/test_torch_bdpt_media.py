"""The reference's reuse of draws in bidirectional path tracing's segment
sampler, in bre_tpu_torch against bre_tpu, on the CPU: a point light in a
matte shell filled with a homogeneous medium or a grid medium, 64 rays
from its center through ``_segment_interaction`` in PCG mode.  The PCG32
states and the integer fields are exact; positions and weights within
rtol 1e-4 (as the vertices of tests/test_torch_bdpt.py).  The whole
render in fog is tests/test_torch_bdpt.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu.core import rng as jrng
from bre_tpu.integrators import bdpt as jb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.integrators import bdpt as tb
from bre_tpu_torch.scene.builder import SceneBuilder
from test_torch_bdpt import _close
from torch_parity import pcg_state, to_np


def _shell(b, grid, **build_kw):
    if grid:
        x = np.linspace(-1, 1, 8)
        dens = np.exp(-np.add.outer(np.add.outer(x * x, x * x), x * x))
        w2m = np.array([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5],
                        [0, 0, 0.5, 0.5], [0, 0, 0, 1]], np.float32)
        med = b.grid_medium(dens.astype(np.float32), w2m, sigma_a=(0.1,) * 3,
                            sigma_s=(0.8,) * 3)
    else:
        med = b.homogeneous_medium((0.1,) * 3, (0.8,) * 3, 0.0)
    b.sphere((0, 0, 0), 1.0, material=b.matte(), medium_inside=med)
    b.point_light((0, 0, 0), (1, 1, 1), medium=med)
    return b.build(**build_kw)


@pytest.mark.parametrize("grid", [False, True])
def test_segment_interaction_reuses_draws_as_the_reference(grid):
    """In PCG mode ``sample_medium`` gets the stream read before its two
    uniforms were drawn, and its result is stored: the draws are discarded.
    Without a grid the stream comes back unmoved; with one, moved by the
    fixed-trip tracking alone (2 x 256 draws per sub-segment).  bre_tpu
    (eagerly) leaves the same state and resolves the same segments."""
    R = 64
    rs = np.random.RandomState(11)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((R, 3), np.float32)
    seq = np.arange(R) + 1000
    ts = _shell(SceneBuilder(), grid, device="cpu")
    js = _shell(JBuilder(), grid)
    sp_t = tb.PathSampler(trng.pcg32_init(torch.from_numpy(seq)))
    it_t = tb._segment_interaction(ts, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.zeros(R, dtype=torch.int64),
                                   torch.ones(R, dtype=torch.bool), sp_t)
    sp_j = jb.PathSampler(jrng.pcg32_init(jnp.asarray(seq, jnp.uint32)))
    it_j = jb._segment_interaction(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.zeros(R, jnp.int32),
                                   jnp.ones(R, bool), sp_j)
    fresh = trng.pcg32_init(torch.from_numpy(seq))
    passes = tb._N_BOUNDARY_SKIPS + 1
    want = trng.pcg32_advance(fresh, 2 * 256 * passes) if grid else fresh
    assert torch.equal(sp_t.rng.state, want.state)
    np.testing.assert_array_equal(to_np(sp_t.rng.state), pcg_state(sp_j.rng))
    # the next draw is the fresh stream's first (without a grid)
    _, u_next = trng.pcg32_next_f32(sp_t.rng)
    _, u_first = trng.pcg32_next_f32(want)
    assert torch.equal(u_next, u_first)
    for k in ("kind", "mat", "med"):
        np.testing.assert_array_equal(to_np(it_t[k]), np.asarray(it_j[k]),
                                      err_msg=k)
    assert set(np.unique(np.asarray(it_j["kind"]))) == {1, 2}
    _close(it_t["p"], it_j["p"], "p")
    _close(it_t["weight"], it_j["weight"], "weight")
