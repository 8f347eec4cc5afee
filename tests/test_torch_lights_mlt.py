"""One ``mlt._evaluate`` batch of bre_tpu_torch against bre_tpu's, on the
CPU: 64 chains at maxdepth 2 on the matte sphere lit by a distant light and
an env map of tests/test_torch_lights_bdpt.py (``torch_parity.env_sphere``).

Tolerances: tests/test_torch_mlt.py's (L and p_raster rtol 1e-3, atol
1e-5 x the largest value, as the strategies in tests/test_torch_bdpt.py).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from bre_tpu.core import rng as jrng
from bre_tpu.integrators import mlt as jm
from bre_tpu.lights import light_choice_pmf as j_pmf
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.integrators import mlt as tm
from bre_tpu_torch.lights import light_choice_pmf
from test_torch_lights_bdpt import WH, setup_scenes
from torch_parity import to_np


def test_mlt_evaluate_distant_and_env_map_matches_jax():
    ts, js, cam_t, cam_j = setup_scenes()
    maxdepth, C = 2, 64
    rs = np.random.RandomState(29)
    u = rs.rand(C, tm._n_dims(maxdepth)).astype(np.float32)
    depth = np.arange(C) % (maxdepth + 1)
    seq = np.arange(C) + 0x77E5
    L_t, p_t = tm._evaluate(ts, cam_t, WH, WH, torch.from_numpy(u),
                            torch.from_numpy(depth),
                            trng.pcg32_init(torch.from_numpy(seq)), maxdepth,
                            light_choice_pmf(ts))
    pmf_j = j_pmf(js)
    L_j, p_j = jax.jit(lambda u_, d_, r_: jm._evaluate(
        js, cam_j, WH, WH, u_, d_, r_, maxdepth, pmf_j))(
        jnp.asarray(u), jnp.asarray(depth, jnp.int32),
        jrng.pcg32_init(jnp.asarray(seq, jnp.uint32)))
    L_j, p_j = np.asarray(L_j), np.asarray(p_j)
    assert (np.abs(L_j).sum(-1) > 0).sum() >= 8
    for a, b, what in ((L_t, L_j, "L"), (p_t, p_j, "p_raster")):
        np.testing.assert_allclose(to_np(a), b, rtol=1e-3,
                                   atol=1e-5 * np.abs(b).max(), err_msg=what)
