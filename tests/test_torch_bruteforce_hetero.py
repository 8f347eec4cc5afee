"""bre_tpu_torch non-packed gather route in a grid-density medium vs
bre_tpu: ``gather_beams_bruteforce`` with the beams' and segments'
polynomial tables built on every call, forward (``backend`` "xla" and
"pallas", and ``het_k`` 4, which takes the chunk scan) and its
geometry-attached gradients, the density grid among them, against
``jax.grad`` (tests/test_torch_bruteforce_hetero_grad.py).  Tolerances and
their reasons: those of tests/test_torch_bruteforce.py."""

import numpy as np
import pytest

from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu_torch.scene.scene import scene_from_jax
from test_torch_bruteforce import ATOL, RTOL, _gather_both
from test_torch_gather import _beams_np, _segments
from torch_parity import SMOKE_W2M, smoke_density, to_np


def _grid_scene():
    jb = JBuilder()
    jb.grid_medium(smoke_density(12), SMOKE_W2M, sigma_a=(0.05,) * 3,
                   sigma_s=(0.6,) * 3, g=0.3)
    jb.sphere((0, 0, 0), 5.0)
    js = jb.build()
    return js, scene_from_jax(js, device="cpu")


@pytest.mark.parametrize("backend,het_k", [("xla", 8), ("pallas", 8),
                                           ("pallas", 4)])
def test_forward_hetero_matches(backend, het_k):
    """Grid medium: the beams' and segments' tables on every call; het_k 4
    takes the chunk scan even with backend="pallas" (the kernels bake 8
    nodes)."""
    js, ts = _grid_scene()
    b = _beams_np(B=600, seed=5)
    a0, a1, sd, _, trf = _segments(R=260, seed=6)
    med = np.zeros(260, np.int32)
    med[::7] = -1
    t, j = _gather_both(js, ts, b, (a0, a1, sd, med, trf), chunk=256,
                        backend=backend, hetero=True, het_k=het_k)
    assert float(np.abs(to_np(j)).max()) > 0
    np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
