"""bre_tpu_torch non-packed gather route in a grid-density medium vs
bre_tpu: the geometry-attached gradients of ``gather_beams_bruteforce``
(backend "pallas", the recompute backward), the density grid among them,
against ``jax.grad``.  Tolerances and their reasons: those of
tests/test_torch_bruteforce.py."""

import numpy as np

from test_torch_bruteforce import GEOM, GEOM_RTOL, RTOL, _close_to_max, _grads_both
from test_torch_bruteforce_hetero import _grid_scene
from test_torch_gather import _beams_np, _segments
from torch_parity import to_np


def test_attached_gradients_hetero_match():
    """The same in a grid medium, the density grid among the cotangents
    (the tables chain it through nodes_to_poly and the trilinear lookup)."""
    js, ts = _grid_scene()
    b = _beams_np(B=500, seed=7)
    a0, a1, sd, _, trf = _segments(R=200, seed=8)
    med = np.zeros(200, np.int32)
    got = _grads_both(js, ts, b, (a0, a1, sd, med, trf), True, chunk=256,
                      backend="pallas")
    for name, (t, j) in got.items():
        if name in ("tr_full", "power_end"):
            # grid media read the tables, not tr_full nor power_end
            assert float(t.abs().max()) == 0.0 == float(np.abs(to_np(j)).max())
            continue
        assert float(np.abs(to_np(j)).max()) > 0, name
        _close_to_max(t, j, GEOM_RTOL if name in GEOM else RTOL)
