"""vsppm in bre_tpu_torch against bre_tpu with ``kernel="physical"`` (the
volume kernel, depth-0 medium splats dropped, photons continuing through
medium scatters), on the CPU: the comparison of
tests/test_torch_vsppm.py, in a file of its own so that the two
packages' JAX compiles run on different pytest workers.  The same scene,
sizes and tolerances (statistics and M exact; images and Phi rtol 1e-5,
atol 1e-7, for the order of the K sum and XLA:CPU's contracted
multiply-adds).
"""

import pytest

from bre_tpu.integrators import vsppm as jv
from test_torch_vsppm import (CFG, assert_render_matches, golden_scenes,
                              phase_jitted_render, splat_gather_matches)


@pytest.fixture(scope="module")
def ref():
    scenes = golden_scenes()
    img, stats, splat = phase_jitted_render(
        scenes[0], scenes[1], jv.VSPPMConfig(kernel="physical", **CFG))
    return dict(scenes=scenes, img=img, stats=stats, splat=splat)


def test_vsppm_physical_matches_jax(ref):
    assert_render_matches("physical", ref)


def test_splat_gather_physical_matches_jax(ref):
    """The physical kernel drops depth-0 medium interactions from the
    gather."""
    splat_gather_matches(ref, "physical")
