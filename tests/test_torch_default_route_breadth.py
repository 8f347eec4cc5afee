"""bre_tpu_torch's non-packed route with its other options vs bre_tpu:
``render_photonbeam`` with gather="brute" (the plain chunk scan, the
reference's XLA route) and with rendermedia=False (no media gather), on
the Cornell fog scene at 16x16, 4,000 photons, 2 iterations.  Tolerances:
those of tests/test_torch_default_route.py."""

import pytest

from test_torch_default_route import _images_agree, render_both


@pytest.mark.parametrize("over", [dict(gather="brute"),
                                  dict(rendermedia=False)])
def test_render_options_match(over):
    _images_agree(*render_both(over))
