"""trace_ms.render:
Time of the ``trace_photon_beams`` spans per traced iteration, each to
the end of the last device operation it launched.

Layer: the photon walk and grid tracking,
``integrators/photon_trace.trace_photon_beams`` and ``media.sample_grid``.
"""

UNIT = "ms/iter"
LAYER = "photon walk and grid tracking"
MOVES = "render_s_per_iter"


def read(rd):
    s = rd.span_s("trace_photon_beams")
    return None if s is None else 1e3 * s / rd.n_iterations
