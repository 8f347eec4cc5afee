"""walk_idle_ms.render:
Device-idle time inside the program's ``bre.walk`` spans
(``photon_trace.trace_photon_beams_by_index``) per traced iteration: the
spans' host time less the device's busy time within it.

Layer: the photon walk and grid tracking.
"""

from harness import program_spans

UNIT = "ms/iter"
LAYER = "photon walk and grid tracking"
MOVES = "render_s_per_iter"


def read(rd):
    s = program_spans.idle_s(rd, "bre.walk")
    return None if s is None else 1e3 * s / rd.n_iterations
