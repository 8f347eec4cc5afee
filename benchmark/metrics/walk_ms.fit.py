"""walk_ms.fit:
Time of the program's ``bre.walk`` spans per traced step, each to the end
of the last device operation it launched: the fit's photon walk
(``photon_trace.trace_photon_beams_by_index``) with its grid tracking.

Layer: the photon walk and grid tracking.
"""

UNIT = "ms/step"
LAYER = "photon walk and grid tracking"
MOVES = "fit_s_per_step"


def read(rd):
    s = rd.span_s("bre.walk")
    return None if s is None else 1e3 * s / rd.n_iterations
