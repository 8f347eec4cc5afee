"""pack_ms.render:
Time of the program's ``bre.pack`` spans per traced iteration, each to
the end of the last device operation it launched: the packed route's
``medium_interval_poly`` (grid media) and ``pack_beams_compact``.

Layer: the camera walk, route dispatch, packing and gathers.
"""

UNIT = "ms/iter"
LAYER = "camera walk, route dispatch, packing and gathers"
MOVES = "render_s_per_iter"


def read(rd):
    s = rd.span_s("bre.pack")
    return None if s is None else 1e3 * s / rd.n_iterations
