"""camera_pass_ms.render:
Time of the ``camera_pass`` spans per traced iteration, each to the end
of the last device operation it launched.

Layer: the camera walk, route dispatch, packing and gathers,
``integrators/photonbeam.camera_pass``.
"""

UNIT = "ms/iter"
LAYER = "camera walk, route dispatch, packing and gathers"
MOVES = "render_s_per_iter"


def read(rd):
    s = rd.span_s("camera_pass")
    return None if s is None else 1e3 * s / rd.n_iterations
