"""camera_idle_ms.render:
Device-idle time inside the program's ``bre.camera_pass`` spans
(``photonbeam.camera_pass_by_pixels``) per traced iteration: the spans'
host time less the device's busy time within it.

Layer: the camera walk, route dispatch, packing and gathers.
"""

from harness import program_spans

UNIT = "ms/iter"
LAYER = "camera walk, route dispatch, packing and gathers"
MOVES = "render_s_per_iter"


def read(rd):
    s = program_spans.idle_s(rd, "bre.camera_pass")
    return None if s is None else 1e3 * s / rd.n_iterations
