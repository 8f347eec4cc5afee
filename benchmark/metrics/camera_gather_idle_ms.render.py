"""camera_gather_idle_ms.render:
Device-idle time inside the program's ``bre.camera.gather`` spans per
traced iteration: the spans' host time less the device's busy time
within it.  The spans are each depth step's gather block: the in-medium
count read, the ray budget's pick, ``validity_order``, the route pick
and the gather, in ``integrators/photonbeam.camera_pass_by_pixels``.

Layer: the camera walk, route dispatch, packing and gathers.
"""

from harness import program_spans

UNIT = "ms/iter"
LAYER = "camera walk, route dispatch, packing and gathers"
MOVES = "render_s_per_iter"


def read(rd):
    s = program_spans.idle_s(rd, "bre.camera.gather")
    return None if s is None else 1e3 * s / rd.n_iterations
