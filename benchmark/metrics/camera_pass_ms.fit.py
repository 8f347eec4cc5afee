"""camera_pass_ms.fit:
Time of the program's ``bre.camera_pass`` spans per traced step, each to
the end of the last device operation it launched: the fit's forward
camera pass (``photonbeam.camera_pass_by_pixels``), without its backward.

Layer: the camera walk, route dispatch, packing and gathers.
"""

UNIT = "ms/step"
LAYER = "camera walk, route dispatch, packing and gathers"
MOVES = "fit_s_per_step"


def read(rd):
    s = rd.span_s("bre.camera_pass")
    return None if s is None else 1e3 * s / rd.n_iterations
