"""backward_ms.fit:
Device time per traced step of the operations that the autograd engine's
backward functions launch: the packed gather's backward
(``_GatherCorePacked``), ``media.grid_density``'s and the walk's.

Layer: autograd backward.
"""

UNIT = "ms/step"
LAYER = "autograd backward"
MOVES = "fit_s_per_step"


def read(rd):
    s = rd.backward_s()
    return None if s is None else 1e3 * s / rd.n_iterations
