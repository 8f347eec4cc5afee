"""host_syncs_per_iter.render:
Synchronizing CUDA runtime calls per traced iteration: stream, device
or event synchronizes and blocking copies.

Layer: the progressive loop, ``integrators/photonbeam.render_photonbeam``.
"""

UNIT = "syncs/iter"
LAYER = "progressive loop"
MOVES = "render_s_per_iter"


def read(rd):
    return rd.host_syncs() / rd.n_iterations
