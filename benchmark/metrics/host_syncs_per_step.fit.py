"""host_syncs_per_step.fit:
Synchronizing CUDA runtime calls per traced step: stream, device or
event synchronizes and blocking copies.

Layer: the trainer, ``integrators/inverse.optimize_medium`` and
``parallel/mesh.make_inverse_train_step``.
"""

UNIT = "syncs/step"
LAYER = "trainer"
MOVES = "fit_s_per_step"


def read(rd):
    return rd.host_syncs() / rd.n_iterations
