"""bwd_gather_ms.fit:
Device time per traced step of the backward gather kernels (``KERNELS``)
that the autograd engine's backward functions launch.

Layer: the backward gather kernels, ``ops/gather_bwd.py`` on
``csrc/beam_gather_bwd.cu``.
"""

UNIT = "ms/step"
LAYER = "backward gather kernels"
MOVES = "fit_s_per_step"
# csrc/beam_gather_bwd.cu's kernels and the staging and split reduction
# of csrc/split_sweep.cuh that they share with the forward
KERNELS = ("bwd_rays_", "bwd_beams_", "stage_beams", "reduce_splits",
           "stage_power_chunks", "flagged_extent")


def read(rd):
    s = rd.backward_s(KERNELS)
    return None if s is None else 1e3 * s / rd.n_iterations
