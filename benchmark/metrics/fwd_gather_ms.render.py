"""fwd_gather_ms.render:
Device time of the forward gather kernels (``KERNELS``) per traced
iteration.

Layer: the forward gather kernels, ``ops/gather.py`` on
``csrc/beam_gather_fwd.cu``.
"""

UNIT = "ms/iter"
LAYER = "forward gather kernels"
MOVES = "render_s_per_iter"
# the forward kernels of csrc/beam_gather_fwd.cu and csrc/split_sweep.cuh
KERNELS = ("gather_dense_kernel", "gather_sparse_kernel", "stage_beams",
           "reduce_splits")


def read(rd):
    s = rd.device_s(KERNELS)
    return None if s is None else 1e3 * s / rd.n_iterations
