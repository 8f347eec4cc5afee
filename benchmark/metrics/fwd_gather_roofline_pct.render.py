"""fwd_gather_roofline_pct.render:
The forward sweeps' least time over the device time of the forward
kernels (``KERNELS``), in percent.  The least time is
``harness/roofline.py``'s: in-range pairs counted from the gather's
inputs, operations at 67 TFLOP/s against bytes at 3.35 TB/s.

Layer: the forward gather kernels, ``ops/gather.py`` on
``csrc/beam_gather_fwd.cu``.
"""

from harness.roofline import forward_work

UNIT = "%"
LAYER = "forward gather kernels"
MOVES = "render_s_per_iter"
# the forward kernels of csrc/beam_gather_fwd.cu and csrc/split_sweep.cuh
KERNELS = ("gather_dense_kernel", "gather_sparse_kernel", "stage_beams",
           "reduce_splits")


def read(rd):
    s = rd.device_s(KERNELS)
    if s is None or not rd.captures:
        return None
    least, _ = forward_work(rd)
    return 100.0 * least / s if least > 0 else None
