"""bwd_gather_roofline_pct.fit:
The backward sweeps' least time over the device time of the backward
gather kernels (``KERNELS``), in percent.  The least time is
``harness/roofline.py``'s: in-range pairs counted from the gather's
inputs, with the backward's operations per pair, at 67 TFLOP/s against
bytes at 3.35 TB/s.

Layer: the backward gather kernels, ``ops/gather_bwd.py`` on
``csrc/beam_gather_bwd.cu``.
"""

from harness.roofline import forward_work

UNIT = "%"
LAYER = "backward gather kernels"
MOVES = "fit_s_per_step"
# csrc/beam_gather_bwd.cu's kernels and the staging and split reduction
# of csrc/split_sweep.cuh that they share with the forward
KERNELS = ("bwd_rays_", "bwd_beams_", "stage_beams", "reduce_splits",
           "stage_power_chunks", "flagged_extent")


def read(rd):
    s = rd.backward_s(KERNELS)
    if s is None or not rd.captures:
        return None
    least, _ = forward_work(rd, backward=True)
    return 100.0 * least / s if least > 0 else None
