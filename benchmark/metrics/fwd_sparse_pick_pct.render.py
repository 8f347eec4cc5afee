"""fwd_sparse_pick_pct.render:
100 x the forward gather sweeps that took the sparse live-block kernel
over all sweeps of the traced iterations: the program's counters
``gather.sparse_picks`` and ``gather.sweeps``
(``accel/beam_gather._packed_forward``), read after the profiler stops.
The counters are the process's since it started, which holds one
profiled window in a render run.

Layer: the forward gather kernels.
"""

from harness import program_spans

UNIT = "%"
LAYER = "forward gather kernels"
MOVES = "render_s_per_iter"


def read(rd):
    sweeps = program_spans.counter("gather.sweeps")
    picks = program_spans.counter("gather.sparse_picks")
    if not sweeps or picks is None:
        return None
    return 100.0 * picks / sweeps
