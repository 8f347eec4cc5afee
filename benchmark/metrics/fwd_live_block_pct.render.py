"""fwd_live_block_pct.render:
100 x the live (chunk x tile) blocks that the forward gather's cull left
over all its blocks, summed over the traced iterations' sweeps: the
program's counters ``gather.live_blocks`` and ``gather.blocks``
(``accel/beam_gather._packed_forward``), read after the profiler stops.
The counters are the process's since it started, which holds one
profiled window in a render run: a second window in the same process
would add to them.

Layer: the forward gather kernels.
"""

from harness import program_spans

UNIT = "%"
LAYER = "forward gather kernels"
MOVES = "render_s_per_iter"


def read(rd):
    blocks = program_spans.counter("gather.blocks")
    live = program_spans.counter("gather.live_blocks")
    if not blocks or live is None:
        return None
    return 100.0 * live / blocks
