"""track_trips_per_iter.render:
Grid-tracking trips per traced iteration: the number of the program's
``bre.track.trip`` spans, one per trip of the host loops in
``media.sample_grid`` and ``media.tr_grid``, each after one host read.

Layer: the photon walk and grid tracking.
"""

from harness import program_spans

UNIT = "trips/iter"
LAYER = "photon walk and grid tracking"
MOVES = "render_s_per_iter"


def read(rd):
    n = program_spans.count(rd, "bre.track.trip")
    return None if n is None else n / rd.n_iterations
