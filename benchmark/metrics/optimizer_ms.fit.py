"""optimizer_ms.fit:
Time of the program's ``bre.optimizer`` spans per traced step, each to
the end of the last device operation it launched: ``optimize_medium``'s
TV prior, gradient hand-off, Adam step and clamp.

Layer: the trainer.
"""

UNIT = "ms/step"
LAYER = "trainer"
MOVES = "fit_s_per_step"


def read(rd):
    s = rd.span_s("bre.optimizer")
    return None if s is None else 1e3 * s / rd.n_iterations
