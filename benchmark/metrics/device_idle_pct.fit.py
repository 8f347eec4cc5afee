"""device_idle_pct.fit:
100 x (1 - the union of device-operation intervals / the traced
window), over the traced steps of a fit.

Layer: the device, as the profiler sees it.
"""

UNIT = "%"
LAYER = "device"
MOVES = "fit_s_per_step"


def read(rd):
    return 100.0 * (1.0 - rd.busy_s / rd.window_s)
