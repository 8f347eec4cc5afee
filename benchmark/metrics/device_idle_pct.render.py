"""device_idle_pct.render:
100 x (1 - the union of device-operation intervals / the traced
window).

Layer: the device, as the profiler sees it.
"""

UNIT = "%"
LAYER = "device"
MOVES = "render_s_per_iter"


def read(rd):
    return 100.0 * (1.0 - rd.busy_s / rd.window_s)
