"""The share (%) of an untraced step in which no device operation runs:
one less the traced steps' busy device seconds per step over the measured
window's seconds per step. The traced window itself is not the
denominator: the profiler slows the host's launches, so its idle share
would count the profiler's own cost."""


def read(layer):
    busy_per_step = layer.trace.busy_s / layer.trace.units
    step_s = layer.window["seconds"] / layer.window["steps"]
    return 100.0 * (1.0 - busy_per_step / step_s)
