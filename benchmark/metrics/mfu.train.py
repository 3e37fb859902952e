"""The training step's share of the card's peak (%): the model FLOPs of a
step (counted once by the reference on the meta device), times the steps
of the measured window, over the window's seconds and the configuration's
precision's peak."""
from benchmark.lib import bounds


def read(layer):
    peak = bounds.PEAK_FLOPS[layer.precision]
    w = layer.window
    return 100.0 * layer.flops_per_step * w["steps"] / w["seconds"] / peak
