"""The NMS kernels' share of their roofline (%) in the traced training
steps: the least time of every proposal NMS call (boxes and flags read,
keep mask written; the IoU tests these boxes need, counted from each
call's valid flags and keep mask) over the device time of
``benchmark/kernels/nms-*.json``'s kernels."""
from benchmark.lib import harness


def read(layer):
    seconds = layer.trace.seconds_of(harness.kernel_names("nms"))
    if seconds <= 0 or layer.nms_least_s <= 0:
        return None
    return 100.0 * layer.nms_least_s / seconds
