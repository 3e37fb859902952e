"""The upsample + CE forward kernels' share of their roofline (%): the
least time of every forward call of the traced steps over the device time
of the kernels ``benchmark/kernels/resize_ce_fwd-*.json`` names."""
from benchmark.lib import rooflines


def read(layer):
    return rooflines.share(layer, "resize_ce", "resize_ce_fwd", "fwd")
