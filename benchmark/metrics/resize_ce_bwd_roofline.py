"""The upsample + CE backward kernel's share of its roofline (%), as the
forward's, over ``benchmark/kernels/resize_ce_bwd-*.json``."""
from benchmark.lib import rooflines


def read(layer):
    return rooflines.share(layer, "resize_ce", "resize_ce_bwd", "bwd")
