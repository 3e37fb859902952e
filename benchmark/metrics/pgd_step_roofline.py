"""The PGD-update kernels' share of their roofline (%): the least time of
every sign step of the traced steps' ascents (x and g read, the result
written) over the device time of ``benchmark/kernels/pgd_step-*.json``'s
kernels."""
from benchmark.lib import rooflines


def read(layer):
    return rooflines.share(layer, "pgd_step", "pgd_step")
