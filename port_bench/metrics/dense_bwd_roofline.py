"""The encoder's dense layers, forward and backward in train mode, against
their roofline (3x ``sandwich_flops``; ``sandwich_bytes`` plus
``sandwich_bwd_bytes``)."""
from port_bench.metrics._roofline import share


def read(rec):
    return share(rec, train=True)
