"""The encoder's dense layers in the eval forward, against their
roofline (frozen ``sandwich_flops`` and ``sandwich_bytes``)."""
from port_bench.metrics._roofline import share


def read(rec):
    return share(rec, train=False)
