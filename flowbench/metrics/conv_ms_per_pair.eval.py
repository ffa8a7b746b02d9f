"""Device ms a pair in conv kernels: the port's K2 / K5 and cuDNN's."""
from flowbench.metrics import device_ms

CONVS = ("K2 conv3x3_stats / K5 conv3x3", "cuDNN conv")


def read(record):
    return device_ms(record, "pair", CONVS)
