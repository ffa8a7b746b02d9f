"""Device ms a train step in the "other" category: elementwise work,
copies and reductions (losses, autograd's elementwise backward, the
optimizer)."""
from flowbench.metrics import device_ms
from flowbench.trace import OTHER


def read(record):
    return device_ms(record, "step", (OTHER,))
