"""Device ms a pair in matmul kernels: GMA's attention map and its
aggregations (no other matmul runs in an inference forward)."""
from flowbench.metrics import device_ms


def read(record):
    return device_ms(record, "pair", ("matmul",), silent_at_zero=True)
