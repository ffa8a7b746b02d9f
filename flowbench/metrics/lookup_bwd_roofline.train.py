"""The student lookups' backward least time (both factors' cotangents:
flowbench/counts/lookup.py) over K8 and K9's device time, in %."""
from flowbench.metrics import roofline


def read(record):
    return roofline(record, "step", "lookup_bwd")
