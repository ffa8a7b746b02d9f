"""Kernel launches (copies not counted) a train step: the host's dispatch work."""
from flowbench.metrics import launches


def read(record):
    return launches(record, "step")
