"""The correlation lookups' least time (flowbench/counts/lookup.py: every
input read once and every output written once at the HBM rate, or the
in-map support taps' operations at the peak, whichever is longer) over the
lookup kernels' device time, in %. Nothing is read where no lookup kernel
ran or where the kernels' own launch counters disagree with the trace."""
from flowbench.metrics import roofline


def read(record):
    return roofline(record, "pair", "lookup")
