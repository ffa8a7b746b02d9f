"""The batched forward's model FLOPs a pair (flowbench/counts/flops.py,
lookups by their support taps) at the window's pace over the card's peak
for the cell's precision, in %."""
from flowbench.metrics import mfu


def read(record):
    return mfu(record, "pair")
