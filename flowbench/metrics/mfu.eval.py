"""The evaluation's model FLOPs a pair (student and teacher iterations,
lookups by their support taps) at the window's pace over the card's peak
for the cell's precision, in %."""
from flowbench.metrics import mfu


def read(record):
    return mfu(record, "pair")
