"""The train step's model FLOPs (forward, backward as twice the forward of
every part with a gradient, the teacher's forward; lookups by their support
taps) at the window's pace over the card's peak, in %."""
from flowbench.metrics import mfu


def read(record):
    return mfu(record, "step")
