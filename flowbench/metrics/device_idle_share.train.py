"""Share of the window in which no operation ran on the card, in %."""
from flowbench.metrics import idle_share


def read(record):
    return idle_share(record, "step")
