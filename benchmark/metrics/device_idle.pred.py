"""Share of the traced window with nothing running on the card."""
from benchmark.core import readers


def read(run):
    return readers.idle_pct(run)
