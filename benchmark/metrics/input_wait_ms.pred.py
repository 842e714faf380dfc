"""Mean host milliseconds a batch waited on the device prefetcher's
``next`` (the staging of pinned uint8 batches), over the window."""
from benchmark.core import readers


def read(run):
    return readers.span_ms(run, "input_wait")
