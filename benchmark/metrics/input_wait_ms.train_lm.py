"""Mean host milliseconds a step waited on the device prefetcher's
``next`` (the text + packseq chain and its staging), over the window."""
from benchmark.core import readers


def read(run):
    return readers.span_ms(run, "input_wait")
