"""Device milliseconds a step of the work launched inside the trainer's
``train_update`` range (the updater on every parameter), from the
trace."""
from benchmark.core import readers, trace


def read(run):
    if not run.trace_ok or run.traced_steps <= 0:
        return None
    us = trace.in_ranges_us(run.events, "train_update")
    if us <= 0:
        readers.note(run, "no device work inside train_update")
        return None
    return us / 1e3 / run.traced_steps
