"""The allocator's peak over the window (``max_memory_allocated`` after
a reset at the end of set-up), in GiB."""


def read(run):
    peak = getattr(run, "memory_peak", 0)
    return peak / 2 ** 30 if peak else None
