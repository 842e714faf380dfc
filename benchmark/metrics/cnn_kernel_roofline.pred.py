"""The hand-written CNN kernels' share of their roofline in inference:
the least time of the LRN and max-pool forward launches (bytes or
operations, whichever bounds each, from the configuration's shapes)
over those kernels' summed device time in the traced window."""
from benchmark.core import readers

PER_STEP = {"lrn_fwd|lrn_hwcn_fwd": 2, "max_pool_fwd": 3}


def read(run):
    if not readers.launches_hold(run, PER_STEP):
        return None
    wrappers = [w for k in PER_STEP for w in k.split("|")]
    return readers.roofline_pct(run, wrappers,
                                readers.cnn_kernel_bound_s(run, False))
