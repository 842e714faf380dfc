"""The segmented flash attention kernels' share of their roofline: the
least time of the forward and backward launches (live pairs' operations
at the bf16 peak, or their bytes at HBM bandwidth, whichever bounds
each) over those kernels' summed device time in the traced window."""
from benchmark.core import readers

WRAPPERS = ("flash_attention_seg_fwd", "flash_attention_seg_bwd")


def read(run):
    layers = readers.lm_dims(run)["L"]
    if not readers.launches_hold(run, {w: layers for w in WRAPPERS}):
        return None
    return readers.roofline_pct(run, WRAPPERS,
                                readers.lm_attention_bound_s(run))
