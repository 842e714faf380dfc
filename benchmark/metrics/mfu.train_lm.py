"""The whole step's share of the bf16 peak: the model's operations of
the traced steps (6 a matmul weight a position, attention over the live
pairs, no recompute) over the traced window's length."""
from benchmark.core import readers


def read(run):
    return readers.mfu_pct(run, readers.lm_step_flops(run))
