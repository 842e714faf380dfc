"""The whole step's share of the bf16 peak: the conv and fullc
operations of the traced steps (forward, weight gradients, input
gradients but conv1's) over the traced window's length."""
from benchmark.core import readers


def read(run):
    flops = run.reference.train_flops(run.config, run.traffic["batch"])
    return readers.mfu_pct(run, flops * run.traced_steps)
