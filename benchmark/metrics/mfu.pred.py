"""The forward's share of the bf16 peak: the conv and fullc operations
of the traced batches over the traced window's length."""
from benchmark.core import readers


def read(run):
    flops = run.reference.forward_flops(run.config, run.traffic["batch"])
    return readers.mfu_pct(run, flops * run.traced_steps)
