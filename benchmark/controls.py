"""The controls and planted faults of a cell's correctness check, read at
the cell's own size on the inputs a run of each seed makes:

* the control: the plain reference in the program's place, computed in
  the precision below the configuration's (bf16 -> fp8 e4m3: every
  matmul and conv operand rounded through float8 with a per-tensor
  scale, float32 accumulation); it has to fail one of the cell's numbers;
* training cells: half of each batch left out, the mean taken over the
  rest (the reference on the first half in the program's place); a
  state left unchanged reads 1 on ``change_gap`` by definition;
* prediction cells: half of each batch left out (its rows copied from
  the other half) and one answer altered where it is produced (a row's
  classes rolled by one).

    python3 benchmark/controls.py --workload <name> --seeds 1,2,3 \
        --seconds 20

Prints one JSON line a seed with each reading by the cell's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def fp8(t):
    """``t`` rounded through float8 e4m3 with a per-tensor scale (its
    largest magnitude to 448); the gradient passes straight through."""
    import torch
    d = t.detach()
    s = d.abs().amax().clamp(min=1e-30) / 448.0
    r = (d / s).to(torch.float8_e4m3fn).to(d.dtype) * s
    return t + (r - d)


def train_readings(run, ref_out: dict, other: dict) -> dict:
    """The cell's training numbers of ``other`` against the fp32
    reference's."""
    from benchmark.core import judge
    keys = judge.moved_leaves(ref_out["grad_norms"])
    return {"loss_gap": judge.loss_gap(other["losses"], ref_out["losses"]),
            "loss1_gap": judge.loss1_gap(other["losses"], ref_out["losses"]),
            "grad_gap": judge.leaf_gap(other["grad_norms"],
                                       ref_out["grad_norms"], keys)[0],
            "change_gap": judge.leaf_gap(other["change"], ref_out["change"],
                                         keys)[0]}


def lm_cell(run) -> dict:
    import math

    import torch
    from benchmark.core import corpus, weights as W
    cfg, tf, ref = run.config, run.traffic, run.reference
    drv = run.bench.driver(tf["driver"])
    rows, seq = tf["rows"], cfg["model"]["n_positions"]
    steps_max = drv.CHECK_STEPS + math.ceil(run.seconds / tf["min_step_s"])
    docs = corpus.documents(tf, run.seed, steps_max * rows * seq + 1,
                            cfg["model"]["vocab_size"])
    w = W.make(ref.leaf_specs(cfg), run.seed, run.device, torch.bfloat16)
    batches = ref.pack(docs, rows, seq, drv.CHECK_STEPS)
    opt = drv._adam(cfg)
    blk = tf["reference_rows"]
    r = ref.train(w, batches, cfg, opt, block=blk)
    c = ref.train(w, batches, cfg, opt, quant=fp8, block=blk)
    h = ref.train(w, batches, cfg, opt, rows=range(rows // 2), block=blk)
    return {"control": train_readings(run, r, c),
            "half_batch": train_readings(run, r, h),
            "state_unchanged": {"change_gap": 1.0}}


def cnn_train_cell(run) -> dict:
    import torch
    from benchmark.core import weights as W
    cfg, tf, ref = run.config, run.traffic, run.reference
    drv = run.bench.driver(tf["driver"])
    m = cfg["model"]
    data, labels = drv.make_ring(run, tf["batch"], m["input_side"],
                                 m["num_class"])
    w = W.make(ref.leaf_specs(cfg), run.seed, run.device, torch.bfloat16)
    batches = [{"data": data[k], "label": labels[k][:, 0]}
               for k in range(drv.CHECK_STEPS)]
    seed = W.program_seed(run.seed)
    r = ref.train(w, batches, cfg, seed)
    c = ref.train(w, batches, cfg, seed, quant=fp8)
    h = ref.train(w, batches, cfg, seed, rows=range(tf["batch"] // 2))
    return {"control": train_readings(run, r, c),
            "half_batch": train_readings(run, r, h),
            "state_unchanged": {"change_gap": 1.0}}


def cnn_pred_cell(run) -> dict:
    import numpy as np
    import torch
    from benchmark.core import judge, weights as W
    cfg, tf, ref = run.config, run.traffic, run.reference
    drv = run.bench.driver(tf["driver"])
    ring = drv.make_ring(run, tf["batch"], cfg["model"]["input_side"])
    w = W.make(ref.leaf_specs(cfg), run.seed, run.device, torch.bfloat16)
    out = {"control": 0.0, "half_batch": 0.0, "answer_altered": 0.0}
    n = tf["batch"]
    for host in ring:
        x = host.to(run.device)
        r = ref.predict(w, x, cfg).cpu().numpy()
        c = ref.predict(w, x, cfg, quant=fp8).cpu().numpy()
        half = r.copy()
        half[n // 2:] = r[:n - n // 2]
        alt = r.copy()
        alt[n // 3] = np.roll(alt[n // 3], 1)
        for k, v in (("control", c), ("half_batch", half),
                     ("answer_altered", alt)):
            out[k] = max(out[k], float(judge.row_error(v, r).max()))
    return {k: {"row_err": v} for k, v in out.items()}


CELLS = {"train_lm": lm_cell, "train_cnn": cnn_train_cell,
         "pred_cnn": cnn_pred_cell}


def readings(bench, workload: str, seed: int, seconds: float, device
             ) -> dict:
    import torch
    from benchmark.core.harness import Run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(bench, workload, seed, seconds, False, device,
              time.perf_counter())
    return CELLS[run.traffic["driver"]](run)


def main(argv=None) -> int:
    import torch
    from benchmark.core.spec import Benchmark
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    bench = Benchmark(ROOT)
    for s in (int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(bench, a.workload, s, a.seconds, dev)
        print(json.dumps({"workload": a.workload, "seed": s,
                          "seconds": round(time.perf_counter() - t0, 1),
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
