"""CNN inference in a closed loop (``pred_raw`` / ``extract`` over an
image set): one caller hands a staged batch to ``NetTrainer.predict_raw``
and waits for its rows on the host before the next.  A ring of seeded
``uint8`` batches sits in pinned host memory behind an iterator; the
program's ``DevicePrefetcher`` stages them ahead.

Each batch's latency is taken on the card's clock: CUDA events recorded
when the staged batch is handed over and once its rows are back.  The
window runs until ``run.seconds`` have passed: ``pred_images_per_s`` is
the rows returned over that time, ``pred_batch_p95_ms`` the 95th
percentile of every batch's latency.  A sample of the window's batches,
drawn from the seed (a batch in ``SAMPLE_EVERY`` on average, and the
last), is kept and each of its rows judged against the plain
reference's row of its ring batch; the others are dropped as a caller
would drop them, so the program's host buffers are reused as in use.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.core import judge as judgelib, program, weights as W

WARM_BATCHES = 3
SAMPLE_EVERY = 16
#: batches the sample is drawn over (more than any window holds)
SAMPLE_SPAN = 1 << 20


class RingIterator:
    """The program's iterator protocol over a ring of host batches,
    endless: ``next`` cycles the ring; a batch's ``index`` says its slot."""

    def __init__(self, ring, n: int):
        self.ring = ring
        self.n = n
        self.j = 0

    def before_first(self):
        self.j = 0

    def next(self):
        from cxxnet_tpu_torch.io.data import DataBatch
        r = self.j % len(self.ring)
        self.j += 1
        return DataBatch(data=self.ring[r], label=np.zeros((self.n, 1),
                                                           np.float32),
                         index=np.arange(r * self.n, (r + 1) * self.n))

    def close(self):
        pass


def make_ring(run, n: int, side: int):
    """The ring of uint8 batches, drawn on the device, then held in
    pinned host memory (numpy views)."""
    import torch
    gen = torch.Generator(device=run.device)
    gen.manual_seed(W.stream_seed(run.seed, "data"))
    ring = []
    for _ in range(run.traffic["ring"]):
        b = torch.randint(0, 256, (n, 3, side, side), generator=gen,
                          device=run.device, dtype=torch.uint8)
        host = torch.empty(b.shape, dtype=torch.uint8,
                           pin_memory=run.device.type == "cuda")
        host.copy_(b)
        ring.append(host)
    return ring


def setup(run) -> None:
    from cxxnet_tpu_torch.io.device_prefetch import DevicePrefetcher
    cfg, tf, ref = run.config, run.traffic, run.reference
    n, m = tf["batch"], cfg["model"]
    dev = "gpu" if run.device.type == "cuda" else "cpu"
    text = program.conf_text(
        cfg, {"dev": dev, "batch_size": n, "seed": W.program_seed(run.seed),
              "silent": 1})
    tr, _ = program.build(text)
    run.mark("program_build")
    W.install(tr, W.make(ref.leaf_specs(cfg), run.seed, run.device,
                         tr.dtype))
    run.mark("weights")
    ring = make_ring(run, n, m["input_side"])
    run.mark("inputs")
    pf = DevicePrefetcher(RingIterator([h.numpy() for h in ring], n), tr,
                          depth=tf["prefetch_depth"], for_eval=True)
    pf.before_first()
    for _ in range(WARM_BATCHES):
        tr.predict_raw(pf.next())
    run.mark("warm_batches")
    run.info.update(trainer=tr, prefetcher=pf, ring=ring)


def window(run) -> None:
    import torch
    tr, pf = run.info["trainer"], run.info["prefetcher"]
    spans = run.spans
    n = run.traffic["batch"]
    ring = len(run.info["ring"])
    trace_steps = run.traffic["trace_steps"]
    cuda = run.device.type == "cuda"
    rng = np.random.default_rng(W.stream_seed(run.seed, "sample"))
    keep = rng.random(SAMPLE_SPAN) < 1.0 / SAMPLE_EVERY
    events, outs = [], []
    batches = rows_back = 0
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        with spans.span("input_wait"):
            sb = pf.next()
        slot = int(sb.index[0]) // n % ring
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
        with spans.span("predict_raw"):
            rows = tr.predict_raw(sb)
        if cuda:
            e1.record()
            events.append((e0, e1))
        rows_back += rows.shape[0]
        done = time.perf_counter() >= end
        if keep[batches] or done:
            outs.append((slot, rows))
        batches += 1
        if run.traced and batches == trace_steps:
            run.end_trace(batches)
        if done:
            break
    tr.sync()
    dt = time.perf_counter() - t0
    run.e2e["pred_images_per_s"] = rows_back / dt
    if cuda:
        lat = [a.elapsed_time(b) for a, b in events]
        run.e2e["pred_batch_p95_ms"] = run.arith.percentile(lat, 95)
    run.attempted = batches
    run.info["outs"] = outs


def judge(run) -> None:
    import torch
    pf = run.info.pop("prefetcher")
    pf.close()
    run.info.pop("trainer", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, ref = run.config, run.reference
    w = W.make(ref.leaf_specs(cfg), run.seed, run.device,
               getattr(torch, cfg["keys"]["dtype"]))
    refs = [ref.predict(w, h.to(run.device), cfg).cpu().numpy()
            for h in run.info["ring"]]
    worst, bad = 0.0, 0
    n = run.traffic["batch"]
    lim = run.limits["row_err"]
    for slot, rows in run.info["outs"]:
        if rows.shape != (n, refs[slot].shape[1]):
            err = float("inf")
        else:
            err = float(judgelib.row_error(rows, refs[slot]).max())
        if not err <= lim:
            bad += 1
        worst = max(worst, err)
    run.failed = bad
    run.check("row_err", worst, lim)
