"""CNN training on batches held on the card: a ring of seeded ``uint8``
pixel batches and uniform class labels, made on the device in set-up
(the program's ``synth_device_data`` pattern, in raw pixels that its
step normalises), handed to ``NetTrainer.update`` as staged batches.

Set-up builds the trainer, installs the benchmark's weights and drives
the first ``CHECK_STEPS`` steps on the ring's first batches (rows that
all differ).  The window cycles the ring until ``run.seconds`` have
passed, then waits for the card: ``train_images_per_s`` is the rows of
all its steps over that time.  In a traced run the trace covers the
mix's first ``trace_steps`` steps.  The judge frees the program and
trains the plain reference on the same batches from the same weights,
with the dropout masks the configuration's seed draws.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.core import judge as judgelib, program, weights as W

CHECK_STEPS = 3


def make_ring(run, n: int, side: int, classes: int):
    """``(data, labels)``: ``ring`` batches of uint8 pixels (ring, n, 3,
    side, side) and float32 labels (ring, n, 1) on the run's device."""
    import torch
    gen = torch.Generator(device=run.device)
    gen.manual_seed(W.stream_seed(run.seed, "data"))
    ring = run.traffic["ring"]
    data = torch.randint(0, 256, (ring, n, 3, side, side), generator=gen,
                         device=run.device, dtype=torch.uint8)
    labels = torch.randint(0, classes, (ring, n, 1), generator=gen,
                           device=run.device).float()
    return data, labels


def setup(run) -> None:
    from cxxnet_tpu_torch.io.device_prefetch import StagedBatch
    cfg, tf, ref = run.config, run.traffic, run.reference
    n, m = tf["batch"], cfg["model"]
    dev = "gpu" if run.device.type == "cuda" else "cpu"
    text = program.conf_text(
        cfg, {"dev": dev, "batch_size": n, "seed": W.program_seed(run.seed),
              "silent": 1, "eval_train": 0, "save_model": 0})
    tr, _ = program.build(text)
    run.mark("program_build")
    specs = ref.leaf_specs(cfg)
    W.install(tr, W.make(specs, run.seed, run.device, tr.dtype))
    run.mark("weights")
    data, labels = make_ring(run, n, m["input_side"], m["num_class"])
    lab_host = labels.cpu().numpy().reshape(labels.shape[0], n, 1)
    staged = [StagedBatch(data=data[j], label=labels[j],
                          label_host=lab_host[j],
                          index=np.arange(j * n, (j + 1) * n))
              for j in range(data.shape[0])]
    run.mark("inputs")
    run.info.update(trainer=tr, staged=staged, data=data, labels=labels)
    losses = []
    for k in range(CHECK_STEPS):
        tr.update(staged[k])
        losses.append(float(tr.last_loss))
        if k == 0:
            grads = _sgd_grads(tr, cfg, specs, run)
    run.mark("check_steps")
    w0 = W.make(specs, run.seed, run.device, tr.dtype)
    change = judgelib.leaf_norms(
        tr, lambda pk, t, p: judgelib.master(tr, pk, t, p)
        - w0[f"{pk.split('-', 1)[1]}/{t}"].float(), ref.part_norms)
    del w0
    run.mark("norms")
    run.info["prog"] = {"losses": losses, "grad_norms": grads,
                        "change": change}


def _sgd_grads(tr, cfg, specs, run) -> dict:
    """The first gradient each leaf's optimizer got, from its state after
    one step: ``m = -lr (g + wd w0)``."""
    h = run.reference.sgd_hypers(cfg)
    w0 = W.make(specs, run.seed, run.device, tr.dtype)

    def grad(pk, tag, p):
        hp = h[tag]
        name = f"{pk.split('-', 1)[1]}/{tag}"
        return -tr.opt_state[pk][tag]["m"] / hp["lr"] \
            - hp["wd"] * w0[name].float()
    out = judgelib.leaf_norms(tr, grad, run.reference.part_norms)
    del w0
    return out


def window(run) -> None:
    import torch
    tr, staged = run.info["trainer"], run.info["staged"]
    spans = run.spans
    ring = len(staged)
    trace_steps = run.traffic["trace_steps"]
    losses = []
    steps = 0
    t0 = time.perf_counter()
    end = t0 + run.seconds
    while True:
        with spans.span("update"):
            tr.update(staged[(CHECK_STEPS + steps) % ring])
        losses.append(tr.last_loss)
        steps += 1
        if run.traced and steps == trace_steps:
            run.end_trace(steps)
        if time.perf_counter() >= end:
            break
    tr.sync()
    dt = time.perf_counter() - t0
    run.e2e["train_images_per_s"] = steps * run.traffic["batch"] / dt
    run.attempted = steps
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum())


def judge(run) -> None:
    import torch
    for k in ("trainer", "staged"):
        run.info.pop(k, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, ref = run.config, run.reference
    w = W.make(ref.leaf_specs(cfg), run.seed, run.device,
               getattr(torch, cfg["keys"]["dtype"]))
    data, labels = run.info.pop("data"), run.info.pop("labels")
    batches = [{"data": data[k], "label": labels[k][:, 0]}
               for k in range(CHECK_STEPS)]
    r = ref.train(w, batches, cfg, W.program_seed(run.seed))
    judgelib.training_checks(run, run.info["prog"], r)
